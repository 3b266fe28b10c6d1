"""Tiny cells for CPU runs of the harness."""

from portbench import manifest


def tiny_cell(workload: str) -> manifest.Cell:
    """The cell ``workload`` with its traffic, limits and metrics, on a tiny
    configuration of the same recipe that a CPU run holds."""
    cell = manifest.load_cell(workload)
    tiny = dict(cell.config, m=96, n=64, k=4)
    if tiny["data"]["kind"] == "ground_truth":
        tiny["data"] = dict(tiny["data"], k_true=3)
    cell.config = tiny
    return cell

