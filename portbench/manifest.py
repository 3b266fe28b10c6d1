"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``limits/<workload>.json``) and the per-layer metrics that read it
(``metrics/<metric>.py``).  A later cell, configuration, mix or metric is a
new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    """One workload: a configuration under a traffic mix, with the limits of
    its correctness check and the metrics it reports."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def lanes(self) -> int:
        return int(self.traffic["n_init"])

    @property
    def entries(self) -> int:
        return int(self.config["m"]) * int(self.config["n"])


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(path: Path = MANIFEST) -> dict:
    return _json(path)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, path: Path = MANIFEST) -> Cell:
    """The cell named ``workload`` in the manifest at ``path``; an unknown
    name raises ``KeyError``."""
    bench = manifest(path)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload named {workload!r} in {path}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        config=_json(ROOT / conf["file"]),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{workload}.json")["limits"],
        chips=int(entry["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    name = "portbench_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
