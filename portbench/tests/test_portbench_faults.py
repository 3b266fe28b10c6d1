"""The check's control and faults: a run of the harness on the CPU at a tiny
size (the look for a card skipped), with the timed path broken underneath
(:mod:`portbench.faults`), must come out not correct; the sound run must
come out correct.  Each cell is held to its own limits.  The control is
the program's own TF32 path (``precision="high"``).  The masked cell also
meets the faults of a training mask."""

import pytest

from portbench import faults, harness
from portbench.tests.cells import tiny_cell

CELLS = ["flagship_fit", "headline_restarts16", "flagship_soft", "flagship_masked"]
SEED = 2**31 + 101


def _run(workload, **kw):
    return harness.run(tiny_cell(workload), SEED, 0.05, False, device="cpu", **kw)["result"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = _run(workload, precision="high")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    with faults.planted(fault):
        assert not _run(workload)["correct"]


@pytest.mark.parametrize("fault", ["half_lanes", "wrong_lane"])
def test_restart_fault_is_not_correct(fault):
    with faults.planted(fault):
        assert not _run("headline_restarts16")["correct"]


@pytest.mark.parametrize("fault", sorted(faults.MASK_FAULTS))
def test_mask_fault_is_not_correct(fault):
    with faults.planted(fault):
        out = _run("flagship_masked")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["half_lanes", "mask_dropped_h", "mask_dropped_w"])
def test_planted_fault_is_taken_out_again(fault):
    from nbmf_mm_tpu_torch.parallel import restarts
    from nbmf_mm_tpu_torch.solver import driver

    owner, attr = ((restarts, "vmapped_solve") if fault == "half_lanes"
                   else (driver, "_solve_core_fused"))
    before = getattr(owner, attr)
    with faults.planted(fault):
        assert getattr(owner, attr) is not before
    assert getattr(owner, attr) is before
    assert set(faults.applicable(1)) == set(faults.FAULTS)
    assert set(faults.applicable(16)) == set(faults.FAULTS) | set(faults.RESTART_FAULTS)
    assert set(faults.applicable(1, masked=True)) == set(faults.FAULTS) | set(faults.MASK_FAULTS)
