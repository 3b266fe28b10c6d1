"""Faults planted under the timed path, for the check's tests on the CPU and
for ``portbench.calibrate``'s readings on the card at a cell's own size.

Each fault is a list of ``(owner, attribute, replacement)``: the program's
function that the solver looks up at call time, and what stands in for it.
Faults a cell can have: a step that returns its state unchanged; half of
the rows left out of the H pass's sums, the rest scaled up to stand for
them; an answer altered where it is produced; with restarts, half of the
lanes left out, and the worst lane returned; with a training mask, the
second word plane withheld from the H pass (which then reads parity's
``1 - Ym``) or from the W pass (which then takes unobserved entries for
zeros).  Every cell takes one chip, so no exchange between chips can be left
out.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial

import torch


def unchanged_w_step():
    from nbmf_mm_tpu_torch.ops import cuda_sweep, dense_sweep

    def identity(W, H_new, *args, n_real, **kw):  # W T / n_real, renormalised, is W
        return torch.full_like(W, float(n_real))

    return [(cuda_sweep, "w_terms_packed", identity), (dense_sweep, "w_terms", identity)]


def half_rows():
    from nbmf_mm_tpu_torch.ops import cuda_sweep, dense_sweep

    def halve(h_pass):
        def h_half(W, H, *args, **kw):  # W is (..., k, rows)
            keep = torch.arange(W.shape[-1], device=W.device) < W.shape[-1] // 2
            Num, Den, ll = h_pass(torch.where(keep, W, 0.0), H, *args, **kw)
            return 2 * Num, 2 * Den, ll
        return h_half

    return [(cuda_sweep, "hloss_terms_packed", halve(cuda_sweep.hloss_terms_packed)),
            (dense_sweep, "hloss_terms", halve(dense_sweep.hloss_terms))]


def altered_answer():
    from nbmf_mm_tpu_torch.solver import driver

    safeguard = driver._final_simplex_safeguard

    def altered(W, H, orientation):
        W, H = safeguard(W, H, orientation)
        H = H.clone()
        H[0, 0] = 1.0 - H[0, 0]
        return W, H

    return [(driver, "_final_simplex_safeguard", altered)]


def half_lanes():
    from nbmf_mm_tpu_torch.parallel import restarts

    vmapped = restarts.vmapped_solve

    def half(core, data, inits, hypers, keep_all=False):
        W0, H0 = inits
        half_inits = (W0[: W0.shape[0] // 2], H0[: H0.shape[0] // 2])
        best, i, final, _ = vmapped(core, data, half_inits, hypers, keep_all)
        return best, i, torch.cat([final, final]), None

    return [(restarts, "vmapped_solve", half)]


def wrong_lane():
    from nbmf_mm_tpu_torch.parallel import restarts

    def worst(core, data, inits, hypers, keep_all=False):
        results = core(*data, *inits, *hypers)
        i = int(torch.argmax(results[4]))
        return tuple(x[i] for x in results), i, results[4], None

    return [(restarts, "vmapped_solve", worst)]


def _mask_dropped(plane: int):
    """The fused loop handed ``None`` for its operand ``plane`` (1: the H
    pass's second plane, 2: the W pass's)."""
    from nbmf_mm_tpu_torch.solver import driver

    core = driver._solve_core_fused

    def dropped(*args, **kw):
        args = list(args)
        args[plane] = None
        return core(*args, **kw)

    return [(driver, "_solve_core_fused", dropped)]


FAULTS = {"unchanged_w_step": unchanged_w_step, "half_rows": half_rows,
          "altered_answer": altered_answer}
RESTART_FAULTS = {"half_lanes": half_lanes, "wrong_lane": wrong_lane}
MASK_FAULTS = {"mask_dropped_h": partial(_mask_dropped, 1),
               "mask_dropped_w": partial(_mask_dropped, 2)}


def applicable(lanes: int, masked: bool = False) -> dict:
    """The faults a cell with ``lanes`` restart lanes, and a training mask
    where ``masked``, can have, by name."""
    return {**FAULTS, **(RESTART_FAULTS if lanes > 1 else {}),
            **(MASK_FAULTS if masked else {})}


@contextmanager
def planted(name: str):
    """The fault ``name`` in place for the ``with`` block."""
    patches = {**FAULTS, **RESTART_FAULTS, **MASK_FAULTS}[name]()
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    try:
        for owner, attr, new in patches:
            setattr(owner, attr, new)
        yield
    finally:
        for owner, attr, old in reversed(saved):
            setattr(owner, attr, old)
