"""The comparison that decides ``correct``: what the timed path returned for
one fit against the plain reference's fit from the same data and inits.

Numbers compared, each against the cell's limit of the same name:

- ``fit_gap``: the wider of two relative gaps, (1) the fitted model's,
  ``||W H - W_ref H_ref|| / ||W_ref H_ref||`` over every entry (Frobenius
  norms), and (2) the losses', the widest ``|loss - loss_ref| / |loss_ref|``
  over every sweep of the returned lane and, with restarts, over every
  lane's final loss as the program reports it;
- ``h_gap``: ``||H - H_ref|| / ||H_ref||`` (Frobenius norms).

The losses are in ``fit_gap`` and not compared alone: on their own they have
no upper reading.  At 10^8-10^9 entries the program's TF32 path, the
control, moves them no more than float32 rounding does, since the loss sums
the rounding of 10^8-10^9 entries away.  ``PERF.md`` gives the readings.

With restarts the model and ``H`` are held against the reference's lane
that the selection should return: the lane of the lowest reference loss,
or the program's lane where its reference loss lies within ``fit_gap``'s
limit of that lowest (a tie, which rounding may break either way).  A lane
chosen wrongly therefore fails both numbers.
"""

from __future__ import annotations

import numpy as np
import torch

MODEL_ROWS = 4096  # rows of W H formed at a time


def _fro(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double().to(a.device)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def model_gap(W: torch.Tensor, H: torch.Tensor, W_ref: torch.Tensor, H_ref: torch.Tensor):
    """``||W H - W_ref H_ref||_F / ||W_ref H_ref||_F``, in float64, a block
    of rows at a time."""
    W, H = W.double(), H.double()
    W_ref, H_ref = W_ref.double().to(W.device), H_ref.double().to(W.device)
    diff = ref = 0.0
    for a in range(0, W.shape[0], MODEL_ROWS):
        P, R = W[a:a + MODEL_ROWS] @ H, W_ref[a:a + MODEL_ROWS] @ H_ref
        diff += float(((P - R) ** 2).sum())
        ref += float((R ** 2).sum())
    return (diff / ref) ** 0.5


def reference_lane(program_best: int, ref_final: np.ndarray, tie: float) -> int:
    """The lane whose fit the program should have returned."""
    low = int(np.argmin(ref_final))
    if abs(ref_final[program_best] - ref_final[low]) <= tie * abs(ref_final[low]):
        return program_best
    return low


def gaps(fit: dict, ref, limits: dict) -> dict:
    """The numbers compared, by name.  ``fit`` holds what the program
    returned (``W (m, k)``, ``H (k, n)``, ``losses``, ``best`` and, with
    restarts, ``all_final``); ``ref`` is the reference's ``(W, H, losses)``
    with a leading lane axis."""
    W_ref, H_ref, L_ref = ref
    ref_final = L_ref[:, -1].cpu().numpy()
    lane, loss_gaps = 0, []
    if L_ref.shape[0] > 1:
        lane = reference_lane(int(fit["best"]), ref_final, limits["fit_gap"])
        prog_final = np.asarray(fit["all_final"], dtype=np.float64)
        loss_gaps.append(float(np.max(np.abs(prog_final - ref_final) / np.abs(ref_final))))
    losses = fit["losses"].double().to(L_ref.device)
    if losses.shape[0] != L_ref.shape[1]:
        loss_gaps.append(float("inf"))  # a fit that stopped early or ran on
    else:
        loss_gaps.append(float(((losses - L_ref[lane]).abs() / L_ref[lane].abs()).max()))
    model = model_gap(fit["W"], fit["H"], W_ref[lane], H_ref[lane])
    return {"fit_gap": float(np.max([model, *loss_gaps])),  # a NaN stays NaN
            "h_gap": _fro(fit["H"], H_ref[lane])}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number at or under its limit (NaN fails),
    and ``{name: {"value": number, "limit": limit}}`` for the result line."""
    checks = {name: {"value": value, "limit": limits[name]} for name, value in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
