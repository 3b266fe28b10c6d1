"""Core MM update and objective math for NBMF-MM on torch tensors
(counterpart of the JAX package's ``ops/updates.py``).

The model is ``V ~ Bernoulli(W @ H)`` with a simplex constraint on one
factor and an elementwise Beta(alpha, beta) prior on the other.  Everything
here uses the canonical "beta-dir" orientation in the internal layout:

- ``W``: shape ``(k, m)``, columns sum to 1 (the simplex factor, transposed),
- ``H``: shape ``(k, n)``, entries in ``(0, 1)`` (the Beta-prior factor).

Masked data enters through three loop-invariant matrices from
:func:`precompute_masked_terms`: ``Ym = Y * mask`` feeds the positive terms,
``Ym2 = (1 - Y) * mask`` the W update's negative term, and ``Yc`` the H-update
denominator and the objective (``1 - Ym`` in ``mask_mode="parity"``,
``Ym2`` in ``"corrected"``).

Matrix products run through ``torch.matmul``; the solver switches TF32 off
on CUDA so float32 products stay IEEE fp32.  :func:`mm_sweep`,
:func:`map_objective` and :func:`fold_in_w_update` take ``precision=`` as the
JAX functions do: under ``"default"`` or ``"high"`` every operand of every
product is rounded to bf16 or TF32 first (:mod:`~nbmf_mm_tpu_torch.ops.tiers`
defines the tiers; the JAX package on the CPU computes every tier in fp32).

:func:`mm_sweep` is :func:`h_step` then :func:`w_step`.  Restarts and
hyperparameter grids batch the factors: these three and
:func:`map_objective` also take ``W (R, k, m)`` with ``H (R, k, n)`` over the
same data, and then ``alpha``/``beta`` as floats or as one value per lane.
They run the unbatched function lane by lane and stack the results, so lane
``r`` equals the unbatched call on ``(W[r], H[r])`` bitwise, on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .projection import project_columns_simplex_duchi
from .tiers import complement, mxu_round, operand_form

__all__ = [
    "precompute_masked_terms",
    "clip_upper_interior",
    "h_step",
    "w_step",
    "mm_sweep",
    "map_objective",
    "fold_in_w_update",
]


def precompute_masked_terms(
    Y: torch.Tensor,
    mask: Optional[torch.Tensor],
    mask_mode: str = "parity",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precompute the loop-invariant masked matrices ``(Ym, Ym2, Yc)``.

    With ``mask=None`` the two modes coincide and ``Ym2 is Yc``.
    """
    if mask_mode not in ("parity", "corrected"):
        raise ValueError(f"unknown mask_mode: {mask_mode!r}")
    if mask is None:
        comp = 1.0 - Y
        return Y, comp, comp
    mask = mask.to(Y.dtype)
    Ym = Y * mask
    Ym2 = (1.0 - Y) * mask
    Yc = (1.0 - Ym) if mask_mode == "parity" else Ym2
    return Ym, Ym2, Yc


def clip_upper_interior(eps: float, dtype: torch.dtype) -> float:
    """Upper clip bound for the Beta factor, strictly below 1 in ``dtype``.

    ``1 - eps`` with ``eps = 1e-8`` rounds to exactly 1.0 in float32, where H
    could then reach the boundary and ``log(1 - H)`` become ``-inf``.  The
    bound is the smaller of ``1 - eps`` and the largest value below 1 in
    ``dtype`` (``0.99999994`` in float32; ``1 - 1e-8`` unchanged in float64).
    Returned as a Python float, which is exact in ``dtype``.
    """
    one = torch.tensor(1.0, dtype=dtype)
    below_one = torch.nextafter(one, torch.tensor(0.0, dtype=dtype))
    return float(torch.minimum(one - eps, below_one))


def _h_update(W, H, Ym, Yc, alpha, beta, eps, form="f32"):
    """Multiplicative Beta-factor update (reference ``_solver.py:39-47``);
    the products' operands rounded as ``form`` says."""
    Wr = mxu_round(W, form)
    WH = Wr.T @ mxu_round(H, form)  # (m, n)
    num = H * (Wr @ mxu_round(Ym / (WH + eps), form)) + (alpha - 1.0)
    den = (1.0 - H) * (Wr @ mxu_round(Yc / (torch.clamp_min(1.0 - WH, 0.0) + eps), form)) + (
        beta - 1.0)
    H_new = num / (num + den + eps)
    return torch.clamp(H_new, eps, clip_upper_interior(eps, H.dtype))


def _w_terms(W, H, Ym, Ym2, eps, form):
    """``T = H (Ym / WH)^T + (1 - H) (Ym2 / (1 - WH))^T``, the W update's
    contraction, with the products' operands rounded as ``form`` says."""
    Hr = mxu_round(H, form)
    WH = mxu_round(W, form).T @ Hr  # (m, n)
    return Hr @ mxu_round(Ym / (WH + eps), form).T + complement(H, form) @ mxu_round(
        Ym2 / (torch.clamp_min(1.0 - WH, 0.0) + eps), form).T


def _w_update(W, H_new, Ym, Ym2, n_real, eps, projection, form="f32"):
    """Multiplicative simplex-factor update (reference ``_solver.py:50-57``)."""
    T = _w_terms(W, H_new, Ym, Ym2, eps, form)
    W_raw = W * T  # (k, m)
    if projection == "normalize":
        W_new = W_raw / n_real
        col_sums = W_new.sum(dim=0, keepdim=True)
        # Guard zero columns: keeps padded / degenerate cases NaN-free
        # without changing live columns.
        W_new = W_new / torch.where(col_sums > 0, col_sums, 1.0)
    elif projection == "duchi":
        W_new = project_columns_simplex_duchi(W_raw / n_real)
    else:  # pragma: no cover - validated at the API boundary
        raise ValueError(f"unknown projection: {projection!r}")
    return W_new


def _lane_value(x, r: int) -> float:
    """Lane ``r``'s value of a hyperparameter given as one float for all
    lanes or as one value per lane."""
    return float(x) if isinstance(x, (int, float)) else float(x[r])


def h_step(W, H, Ym, Yc, *, alpha, beta, eps: float = 1e-8, precision=None) -> torch.Tensor:
    """The H half of :func:`mm_sweep`: the Beta factor after its MM step
    under ``W``.  Batched factors step lane by lane."""
    if W.dim() == 3:
        return torch.stack([h_step(W[r], H[r], Ym, Yc, alpha=_lane_value(alpha, r),
                                   beta=_lane_value(beta, r), eps=eps, precision=precision)
                            for r in range(W.shape[0])])
    return _h_update(W, H, Ym, Yc, alpha, beta, eps, operand_form(precision))


def w_step(W, H_new, Ym, Ym2, *, n_real: int, eps: float = 1e-8, projection: str = "normalize",
           precision=None) -> torch.Tensor:
    """The W half of :func:`mm_sweep`: the simplex factor after its MM step
    under the new ``H``.  Batched factors step lane by lane."""
    if W.dim() == 3:
        return torch.stack([w_step(W[r], H_new[r], Ym, Ym2, n_real=n_real, eps=eps,
                                   projection=projection, precision=precision)
                            for r in range(W.shape[0])])
    return _w_update(W, H_new, Ym, Ym2, n_real, eps, projection, operand_form(precision))


def mm_sweep(
    W: torch.Tensor,
    H: torch.Tensor,
    Ym: torch.Tensor,
    Ym2: torch.Tensor,
    Yc: torch.Tensor,
    *,
    alpha: float,
    beta: float,
    n_real: int,
    eps: float = 1e-8,
    projection: str = "normalize",
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full MM sweep: H update (old W) then W update (new H).

    ``n_real`` is the number of columns of the data matrix, the MM scaling
    constant of the simplex step (reference ``_solver.py:54``).  Batched
    factors ``(R, k, m)``, ``(R, k, n)`` sweep lane by lane.  ``precision``
    is the tier of every product.
    """
    H_new = h_step(W, H, Ym, Yc, alpha=alpha, beta=beta, eps=eps, precision=precision)
    return w_step(W, H_new, Ym, Ym2, n_real=n_real, eps=eps, projection=projection,
                  precision=precision), H_new


def map_objective(
    W: torch.Tensor,
    H: torch.Tensor,
    Ym: torch.Tensor,
    Yc: torch.Tensor,
    *,
    alpha: float,
    beta: float,
    n_obs: float,
    eps: float = 1e-8,
    precision=None,
) -> torch.Tensor:
    """Negative MAP objective per observed entry (reference ``_solver.py:148-162``).

    ``loss = -(sum(Ym log(WH+eps) + Yc log(1-WH+eps))
              + (alpha-1) sum(log(H+eps)) + (beta-1) sum(log(1-H+eps))) / n_obs``

    Batched factors give one loss per lane, ``(R,)``.  ``precision`` is the
    tier of the ``WH`` product.
    """
    if W.dim() == 3:
        return torch.stack([map_objective(W[r], H[r], Ym, Yc, alpha=_lane_value(alpha, r),
                                          beta=_lane_value(beta, r), n_obs=n_obs, eps=eps,
                                          precision=precision)
                            for r in range(W.shape[0])])
    form = operand_form(precision)
    WH = mxu_round(W, form).T @ mxu_round(H, form)
    log_lik = Ym * torch.log(WH + eps) + Yc * torch.log(torch.clamp_min(1.0 - WH, 0.0) + eps)
    prior_a = (alpha - 1.0) * torch.sum(torch.log(H + eps))
    prior_b = (beta - 1.0) * torch.sum(torch.log(1.0 - H + eps))
    return -(torch.sum(log_lik) + prior_a + prior_b) / n_obs


def fold_in_w_update(
    Wt: torch.Tensor,
    H: torch.Tensor,
    Ym: torch.Tensor,
    Ym2: torch.Tensor,
    *,
    n_features: int,
    eps: float = 1e-8,
    precision=None,
) -> torch.Tensor:
    """One fold-in iteration used by ``transform`` (reference ``_base.py:178-193``):
    the beta-dir W update with ``H`` held fixed.  ``Wt`` has internal layout
    ``(k, m)``; returns the updated ``(k, m)`` factor with unit column sums.
    ``precision`` is the tier of every product.
    """
    T = _w_terms(Wt, H, Ym, Ym2, eps, operand_form(precision))
    Wt = Wt * T / n_features
    col_sums = Wt.sum(dim=0, keepdim=True)
    return Wt / torch.where(col_sums > 0, col_sums, 1.0)
