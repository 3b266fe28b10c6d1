"""Simplex projections (counterpart of the JAX package's ``ops/projection.py``).

- ``"normalize"`` — the paper-exact MM step (divide by ``n`` then L1-normalize
  columns), written inline in :mod:`nbmf_mm_tpu_torch.ops.updates`.
- ``"duchi"`` — Euclidean projection onto the probability simplex via the
  sort-based algorithm of Duchi, Shalev-Shwartz, Singer & Chandra (ICML
  2008).  ``k`` is the factorization rank (small), so the sort runs on tiny
  ``(k, m)`` tensors.
"""

from __future__ import annotations

import torch

__all__ = ["project_columns_simplex_duchi", "project_simplex_duchi"]


def project_columns_simplex_duchi(X: torch.Tensor) -> torch.Tensor:
    """Project each column of ``X`` (shape ``(k, m)``) onto the probability
    simplex ``{w : w >= 0, sum(w) = 1}`` in Euclidean norm.

    For a column ``x`` with descending sort ``u`` and cumulative sums ``c``,
    the active-set size is ``rho = max{ j : u_j > (c_j - 1) / j }`` and the
    threshold is ``tau = (c_rho - 1) / rho``; the projection is
    ``max(x - tau, 0)``.
    """
    k = X.shape[0]
    u = torch.sort(X, dim=0, descending=True).values
    css = torch.cumsum(u, dim=0)
    j = torch.arange(1, k + 1, dtype=X.dtype, device=X.device).reshape(
        (k,) + (1,) * (X.dim() - 1)
    )
    cond = u > (css - 1.0) / j
    # `cond` is prefix-true along dim 0, so the active-set size is its sum.
    rho = cond.sum(dim=0, keepdim=True)
    css_rho = torch.gather(css, 0, rho - 1)
    tau = (css_rho - 1.0) / rho.to(X.dtype)
    return torch.clamp_min(X - tau, 0.0)


def project_simplex_duchi(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Project slices of ``x`` along ``dim`` onto the probability simplex."""
    moved = torch.movedim(x, dim, 0)
    return torch.movedim(project_columns_simplex_duchi(moved), 0, dim)
