"""Sweep math, simplex projections, the packed and dense sweep kernels, and
packed input (:mod:`~nbmf_mm_tpu_torch.ops.packed`: ``PackedMatrix`` and the
packers)."""

from .projection import project_columns_simplex_duchi, project_simplex_duchi
from .updates import fold_in_w_update, map_objective, mm_sweep, precompute_masked_terms

__all__ = [
    "mm_sweep",
    "map_objective",
    "fold_in_w_update",
    "precompute_masked_terms",
    "project_columns_simplex_duchi",
    "project_simplex_duchi",
]
