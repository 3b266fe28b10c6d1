"""nbmf-mm-tpu-torch: the NBMF-MM solver in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100).

This package is the PyTorch port of the JAX package beside it.  It mirrors that
package's tree (``ops/``, ``solver/``, ``models/``, ``utils/``) so each module
has a counterpart, and it never imports JAX.  The fit path on exactly-binary
data runs the shifted-loss MM loop over bit-packed words, and on
``[0, 1]``-valued data or under a weighted mask over dense operands
(:func:`nbmf_mm_tpu_torch.solver.driver.solve`); the two passes per sweep
are CUDA kernels built from ``ops/csrc/`` at first use
(:mod:`nbmf_mm_tpu_torch.ops.cuda_sweep`,
:mod:`nbmf_mm_tpu_torch.ops.dense_sweep`).  Serving folds new rows in
against a fitted model through the same W-pass kernels
(:class:`FoldInServer`, :func:`fold_in_fused`).  Data that is packed already
or sparse (:class:`PackedMatrix` and its packers, ``scipy.sparse`` input)
reaches the packed loop without a dense copy
(:mod:`nbmf_mm_tpu_torch.ops.packed`).  Restarts (``solve(n_init=...)``)
and hyperparameter grids (:func:`grid_solve`) run as one batched solve over
data staged once: the kernels take a leading lane axis on the factors
(:mod:`nbmf_mm_tpu_torch.parallel`).  ``precision="default"``/``"high"``
round every product operand to bf16 or TF32, and ``dtype="bfloat16"`` stores
the data bf16, on every entry point (:mod:`nbmf_mm_tpu_torch.ops.tiers`).
Fits checkpoint and resume through ``.npz`` files in the JAX package's format
(:mod:`nbmf_mm_tpu_torch.utils.checkpoint`), and the paper's NBMF-EM and
logPCA baselines are in :mod:`nbmf_mm_tpu_torch.models.baselines`.  With
``NBMF_CACHE_DIR`` set, importing the package points the kernel build there
(:mod:`nbmf_mm_tpu_torch.utils.cache`).

Public surface: ``NBMF``/``NBMFMM``, :func:`solve`, :func:`nbmf_mm_solver`,
:class:`SolverResult`, :class:`PackedMatrix`, :func:`pack_matrix`,
:func:`pack_matrix_chunked`, :func:`pack_matrix_sparse`,
:class:`FoldInServer`, :func:`fold_in_fused`, :func:`grid_solve`.
"""

from .models.estimator import NBMF, NBMFMM
from .models.serving import FoldInServer, fold_in_fused
from .ops.packed import PackedMatrix, pack_matrix, pack_matrix_chunked, pack_matrix_sparse
from .parallel.grid import grid_solve
from .solver.driver import SolverResult, nbmf_mm_solver, solve
from .utils.cache import maybe_enable_compilation_cache as _maybe_cache

__version__ = "0.1.0"

_maybe_cache()

__all__ = [
    "NBMFMM",
    "NBMF",
    "nbmf_mm_solver",
    "solve",
    "SolverResult",
    "PackedMatrix",
    "pack_matrix",
    "pack_matrix_chunked",
    "pack_matrix_sparse",
    "FoldInServer",
    "fold_in_fused",
    "grid_solve",
    "__version__",
]
