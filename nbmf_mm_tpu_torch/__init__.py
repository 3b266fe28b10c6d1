"""nbmf-mm-tpu-torch: the NBMF-MM solver in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100).

This package is the PyTorch port of the JAX package beside it.  It mirrors that
package's tree (``ops/``, ``solver/``, ``models/``, ``utils/``) so each module
has a counterpart, and it never imports JAX.  The fit path on exactly-binary
data runs the shifted-loss MM loop over bit-packed words
(:func:`nbmf_mm_tpu_torch.solver.driver.solve`), whose two passes per sweep
are CUDA kernels built from ``ops/csrc/`` at first use
(:mod:`nbmf_mm_tpu_torch.ops.cuda_sweep`).

Public surface: ``NBMF``/``NBMFMM``, :func:`solve`, :func:`nbmf_mm_solver`,
:class:`SolverResult`.
"""

from .models.estimator import NBMF, NBMFMM
from .solver.driver import SolverResult, nbmf_mm_solver, solve

__version__ = "0.1.0"

__all__ = [
    "NBMFMM",
    "NBMF",
    "nbmf_mm_solver",
    "solve",
    "SolverResult",
    "__version__",
]
