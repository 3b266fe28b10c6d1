"""Drop-in compatibility shim for the PyTorch port:
``import nbmf_mm_compat_torch as nbmf_mm``.

Exposes the reference library's public import surface (``NBMFMM``, ``NBMF``,
``nbmf_mm_solver`` and ``__version__``), re-exported from
:mod:`nbmf_mm_tpu_torch`, as ``nbmf_mm_compat`` does for the JAX package.
The port's entry points run on the card unless they are given
``device="cpu"``.
"""

from nbmf_mm_tpu_torch import NBMF, NBMFMM, __version__, nbmf_mm_solver

__all__ = ["NBMFMM", "NBMF", "nbmf_mm_solver"]
