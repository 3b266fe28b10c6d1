"""The NBMF estimator."""

from .estimator import NBMF, NBMFMM

__all__ = ["NBMF", "NBMFMM"]
