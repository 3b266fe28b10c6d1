"""Model families: the NBMF estimator, fold-in serving, and the paper's
comparison baselines."""

from .baselines import LogisticPCA, NBMFEM
from .estimator import NBMF, NBMFMM
from .serving import FoldInServer

__all__ = ["NBMF", "NBMFMM", "NBMFEM", "LogisticPCA", "FoldInServer"]
