"""Batched solves over one staged copy of the data: restarts and
hyperparameter grids (counterpart of the JAX package's ``parallel/``)."""

from .grid import grid_solve
from .restarts import vmapped_solve

__all__ = ["grid_solve", "vmapped_solve"]
