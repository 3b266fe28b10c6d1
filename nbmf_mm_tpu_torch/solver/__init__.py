"""MM solver driver."""

from .driver import SolverResult, nbmf_mm_solver, solve

__all__ = ["nbmf_mm_solver", "solve", "SolverResult"]
