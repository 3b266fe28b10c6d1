"""Utilities: validation and synthetic data.  State carried over from the JAX
package is in :mod:`nbmf_mm_tpu_torch.utils.interop`."""

from .synth import generate_synthetic_binary_data
from .validation import check_array, check_is_fitted, densify

__all__ = [
    "check_is_fitted",
    "check_array",
    "densify",
    "generate_synthetic_binary_data",
]
