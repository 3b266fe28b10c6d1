"""Utilities: validation, synthetic data and profiling.  State carried over
from the JAX package is in :mod:`nbmf_mm_tpu_torch.utils.interop`."""

from .profiling import device_memory_stats, sweep_timer, trace
from .synth import generate_synthetic_binary_data
from .validation import check_array, check_is_fitted, densify

__all__ = [
    "check_is_fitted",
    "check_array",
    "densify",
    "device_memory_stats",
    "generate_synthetic_binary_data",
    "sweep_timer",
    "trace",
]
