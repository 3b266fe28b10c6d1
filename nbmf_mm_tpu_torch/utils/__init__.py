"""Utilities: validation, synthetic data, checkpointing, profiling, NaN
checks, the R data reader and the kernel build cache.  State carried over
from the JAX package is in :mod:`nbmf_mm_tpu_torch.utils.interop`."""

from .cache import enable_compilation_cache, maybe_enable_compilation_cache
from .checkpoint import (
    load_checkpoint,
    load_model,
    resume_fit,
    save_checkpoint,
    save_model,
)
from .debugging import enable_nan_checks, nan_checks
from .profiling import device_memory_stats, sweep_timer, trace
from .rdata import load_r_matrix, read_rda
from .synth import generate_synthetic_binary_data
from .validation import check_array, check_is_fitted, densify

__all__ = [
    "check_is_fitted",
    "check_array",
    "densify",
    "generate_synthetic_binary_data",
    "save_checkpoint",
    "load_checkpoint",
    "save_model",
    "load_model",
    "resume_fit",
    "trace",
    "sweep_timer",
    "device_memory_stats",
    "read_rda",
    "load_r_matrix",
    "enable_nan_checks",
    "nan_checks",
    "enable_compilation_cache",
    "maybe_enable_compilation_cache",
]
