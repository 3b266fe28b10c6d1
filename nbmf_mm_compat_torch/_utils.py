"""Reference-internal module shim: reference tests import
``from nbmf_mm._utils import generate_synthetic_binary_data`` and the fitted
check (reference ``src/nbmf_mm/_utils.py``)."""

from nbmf_mm_tpu_torch.utils.synth import generate_synthetic_binary_data
from nbmf_mm_tpu_torch.utils.validation import check_is_fitted

__all__ = ["generate_synthetic_binary_data", "check_is_fitted"]
