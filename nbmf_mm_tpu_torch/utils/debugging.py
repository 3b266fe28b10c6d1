"""Development-mode numerical checks (counterpart of the JAX package's
``utils/debugging.py``).

The JAX package turns on ``jax_debug_nans``.  The port has a flag of its own,
read by the solver loops (``solver/driver.py``: the plain loop and the fused
loop, for one initialization and for a batch of lanes) and by serving's
fold-in loop (``models/serving.py``): when it is on, each loop checks after
every sweep that its factors and its loss are finite, and raises
``FloatingPointError`` naming the sweep.  A check reads one flag back from
the device per tensor, so it costs a host sync per sweep; when the flag is
off the loops pay one Python bool test.  The checks only read, so results
with the flag on equal results with it off, bitwise.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["enable_nan_checks", "nan_checks"]

_ENABLED = False


def enable_nan_checks(enable: bool = True) -> None:
    """Turn the loops' finite checks on (or off) for the whole process."""
    global _ENABLED
    _ENABLED = bool(enable)


def nan_checks_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def nan_checks():
    """Scoped variant of :func:`enable_nan_checks`: on inside, the previous
    setting back on exit, also when the body raises."""
    prev = _ENABLED
    enable_nan_checks(True)
    try:
        yield
    finally:
        enable_nan_checks(prev)


def check_finite(where: str, sweep: int, **tensors) -> None:
    """Raise ``FloatingPointError`` if a tensor holds a NaN or an infinity
    after ``sweep`` (counted from 0) of the loop ``where``."""
    for name, t in tensors.items():
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{where}: {name} is not finite after sweep {sweep} "
                                     "(nan_checks is on)")
