"""Peaks of one NVIDIA H100 and the least time of a sweep's pass work.

The peaks are NVIDIA's data sheet for the SXM part at its 700 W limit
(dense rates), copied from ``chip_smoke.py`` (``FP32_PEAK``, ``HBM_RATE``,
``FORM_PEAK``): a precision tier's products run at the peak of the operand
type they round to.  A pass (the H pass or the W pass) does ``6 m n k``
operations a lane: three ``m n k`` products of two operations each.  Its
bytes are its inputs read once and its outputs written once: the data, ``W``
and ``H`` in; ``Num`` and ``Den`` (H pass) or ``T`` (W pass) out.
"""

from __future__ import annotations

HBM_RATE = 3.35e12  # bytes/s
PEAK = {  # operations/s by the solver's ``precision`` tier
    "highest": 67e12,  # float32 on the CUDA cores
    "high": 495e12,  # TF32 on the tensor cores
    "default": 989e12,  # bf16 on the tensor cores
}
# Bytes an entry, by traffic input: one word plane; dense float32; two word
# planes (``Ym`` and ``Ym2``), which each pass streams in corrected mode.
DATA_BYTES = {"packed": 1 / 8, "soft_dense": 4, "dense_masked": 2 / 8}


def bound(flops: float, nbytes: float, peak: float):
    """``(seconds, bound_by)`` of work of ``flops`` operations at ``peak``
    per second that moves ``nbytes``."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def pass_flops(m: int, n: int, k: int, lanes: int) -> float:
    return 6.0 * m * n * k * lanes


def sweep_seconds(m: int, n: int, k: int, lanes: int, precision: str, data: str) -> float:
    """The least time of one sweep's two passes."""
    factors = 4.0 * k * (m + n) * lanes
    data_bytes = DATA_BYTES[data] * m * n
    h_out, w_out = 4.0 * 2 * k * n * lanes + 8 * lanes, 4.0 * k * m * lanes
    flops, peak = pass_flops(m, n, k, lanes), PEAK[precision]
    return (bound(flops, data_bytes + factors + h_out, peak)[0]
            + bound(flops, data_bytes + factors + w_out, peak)[0])
