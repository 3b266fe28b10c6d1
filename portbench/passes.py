"""Each of a sweep's two passes on its own: its least time, and its share of
that time in a traced window.

The H pass and the W pass each do ``6 m n k`` operations a lane
(:func:`portbench.roofline.pass_flops`) and read the data, ``W`` and ``H``
once; the H pass writes ``Num`` and ``Den`` (``k n`` floats each a lane) and
one ``ll`` a lane, the W pass ``T`` (``k m`` floats a lane).  The two least
times add up to :func:`portbench.roofline.sweep_seconds`.

A pass's share (:func:`share`) is its least time times the count of the
program's span around each pass over all lanes (``nbmf_mm.hpass``,
``nbmf_mm.wpass``, one a call), over the device seconds of the pass's
kernels in the record's ``breakdown.device_ops``:

- the H pass: ``hpass_kernel`` (the instance of every fp32 form, and the
  dense ``loglik_sum`` fill, which no ``hpass`` span counts),
  ``bitplane_w_kernel``, ``sum_splits_kernel`` and ``sum_ll_kernel``;
- the W pass: ``wpass_kernel`` and ``sum_parts_kernel``.

Only the work the spans count is in the numerator, and every named kernel's
time is in the denominator, so time whose work is not counted lowers a
share.  ``device_ops`` lists the :data:`portbench.tracing.TOP` operations
that took most time; where it is full, a named kernel that it leaves out
took at most as long as the last one listed, and that time is counted for
it, so a kernel that falls off the list cannot raise a share either.  The
share is ``None`` without the span or the pass's main kernel (the first
named), as in a program that has no such span or a tensor-core form.
"""

from __future__ import annotations

import re

from .roofline import DATA_BYTES, PEAK, bound, pass_flops
from .tracing import TOP

H_KERNELS = ("hpass_kernel", "bitplane_w_kernel", "sum_splits_kernel", "sum_ll_kernel")
W_KERNELS = ("wpass_kernel", "sum_parts_kernel")


def _bytes_in(m: int, n: int, k: int, lanes: int, data: str) -> float:
    """The data, ``W`` and ``H``, read once."""
    return DATA_BYTES[data] * m * n + 4.0 * k * (m + n) * lanes


def h_seconds(m: int, n: int, k: int, lanes: int, precision: str, data: str) -> float:
    """The H pass's least time."""
    out = 4.0 * 2 * k * n * lanes + 8 * lanes
    return bound(pass_flops(m, n, k, lanes), _bytes_in(m, n, k, lanes, data) + out,
                 PEAK[precision])[0]


def w_seconds(m: int, n: int, k: int, lanes: int, precision: str, data: str) -> float:
    """The W pass's least time."""
    out = 4.0 * k * m * lanes
    return bound(pass_flops(m, n, k, lanes), _bytes_in(m, n, k, lanes, data) + out,
                 PEAK[precision])[0]


def _named(op: str, kernel: str) -> bool:
    """Whether a shortened device-operation name is ``kernel``'s: the name
    follows a namespace, ``void_`` or the start, and ends or goes on into
    its template arguments."""
    return re.search(rf"(?:^|:|void_){kernel}(?:_|$)", op) is not None


def kernel_seconds(device_ops: list, kernels: tuple):
    """The device seconds of ``kernels`` in ``device_ops`` (``[name,
    seconds]`` pairs, most first), or ``None`` where the first of them is
    not there."""
    listed = {kern: [s for op, s in device_ops if _named(op, kern)] for kern in kernels}
    if not listed[kernels[0]]:
        return None
    floor = device_ops[-1][1] if len(device_ops) >= TOP else 0.0
    return sum(sum(times) if times else floor for times in listed.values())


def share(rec: dict, span: str, least, kernels: tuple):
    """``100 least(...) count(span) / seconds(kernels)`` of a traced record,
    or ``None`` where it has no such span or kernel."""
    spans = (rec.get("spans") or {}).get(span)
    ops = (rec.get("breakdown") or {}).get("device_ops")
    if not spans or not spans.get("count") or not ops:
        return None
    seconds = kernel_seconds(ops, kernels)
    if not seconds:
        return None
    t = least(rec["m"], rec["n"], rec["k"], rec["lanes"], rec["precision"], rec["input"])
    return 100.0 * t * spans["count"] / seconds
