"""Tracing and timing hooks (counterpart of the JAX package's
``utils/profiling.py``).

- :func:`trace` records a ``torch.profiler`` trace of the enclosed region
  and writes it as a Chrome trace (viewable in Perfetto);
- :func:`span` marks a region of the program in such a trace, and costs a
  flag read when no profiler records;
- :func:`sweep_timer` times a function's steady state: CUDA events on the
  card, the host clock on the CPU;
- :func:`device_memory_stats` returns ``torch.cuda.memory_stats`` of a card,
  and ``{}`` on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "span", "sweep_timer", "device_memory_stats"]

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed region (CPU, and
    CUDA where a card is present) into ``log_dir/trace.json``; the profile
    is yielded for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A ``record_function`` span named ``name`` while a profiler records
    (:func:`trace`, ``torch.profiler.profile``), else one shared no-op
    context.  The profiler keeps it as a ``user_annotation`` event, timed on
    the clock of the device's kernels and copies in the same trace."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args)


def sweep_timer(fn, *args, warmup: int = 2, iters: int = 10):
    """Time ``fn(*args)``'s steady state over ``iters`` calls after
    ``warmup`` calls.  Returns ``(seconds_per_call, calls_per_second)``.

    With a CUDA tensor among ``args`` the time is the device's, from CUDA
    events around the calls; otherwise the host clock's."""
    for _ in range(warmup):
        fn(*args)
    if _on_card(args):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return dt, 1.0 / dt


def device_memory_stats(device=None) -> dict:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current card),
    or ``{}`` for a CPU device or where there is no card."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
