"""The traced run: a ``torch.profiler`` trace of the window (the recipe of
``nbmf_mm_tpu_torch/utils/profiling.trace``, copied), read back as a Chrome
trace and reduced to the record that the per-layer metrics read.

The harness marks the window and each fit with ``record_function`` spans
(:data:`WINDOW`, :data:`FIT`).  From the trace it takes, inside the window:

- ``busy_s``: the union of the device's intervals (kernels, copies, sets);
  ``kernel_busy_s`` the union of the kernels' alone;
- ``launches``: kernel launches by the host; ``syncs``: host calls that wait
  for the device (stream, device and event synchronisations and blocking
  copies);
- ``fit_start_ms``: for each fit, from its span's start to the start of the
  first kernel after it;
- the breakdown: the device operations that took most time, and the idle
  gaps of the device summed by the innermost host activity at their middle;
- ``spans``: the program's own ``nbmf_mm.*`` spans, reduced by
  :func:`portbench.spans.table`.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

from . import spans as program_spans

WINDOW = "portbench.window"
FIT = "portbench.solve"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"}
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy"}
TOP = 10


def profile():
    """A profiler of the host and the card, to be entered around the window."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def events(prof) -> list:
    """The complete events of a finished profile, through a Chrome trace in a
    temporary directory that is removed after it is read."""
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def _union(intervals):
    """Merged ``[start, end)`` intervals, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def reduce(trace_events: list) -> dict:
    """The record of a traced window (times in seconds), or an empty dict
    where the trace holds no window span."""
    spans = [e for e in trace_events if e.get("cat") == "user_annotation"]
    window = next((e for e in spans if e["name"] == WINDOW), None)
    if window is None:
        return {}
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])

    def inside(e):
        return w0 <= float(e["ts"]) < w1

    device = [e for e in trace_events if e.get("cat") in DEVICE_CATS and inside(e)]
    clip = lambda e: (float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1))
    busy = _union(clip(e) for e in device)
    kernels = [e for e in device if e["cat"] == "kernel"]
    per_name = defaultdict(float)
    for e in device:
        per_name[_short(e["name"])] += float(e["dur"]) / 1e6

    # Each gap goes to the innermost host event around its middle: of the
    # events begun by then and not yet ended, the one begun last.  Middles
    # are taken in order, so an event found ended stays ended.
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in trace_events if e.get("cat") in HOST_CATS and inside(e))
    edges = [w0, *[x for a, b in busy for x in (a, b)], w1]
    gaps, open_, i = defaultdict(float), [], 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(open_, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while open_ and open_[0][1] < mid:
            heapq.heappop(open_)
        gaps[_short(open_[0][2] if open_ else "(no host activity)")] += (b - a) / 1e6

    runtime = [e["name"] for e in trace_events if e.get("cat") == "cuda_runtime" and inside(e)]
    kernel_starts = sorted(float(e["ts"]) for e in kernels)
    fit_start_ms = []
    for s in (e for e in spans if e["name"] == FIT and inside(e)):
        i = bisect.bisect_left(kernel_starts, float(s["ts"]))
        if i < len(kernel_starts):
            fit_start_ms.append((kernel_starts[i] - float(s["ts"])) / 1e3)

    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_busy_s": sum(b - a for a, b in _union(clip(e) for e in kernels)) / 1e6,
        "launches": sum(name in LAUNCH_CALLS for name in runtime),
        "syncs": sum(name in SYNC_CALLS for name in runtime),
        "fit_start_ms": fit_start_ms,
        "breakdown": {"device_ops": top(per_name), "idle_gaps": top(gaps)},
        "spans": program_spans.table(trace_events),
    }
