"""The program's own spans in a traced run of a cell.

While a profiler records, ``solve`` marks its layers with ``record_function``
spans named ``nbmf_mm.*`` (``nbmf_mm_tpu_torch.utils.profiling.span``;
``nbmf_mm_tpu_torch/solver/driver.py`` lists them).  The profiler times them
on the clock of the device's kernels and copies, so each idle stretch of the
device falls inside known spans.  :func:`table` reduces the spans inside the harness's
window to a count, the host time they cover and the device-idle time inside
them; :func:`readings` turns the table into six per-layer numbers.

The record that ``tracing.reduce`` hands the metrics holds the table under
``spans``; ``metrics/staging_ms.fit.py`` reads the first of the readings.
This module's command prints all six beside a traced run:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs ``python3 -m portbench.run ... --trace 1`` and prints all that it
prints, then one JSON line more, last: ``{"spans", "readings"}``.
"""

from __future__ import annotations

import contextlib
import json
import sys
from collections import defaultdict

from . import tracing

PREFIX = "nbmf_mm."


def _overlap(a, b) -> float:
    """The length that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def table(trace_events: list) -> dict:
    """``{name: {"count", "host_s", "idle_s"}}`` of the ``nbmf_mm.*`` spans
    that start inside the window, or an empty dict where the trace holds no
    window span.  ``host_s`` sums the spans' durations; ``idle_s`` is the
    time inside them (clipped to the window) in which no kernel, copy or set
    ran on the device, the intervals that ``tracing.reduce`` merges."""
    notes = [e for e in trace_events if e.get("cat") == "user_annotation"]
    window = next((e for e in notes if e["name"] == tracing.WINDOW), None)
    if window is None:
        return {}
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])

    def inside(e):
        return w0 <= float(e["ts"]) < w1

    def clip(e):
        return float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)

    busy = tracing._union(clip(e) for e in trace_events
                          if e.get("cat") in tracing.DEVICE_CATS and inside(e))
    by_name = defaultdict(list)
    for e in notes:
        if e["name"].startswith(PREFIX) and inside(e):
            by_name[e["name"]].append(e)
    out = {}
    for name, spans in sorted(by_name.items()):
        covered = tracing._union(clip(e) for e in spans)
        idle = sum(b - a for a, b in covered) - _overlap(covered, busy)
        out[name] = {"count": len(spans), "host_s": sum(float(e["dur"]) for e in spans) / 1e6,
                     "idle_s": idle / 1e6}
    return out


def readings(spans: dict, window_s: float) -> dict:
    """The six per-layer numbers of a span table, each ``None`` where its
    spans are absent (as in a program without them):

    - ``staging_ms.fit``, ``init_draw_ms.fit``: the mean host duration of
      ``nbmf_mm.stage`` and of ``nbmf_mm.init_draw`` (ms);
    - ``staging_idle_pct.fit``, ``loop_idle_pct.fit``: the device-idle time
      inside ``nbmf_mm.stage`` and inside ``nbmf_mm.loop``, as a share of
      the window (%);
    - ``stop_reads_per_sweep.fit``: ``nbmf_mm.wait.stop_flag`` spans per
      ``nbmf_mm.sweep`` span;
    - ``select_idle_ms.fit``: the device-idle time inside ``nbmf_mm.select``
      per span (ms).
    """
    def span(name):
        return spans.get(PREFIX + name)

    def per_span(name, key, scale):
        s = span(name)
        return scale * s[key] / s["count"] if s else None

    def idle_pct(name):
        s = span(name)
        return 100.0 * s["idle_s"] / window_s if s and window_s else None

    sweep, stop = span("sweep"), span("wait.stop_flag")
    stop_reads = (stop["count"] if stop else 0) / sweep["count"] if sweep else None
    return {
        "staging_ms.fit": per_span("stage", "host_s", 1e3),
        "init_draw_ms.fit": per_span("init_draw", "host_s", 1e3),
        "staging_idle_pct.fit": idle_pct("stage"),
        "loop_idle_pct.fit": idle_pct("loop"),
        "stop_reads_per_sweep.fit": stop_reads,
        "select_idle_ms.fit": per_span("select", "idle_s", 1e3),
    }


@contextlib.contextmanager
def keeping_spans():
    """Inside, every trace that the harness reduces also leaves
    ``{"window_s", "spans"}`` of its record in the yielded list."""
    kept = []
    reduce = tracing.reduce

    def reduce_and_keep(trace_events):
        rec = reduce(trace_events)
        kept.append({"window_s": rec.get("window_s"), "spans": rec.get("spans", {})})
        return rec

    tracing.reduce = reduce_and_keep
    try:
        yield kept
    finally:
        tracing.reduce = reduce


def main(argv=None) -> int:
    from . import run

    argv = list(sys.argv[1:] if argv is None else argv)
    with keeping_spans() as kept:
        code = run.main([*argv, "--trace", "1"])
    if code == 0 and kept:
        last = kept[-1]
        print(json.dumps({"spans": last["spans"],
                          "readings": readings(last["spans"], last["window_s"])}), flush=True)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
