"""The port's profiling hooks (counterpart of the JAX package's profiling
tests in ``tests/test_profiling_and_debug.py``): on the CPU the timer uses
the host clock, the trace records host activity, and there are no device
memory stats."""

import json

import pytest
import torch

from nbmf_mm_tpu_torch.utils import device_memory_stats, sweep_timer, trace

torch.set_num_threads(1)


def test_sweep_timer_measures_a_function():
    x = torch.ones((64, 64))
    calls = []

    def f(x):
        calls.append(1)
        return (x @ x.T).sum()

    dt, per_sec = sweep_timer(f, x, warmup=1, iters=3)
    assert dt > 0 and per_sec == pytest.approx(1.0 / dt)
    assert len(calls) == 4


def test_trace_writes_profile(tmp_path):
    with trace(str(tmp_path)) as prof:
        (torch.ones((32, 32)) @ torch.ones((32, 32))).sum()
    produced = list(tmp_path.rglob("*"))
    assert produced, "profiler trace produced no files"
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    assert device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert stats == {}
