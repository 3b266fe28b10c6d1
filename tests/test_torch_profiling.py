"""The port's profiling hooks (counterpart of the JAX package's profiling
tests in ``tests/test_profiling_and_debug.py``): on the CPU the timer uses
the host clock, the trace records host activity, and there are no device
memory stats.  The solver's ``nbmf_mm.*`` spans are read back from the
trace: one of each layer a fit, in order and nested, one sweep span a
sweep, each blocking host read in the layer that makes it, and nothing
entered or changed while no profiler records."""

import json

import numpy as np
import pytest
import torch

from nbmf_mm_tpu_torch import solve
from nbmf_mm_tpu_torch.utils import device_memory_stats, sweep_timer, trace
from nbmf_mm_tpu_torch.utils.profiling import span

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


# --- The solver's spans, read back from the trace that ``trace`` writes ---

LAYERS = ("nbmf_mm.solve", "nbmf_mm.stage", "nbmf_mm.init_draw", "nbmf_mm.init_copy",
          "nbmf_mm.operands", "nbmf_mm.loop", "nbmf_mm.finish")
PARENT = {"nbmf_mm.stage": "nbmf_mm.solve", "nbmf_mm.init_draw": "nbmf_mm.stage",
          "nbmf_mm.init_copy": "nbmf_mm.stage", "nbmf_mm.operands": "nbmf_mm.stage",
          "nbmf_mm.loop": "nbmf_mm.solve", "nbmf_mm.finish": "nbmf_mm.solve"}
SWEEPS = 6
# Host reads of the stopping flag in a fit that runs out its sweeps, by each
# loop's own rule: the plain loop reads after sweep ``it`` once ``it > 1``,
# the fused loop at counter ``it`` once ``it >= 2``.
STOP_READS = {"plain": sum(it > 1 for it in range(1, SWEEPS + 1)),
              "fused": sum(it >= 2 for it in range(SWEEPS))}
# (backend, masked): where each wait span sits, and how often.
WAITS = {
    ("fused", False): {"nbmf_mm.wait.binary_scan": ("nbmf_mm.operands", 1)},
    ("plain", False): {},
    ("fused", True): {"nbmf_mm.wait.binary_scan": ("nbmf_mm.operands", 2),
                      "nbmf_mm.wait.n_obs": ("nbmf_mm.stage", 1)},
}


def _data(masked: bool):
    rng = np.random.default_rng(7)
    Y = (rng.random((24, 16)) < 0.4).astype(np.float64)
    mask = (rng.random((24, 16)) < 0.8).astype(np.float64) if masked else None
    return Y, mask


def _fit(backend: str, masked: bool = False, **kw):
    Y, mask = _data(masked)
    return solve(Y, 3, max_iter=SWEEPS, tol=0.0, random_state=0, mask=mask, backend=backend,
                 device="cpu", **kw)


def _traced(log_dir, backend: str, masked: bool = False, **kw):
    """A fit under ``trace`` and its ``nbmf_mm.*`` spans, in start order."""
    with trace(str(log_dir)):
        result = _fit(backend, masked, **kw)
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("nbmf_mm.")), key=lambda e: e["ts"])
    return result, spans


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.fixture(scope="module", params=sorted(WAITS), ids=lambda p: f"{p[0]}-mask{int(p[1])}")
def traced_fit(request, tmp_path_factory):
    backend, masked = request.param
    result, spans = _traced(tmp_path_factory.mktemp("trace"), backend, masked)
    return backend, masked, result, spans


def test_layer_spans_nest_in_order(traced_fit):
    _, _, _, spans = traced_fit
    one = {}
    for name in LAYERS:
        found = _named(spans, name)
        assert len(found) == 1, (name, len(found))
        one[name] = found[0]
    for child, parent in PARENT.items():
        assert _inside(one[child], one[parent]), (child, parent)
    starts = [one[name]["ts"] for name in LAYERS]
    assert starts == sorted(starts)
    end = lambda s: s["ts"] + s["dur"]
    assert end(one["nbmf_mm.init_draw"]) <= one["nbmf_mm.init_copy"]["ts"]
    assert end(one["nbmf_mm.init_copy"]) <= one["nbmf_mm.operands"]["ts"]
    assert end(one["nbmf_mm.stage"]) <= one["nbmf_mm.loop"]["ts"]
    assert end(one["nbmf_mm.loop"]) <= one["nbmf_mm.finish"]["ts"]


def test_one_sweep_span_a_sweep_and_stop_reads_by_the_loops_rule(traced_fit):
    backend, _, result, spans = traced_fit
    assert result.n_iter == SWEEPS
    (loop,) = _named(spans, "nbmf_mm.loop")
    sweeps = _named(spans, "nbmf_mm.sweep")
    assert len(sweeps) == SWEEPS and all(_inside(s, loop) for s in sweeps)
    reads = _named(spans, "nbmf_mm.wait.stop_flag")
    assert len(reads) == STOP_READS[backend]
    assert all(any(_inside(r, s) for s in sweeps) for r in reads)


def test_wait_spans_sit_in_their_layer(traced_fit):
    backend, masked, _, spans = traced_fit
    expected = {"nbmf_mm.wait.result": ("nbmf_mm.loop", 1),
                "nbmf_mm.wait.drift": ("nbmf_mm.finish", 1),
                "nbmf_mm.wait.stop_flag": ("nbmf_mm.loop", STOP_READS[backend]),
                **WAITS[backend, masked]}
    waits = {s["name"] for s in spans if s["name"].startswith("nbmf_mm.wait.")}
    assert waits == set(expected)
    for name, (layer, count) in expected.items():
        found = _named(spans, name)
        (outer,) = _named(spans, layer)
        assert len(found) == count and all(_inside(w, outer) for w in found), name


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_restarts_select_once_after_the_loop(tmp_path, backend):
    result, spans = _traced(tmp_path, backend, n_init=3)
    assert result.all_final_losses.shape == (3,)
    (solve_span,) = _named(spans, "nbmf_mm.solve")
    (loop,) = _named(spans, "nbmf_mm.loop")
    (select,) = _named(spans, "nbmf_mm.select")
    (argmin,) = _named(spans, "nbmf_mm.wait.argmin")
    (read,) = _named(spans, "nbmf_mm.wait.result")
    assert _inside(select, solve_span) and _inside(argmin, select)
    assert loop["ts"] + loop["dur"] <= select["ts"]
    assert select["ts"] + select["dur"] <= read["ts"] and _inside(read, solve_span)
    assert len(_named(spans, "nbmf_mm.sweep")) == SWEEPS


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_span_enters_nothing_without_a_profiler(monkeypatch, backend):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("nbmf_mm.a") is span("nbmf_mm.b")
    result = _fit(backend, n_init=2)
    assert result.n_iter == SWEEPS and result.best_restart in (0, 1)


def test_results_are_bitwise_with_the_profiler_on_and_off(traced_fit):
    backend, masked, traced, _ = traced_fit
    plain = _fit(backend, masked)
    np.testing.assert_array_equal(traced.W, plain.W)
    np.testing.assert_array_equal(traced.H, plain.H)
    assert traced.losses == plain.losses
