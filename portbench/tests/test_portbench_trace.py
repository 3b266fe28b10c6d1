"""The reduction of a profiler trace to the record the metrics read, on a
trace made by hand (times in microseconds, as Chrome traces give them)."""

import pytest

from portbench import tracing


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = [
    X("user_annotation", tracing.WINDOW, 1000, 1000),
    X("user_annotation", tracing.FIT, 1000, 500),
    X("user_annotation", tracing.FIT, 1500, 500),
    X("cpu_op", "aten::uniform_", 1000, 100),
    X("cuda_runtime", "cudaMemcpyAsync", 1100, 10),
    X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1105, 20),
    X("cuda_runtime", "cudaLaunchKernel", 1120, 5),
    X("kernel", "hpass_kernel<8, false>", 1130, 200),
    X("kernel", "wpass_kernel", 1300, 150),  # overlaps the last: counted once
    X("cuda_runtime", "cudaLaunchKernel", 1290, 5),
    X("cuda_runtime", "cudaStreamSynchronize", 1460, 30),
    X("cpu_op", "aten::add", 1500, 300),
    X("cuda_runtime", "cudaLaunchKernel", 1800, 5),
    X("kernel", "hpass_kernel<8, false>", 1810, 190),
    X("gpu_user_annotation", tracing.WINDOW, 1000, 1000),  # not device work
    X("kernel", "outside", 2500, 10),  # after the window
]


def test_reduce():
    rec = tracing.reduce(TRACE)
    assert rec["window_s"] == pytest.approx(1e-3)
    assert rec["busy_s"] == pytest.approx((20 + 320 + 190) / 1e6)
    assert rec["kernel_busy_s"] == pytest.approx((320 + 190) / 1e6)
    assert rec["launches"] == 3 and rec["syncs"] == 1
    assert rec["fit_start_ms"] == pytest.approx([0.130, 0.310])
    ops = dict(rec["breakdown"]["device_ops"])
    assert ops["hpass_kernel_8__false_"] == pytest.approx(390 / 1e6)
    gaps = dict(rec["breakdown"]["idle_gaps"])
    assert gaps["aten::uniform_"] == pytest.approx(105 / 1e6)  # 1000..1105
    assert gaps["aten::add"] == pytest.approx((1810 - 1450) / 1e6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - rec["busy_s"])
    assert rec["spans"] == {}  # no span of the program in this trace


def test_reduce_keeps_the_programs_spans():
    stage = X("user_annotation", "nbmf_mm.stage", 1000, 100)
    rec = tracing.reduce([*TRACE, stage])
    assert rec["spans"] == {"nbmf_mm.stage": {"count": 1, "host_s": pytest.approx(1e-4),
                                              "idle_s": pytest.approx(1e-4)}}


def test_no_window_no_record():
    assert tracing.reduce(TRACE[1:]) == {}
