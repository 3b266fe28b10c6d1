"""The rank-256 restarts cell's pieces, and the per-pass shares
(``portbench.passes``) on records made by hand."""

import hashlib

import pytest
import torch

from portbench import harness, manifest, passes, roofline, tracing

CELL = "headline_k256_restarts16"
SHARES = ("hpass_roofline_pct.fit", "wpass_roofline_pct.fit")


def test_cell_pieces_found_by_name(bench):
    cell = manifest.load_cell(CELL)
    assert (cell.config["m"], cell.config["n"], cell.config["k"]) == (10_000, 10_000, 256)
    assert cell.config["reduced"] == ["m", "n"]
    assert cell.config["published"] == {"m": 1_000_000, "n": 100_000, "k": 256, "n_init": 16,
                                        "chips": 8}
    assert cell.config["data"] == {"kind": "bernoulli", "density": 0.3}
    assert cell.traffic == manifest.load_cell("headline_restarts16").traffic
    assert cell.lanes == 16 and cell.chips == 1
    assert set(cell.limits) == {"fit_gap", "h_gap"}
    assert [m["name"] for m in cell.per_layer] == [m["name"] for m in bench["per_layer"]]
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in bench["end_to_end"]]


# sha256 of the reference's (W, H, losses) bytes on the cell at 96 x 64, k
# kept at 256, 16 lanes, 10 sweeps; seed 2**31 + 101, fit 2**31 + 104.
PINNED = "b501f93ec33f8a12b6aa3548d21eabad6c23b77cc17b12807aed091ab9bf756b"


def test_reference_at_rank_256_is_bitwise_as_pinned():
    cell = manifest.load_cell(CELL)
    cell.config = dict(cell.config, m=96, n=64)
    cell.traffic = dict(cell.traffic, sweeps=10)
    seed = 2**31 + 101
    out = harness.reference_fit(cell, seed, seed + 3, torch.device("cpu"))
    assert [tuple(t.shape) for t in out] == [(16, 96, 256), (16, 256, 64), (16, 10)]
    digest = hashlib.sha256()
    for t in out:
        digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == PINNED


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.manifest()["workloads"]])
def test_pass_times_add_up_to_the_sweep(workload):
    cell = manifest.load_cell(workload)
    shape = (cell.config["m"], cell.config["n"], cell.config["k"], cell.lanes,
             cell.traffic["precision"], cell.traffic["input"])
    assert passes.h_seconds(*shape) + passes.w_seconds(*shape) == roofline.sweep_seconds(*shape)
    assert passes.h_seconds(*shape) >= passes.w_seconds(*shape) > 0  # equal where ops bound them


OPS = [  # [name, seconds] as tracing.reduce shortens and orders them
    ["void__anonymous_namespace_::hpass_kernel_16__false__int__true__t", 20.0],
    ["void__anonymous_namespace_::wpass_kernel_16__false__int___anonym", 16.0],
    ["_anonymous_namespace_::sum_splits_kernel_float_const___float_con", 0.4],
    ["_anonymous_namespace_::sum_parts_kernel_float_const___float___in", 0.2],
    ["void__anonymous_namespace_::bitplane_w_kernel_false__float_const", 0.1],
    ["_anonymous_namespace_::sum_ll_kernel_double_const___int__float__", 0.05],
    ["Memcpy_HtoD__Pageable_-__Device_", 0.3],
]
LANES_K256 = dict(m=10_000, n=10_000, k=256, lanes=16, precision="highest", input="packed")


def _record(ops=OPS, h=202, w=200):
    spans = {"nbmf_mm.hpass": {"count": h, "host_s": 1.0, "idle_s": 0.0},
             "nbmf_mm.wpass": {"count": w, "host_s": 1.0, "idle_s": 0.0}}
    return dict(LANES_K256, spans=spans, breakdown={"device_ops": ops, "idle_gaps": []},
                sweeps=200, fits=2, window_s=40.0)


def test_shares_on_a_record():
    least = passes.h_seconds(*LANES_K256.values())
    assert least == pytest.approx(6 * 1e8 * 256 * 16 / 67e12)  # bound by operations
    rec = _record()
    assert manifest.reader(SHARES[0])(rec) == pytest.approx(100 * 202 * least / 20.55)
    assert manifest.reader(SHARES[1])(rec) == pytest.approx(
        100 * 200 * passes.w_seconds(*LANES_K256.values()) / 16.2)


@pytest.mark.parametrize("name", SHARES)
def test_shares_need_the_span_and_the_main_kernel(name):
    read = manifest.reader(name)
    assert read({}) is None
    assert read(dict(_record(), spans={})) is None  # a program without the pass spans
    assert read(dict(_record(), breakdown={"device_ops": [], "idle_gaps": []})) is None
    main = OPS[0] if name.startswith("h") else OPS[1]
    assert read(_record([op for op in OPS if op is not main])) is None


@pytest.mark.parametrize("name", SHARES)
@pytest.mark.parametrize("seconds", [0.01, 0.06])
def test_a_kernel_not_named_cannot_raise_a_share(name, seconds):
    """Seven kernels of ``seconds`` each added: at 0.06 s they push
    ``sum_ll_kernel`` (0.05 s) off the full list."""
    read = manifest.reader(name)
    added = [["void_other_kernel_%d" % i, seconds] for i in range(7)]
    ops = sorted(OPS + added, key=lambda op: -op[1])[:tracing.TOP]
    assert len(ops) == tracing.TOP
    assert any("sum_ll_kernel" in op for op, _ in ops) == (seconds < 0.05)
    assert read(_record(ops)) <= read(_record())


def test_shares_stay_under_100_when_the_kernels_take_the_least_time():
    h = passes.h_seconds(*LANES_K256.values()) * 202
    ops = [["void__anonymous_namespace_::hpass_kernel_16_", h],
           ["void__anonymous_namespace_::wpass_kernel_16_", 1.0]]
    assert manifest.reader(SHARES[0])(_record(ops)) == pytest.approx(100.0)
