"""The program's spans in a traced run: the reduction of a trace made by
hand (times in microseconds), the six readings, and a traced run of the
harness on the CPU at a tiny size, where the spans' counts follow the
traffic."""

import pytest

from portbench import harness, spans, tracing
from portbench.tests.cells import tiny_cell


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def note(name, ts, dur):
    return X("user_annotation", name, ts, dur)


# A window of 1000 us holding one fit of two sweeps and one of a restart
# selection.  Device work: 1100-1200, 1250-1400, 1450-1600, 1700-1800.
DEVICE = [
    X("kernel", "hpass_kernel", 1100, 100),
    X("kernel", "wpass_kernel", 1250, 100),
    X("gpu_memcpy", "Memcpy DtoH", 1300, 100),  # overlaps the last: counted once
    X("kernel", "hpass_kernel", 1450, 150),
    X("kernel", "wpass_kernel", 1700, 100),
    X("kernel", "outside", 2500, 10),  # after the window
]
PROGRAM = [
    note("nbmf_mm.solve", 1000, 950),
    note("nbmf_mm.stage", 1000, 200),          # idle 1000-1100
    note("nbmf_mm.init_draw", 1010, 80),       # idle throughout
    note("nbmf_mm.loop", 1200, 600),           # idle 1200-1250, 1400-1450, 1600-1700
    note("nbmf_mm.sweep", 1200, 250),
    note("nbmf_mm.wait.stop_flag", 1400, 40),  # idle throughout
    note("nbmf_mm.sweep", 1450, 350),
    note("nbmf_mm.select", 1800, 100),         # idle throughout
    note("nbmf_mm.wait.argmin", 1810, 20),
    note("nbmf_mm.finish", 1900, 200),         # clipped at the window's end: idle 100
    note("nbmf_mm.stage", 2100, 100),          # after the window
]
TRACE = [note(tracing.WINDOW, 1000, 1000), note(tracing.FIT, 1000, 1000),
         X("gpu_user_annotation", "nbmf_mm.loop", 1200, 600),  # not a host span
         *DEVICE, *PROGRAM]


def test_table_counts_and_idle_inside_each_name():
    tab = spans.table(TRACE)
    assert set(tab) == {"nbmf_mm.solve", "nbmf_mm.stage", "nbmf_mm.init_draw", "nbmf_mm.loop",
                        "nbmf_mm.sweep", "nbmf_mm.wait.stop_flag", "nbmf_mm.select",
                        "nbmf_mm.wait.argmin", "nbmf_mm.finish"}
    expect = {  # count, host us, idle us
        "nbmf_mm.solve": (1, 950, 100 + 50 + 50 + 100 + 150),
        "nbmf_mm.stage": (1, 200, 100),
        "nbmf_mm.init_draw": (1, 80, 80),
        "nbmf_mm.loop": (1, 600, 50 + 50 + 100),
        "nbmf_mm.sweep": (2, 600, 50 + 50 + 100),
        "nbmf_mm.wait.stop_flag": (1, 40, 40),
        "nbmf_mm.select": (1, 100, 100),
        "nbmf_mm.wait.argmin": (1, 20, 20),
        "nbmf_mm.finish": (1, 200, 100),
    }
    for name, (count, host_us, idle_us) in expect.items():
        assert tab[name]["count"] == count, name
        assert tab[name]["host_s"] == pytest.approx(host_us / 1e6), name
        assert tab[name]["idle_s"] == pytest.approx(idle_us / 1e6), name


def test_no_window_no_table():
    assert spans.table(TRACE[1:]) == {}


NAMES = ("staging_ms.fit", "init_draw_ms.fit", "staging_idle_pct.fit", "loop_idle_pct.fit",
         "stop_reads_per_sweep.fit", "select_idle_ms.fit")


@pytest.mark.parametrize("name, value", [
    ("staging_ms.fit", 0.2),
    ("init_draw_ms.fit", 0.08),
    ("staging_idle_pct.fit", 10.0),
    ("loop_idle_pct.fit", 20.0),
    ("stop_reads_per_sweep.fit", 0.5),
    ("select_idle_ms.fit", 0.1),
])
def test_each_reading_on_the_hand_made_trace(name, value):
    assert spans.readings(spans.table(TRACE), 1e-3)[name] == pytest.approx(value)


def test_no_program_spans_no_readings():
    """A trace of a program without the spans, as the parent commit's."""
    bare = [e for e in TRACE if not e["name"].startswith(spans.PREFIX)]
    assert spans.table(bare) == {}
    assert spans.readings(spans.table(bare), 1e-3) == dict.fromkeys(NAMES)
    assert spans.readings({}, None) == dict.fromkeys(NAMES)


@pytest.mark.parametrize("workload", ["flagship_fit", "headline_restarts16", "flagship_masked"])
def test_traced_run_has_the_spans_of_every_fit(workload):
    cell, reduce = tiny_cell(workload), tracing.reduce
    with spans.keeping_spans() as kept:
        out = harness.run(cell, 5, 0.05, True, device="cpu")
    assert out["result"]["correct"]
    assert tracing.reduce is reduce and len(kept) == 1
    fits, sweeps = out["result"]["attempted"], cell.traffic["sweeps"]
    tab = kept[0]["spans"]
    for name in ("solve", "stage", "init_draw", "init_copy", "operands", "loop", "finish"):
        assert tab[spans.PREFIX + name]["count"] == fits, name
    assert tab["nbmf_mm.sweep"]["count"] == fits * sweeps
    assert tab["nbmf_mm.wait.stop_flag"]["count"] == fits * (sweeps - 2)
    assert ("nbmf_mm.select" in tab) == (cell.lanes > 1)
    read = spans.readings(tab, kept[0]["window_s"])
    assert read["stop_reads_per_sweep.fit"] == pytest.approx((sweeps - 2) / sweeps)
    assert read["init_draw_ms.fit"] <= read["staging_ms.fit"]
    assert (read["select_idle_ms.fit"] is None) == (cell.lanes == 1)
    masked = "mask_mode" in cell.traffic
    assert ("nbmf_mm.wait.n_obs" in tab) == masked
    assert tab.get("nbmf_mm.wait.binary_scan", {}).get("count", 0) == 2 * fits * masked
    assert out["result"]["metrics"]["staging_ms.fit"]["value"] == pytest.approx(
        read["staging_ms.fit"])
