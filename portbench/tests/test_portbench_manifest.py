"""BENCHMARK.json against the benchmark's contract, and every piece a cell
names found by name."""

import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_size(bench):
    assert set(bench) == TOP_KEYS
    assert manifest.MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(_text(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p


def test_run_seconds_fits_the_check_budget(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        with open(manifest.ROOT / c["file"]) as fh:
            conf = json.load(fh)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_workloads(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(pairs) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _text(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert callable(manifest.reader(m["name"]))
        layers.add(m["layer"])
    for cell in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        assert sum(cell in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


@pytest.mark.parametrize("workload", ["flagship_fit", "headline_restarts16", "flagship_soft",
                                      "flagship_masked"])
def test_cell_pieces_found_by_name(workload):
    cell = manifest.load_cell(workload)
    assert cell.chips == 1 and cell.traffic["tol"] == 0.0
    assert set(cell.limits) == {"fit_gap", "h_gap"}
    with open(manifest.HERE / "limits" / f"{workload}.json") as fh:
        readings = json.load(fh)["readings"]
    for name, limit in cell.limits.items():  # between the two readings, more room above the lower
        lower, upper = readings[name]["lower"], readings[name]["upper"]
        assert upper >= 3 * lower and lower < limit < upper
        assert limit / lower > upper / limit
    for fault in readings["faults_least"].values():  # each fault read on the card fails a number
        assert any(fault[name] > limit for name, limit in cell.limits.items())


def test_masked_traffic_is_the_issued_mix():
    cell = manifest.load_cell("flagship_masked")
    assert cell.traffic == {"name": "fits_masked_corrected_fp32", "loop": "closed",
                            "input": "dense_masked", "observed": 0.7, "mask_mode": "corrected",
                            "n_init": 1, "sweeps": 100, "tol": 0.0, "precision": "highest",
                            "warmup_sweeps": 10}
    assert cell.config == manifest.load_cell("flagship_fit").config
    for name in ("flagship_fit", "headline_restarts16", "flagship_soft"):
        assert "mask_mode" not in manifest.load_cell(name).traffic


def test_every_per_layer_metric_reads_every_cell(bench):
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["workloads"] == cells, m["name"]
