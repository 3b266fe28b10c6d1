"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's data on the device from the seed, hands it to the
program in the traffic's input form (packed once by the program's
``pack_matrix_chunked``; a dense float32 tensor of soft labels; or, for
matrix completion, the binary matrix and a training mask as uint8, both
handed to every fit, which stages them itself) and warms up with one short
fit of the same shapes.  The window then runs fits back to back, one
caller, each ``solve(..., max_iter=sweeps, tol=0, device_results=True,
random_state=seed + i)``: fixed work from fresh inits.
The fit that is running when the window's seconds are up is finished and
counted, and the window ends in ``torch.cuda.synchronize()``.

One fit of the window, drawn from the seed, is copied to host memory as it
is drawn, so that the peak holds none of it, and is checked once the window
has closed, the peak memory has been read and the program's data is freed:
the plain reference (:mod:`portbench.reference`) fits again from data made
anew from the seed and from its own draw of the inits, and
:mod:`portbench.compare` holds the kept fit to it.
"""

from __future__ import annotations

import gc
import subprocess
import time
from contextlib import nullcontext

import numpy as np
import torch
from nbmf_mm_tpu_torch import pack_matrix_chunked, solve

from . import compare, data, reference, tracing
from .manifest import Cell, reader

WARMUP_SEED_OFFSET = 1 << 40  # the warm-up fit's inits, apart from every window fit's
SMI_QUERY = "name,clocks.sm,power.draw,power.limit,temperature.gpu"


def device_state(device: torch.device) -> str:
    """The card's name, SM clock, power draw, power limit and temperature as
    ``nvidia-smi`` prints them."""
    if device.type != "cuda":
        return "no card"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader",
                          "-i", str(device.index or 0)],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_input(cell: Cell, recipe: data.Recipe, device: torch.device):
    """The cell's data in the traffic's input form."""
    form = cell.traffic["input"]
    if form == "packed":
        c = cell.config
        return pack_matrix_chunked(recipe.binary_rows, c["m"], c["n"], c["k"],
                                   chunk_rows=recipe.chunk_rows(), validate=False, device=device)
    if form == "soft_dense":
        return recipe.soft()
    if form == "dense_masked":
        return recipe.binary(), recipe.mask(cell.traffic["observed"])
    raise ValueError(f"unknown traffic input {form!r}")


def fit(cell: Cell, X, *, random_state: int, sweeps: int, precision: str, device):
    """One fit of the timed path; a traffic that names a ``mask_mode`` hands
    ``X = (Y, mask)`` over as the user of matrix completion does."""
    c, t = cell.config, cell.traffic
    masked = {}
    if "mask_mode" in t:
        X, mask = X
        masked = {"mask": mask, "mask_mode": t["mask_mode"]}
    return solve(X, c["k"], max_iter=sweeps, tol=t["tol"], alpha=c["alpha"], beta=c["beta"],
                 eps=c["eps"], random_state=random_state, n_init=t["n_init"],
                 precision=None if precision == "highest" else precision, backend="fused",
                 device_results=True, device=device, **masked)


def kept(result, random_state: int) -> dict:
    """What the check reads of a fit, in host memory."""
    return {"random_state": random_state, "W": result.W.cpu(), "H": result.H.cpu(),
            "losses": result.losses.cpu(), "best": result.best_restart,
            "all_final": result.all_final_losses}


def reference_rows(cell: Cell, recipe: data.Recipe):
    """The data as the reference reads it, made anew from the seed: float32
    rows of a uint8 binary matrix or of the soft labels, or ``(y, mask)``
    pairs of float32 rows where the traffic has a training mask."""
    if cell.traffic["input"] == "packed":
        Y = recipe.binary()
        return lambda a, b: Y[a:b].to(torch.float32)
    if cell.traffic["input"] == "dense_masked":
        Y, M = recipe.binary(), recipe.mask(cell.traffic["observed"])
        return lambda a, b: (Y[a:b].to(torch.float32), M[a:b].to(torch.float32))
    Y = recipe.soft()
    return lambda a, b: Y[a:b]


def reference_fit(cell: Cell, seed: int, random_state: int, device: torch.device):
    """The plain reference's ``(W, H, losses)`` of the fit ``random_state``
    on the data of ``seed``, every lane."""
    c = cell.config
    with data.ieee_fp32():
        rows = reference_rows(cell, data.Recipe(c, seed, device))
        W0, H0 = reference.initial_factors(random_state, cell.lanes, c["m"], c["n"], c["k"])
        return reference.Fit(rows, c["m"], c["n"], alpha=c["alpha"], beta=c["beta"],
                             eps=c["eps"], device=device,
                             mask_mode=cell.traffic.get("mask_mode")).run(
                                 W0, H0, cell.traffic["sweeps"])


def check(cell: Cell, seed: int, sample: dict, device: torch.device):
    """``(correct, checks)`` of a kept fit against the plain reference."""
    ref = reference_fit(cell, seed, sample["random_state"], device)
    sample = {k: v.to(device) if torch.is_tensor(v) else v for k, v in sample.items()}
    return compare.verdict(compare.gaps(sample, ref, cell.limits), cell.limits)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
        precision=None, t0=None) -> dict:
    """One run; returns the result line's fields and what the run printed
    about the card (``states``) and the check (``checks``).  ``precision``
    defaults to the traffic's."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    tier = precision or cell.traffic["precision"]
    sweeps = int(cell.traffic["sweeps"])

    parts = {"import": time.perf_counter() - t0}
    with data.ieee_fp32():
        X = program_input(cell, data.Recipe(cell.config, seed, device), device)
    _sync(device)
    parts["data"] = time.perf_counter() - t0 - parts["import"]
    warm = fit(cell, X, random_state=seed + WARMUP_SEED_OFFSET,
               sweeps=int(cell.traffic["warmup_sweeps"]), precision=tier, device=device)
    del warm
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    parts["warm-up"] = setup_s - parts["data"] - parts["import"]

    states = [device_state(device)]
    draw = np.random.default_rng(seed)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    fits, sample = 0, None
    span = torch.profiler.record_function if trace else (lambda name: nullcontext())
    prof = tracing.profile() if trace else nullcontext()
    with prof:
        with span(tracing.WINDOW):
            start = time.perf_counter()
            while True:
                with span(tracing.FIT):
                    res = fit(cell, X, random_state=seed + fits, sweeps=sweeps,
                              precision=tier, device=device)
                bad += ~torch.isfinite(res.losses).all()
                if draw.integers(fits + 1) == 0:  # one fit of the window, uniformly
                    sample = kept(res, seed + fits)
                del res
                fits += 1
                if time.perf_counter() - start >= seconds:
                    break
            _sync(device)
            window_s = time.perf_counter() - start
    states.append(device_state(device))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int(bad)

    metrics, extra = {}, {}
    if trace:
        rec = tracing.reduce(tracing.events(prof))
        rec.update(fits=fits, sweeps=fits * sweeps, m=cell.config["m"], n=cell.config["n"],
                   k=cell.config["k"], lanes=cell.lanes, precision=tier,
                   input=cell.traffic["input"])
        for m in cell.per_layer:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": rec.get("busy_s", 0.0), "window_s": rec.get("window_s", window_s)}
        breakdown = rec.get("breakdown")
    else:
        measured = {
            "setup_s": setup_s,
            "gentry_sweeps_per_s": cell.entries * cell.lanes * sweeps * fits / window_s / 1e9,
            "peak_device_mb": peak / 1e6,
        }
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None

    del X, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = check(cell, seed, sample, device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {
        "correct": bool(correct and failed == 0),
        "attempted": fits,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak), **extra},
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return {"result": out, "states": states, "window_s": window_s, "setup_parts": parts,
            "lane": sample["best"], "random_state": sample["random_state"]}
