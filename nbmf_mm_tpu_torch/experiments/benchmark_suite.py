"""Benchmark suite over the BASELINE.md configurations (the counterpart of
the repository's ``experiments/benchmark_suite.py``): a CSV (and stdout) of
fit quality and time, with the JAX runner's columns.

- the paper's datasets at their Figure 2 configurations (test perplexity,
  sweeps, a first and a second fit's wall time);
- the README quickstart's synthetic configuration (train perplexity);
- the sweep throughput of the fused loop at ``--mn`` x ``--mn``, rank
  ``--k``: CUDA events around runs of ``--sweeps`` and ``3 --sweeps`` sweeps
  of the loop on operands staged once, each run starting from the factors
  the last one returned (loop-carried inputs), reported as the median of
  five slopes.  ``--sweeps`` is clamped to ``[1, MAX_TIMED_SWEEPS]``.

    python -m nbmf_mm_tpu_torch.experiments.benchmark_suite --device cuda
        [--mn 10000] [--k 128] [--sweeps 40] [--outdir DIR]

Every time is the card's (named in the CSV's first line with its power
limit) on ``--device cuda``; with ``--device cpu`` the throughput row is the
host's and is labelled so.
"""

from __future__ import annotations

import argparse
import csv
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np

from .data import compute_perplexity, load_dataset_and_splits
from .reproduce_magron2022 import FIG2_PARAMS, SEED, default_outdir

# The largest timed run of the throughput row, in sweeps (3x --sweeps), so
# that a large --sweeps cannot overflow the loss buffer or run for hours.
MAX_TIMED_SWEEPS = 3000


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or a
    host label for a CPU run."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu (host run: no device time)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def dataset_rows(dtype, device):
    """Each dataset at its Figure 2 configuration: a first fit and a second
    (the kernels already built)."""
    from .. import NBMF

    rows = []
    for ds, p in FIG2_PARAMS.items():
        Y, train_mask, _, test_mask = load_dataset_and_splits(ds)
        model = NBMF(n_components=p["k"], alpha=p["alpha"], beta=p["beta"], max_iter=1000,
                     tol=1e-5, random_state=SEED, dtype=dtype, device=device)
        t0 = time.time()
        model.fit(Y, mask=train_mask)
        wall = time.time() - t0
        t0 = time.time()
        model.fit(Y, mask=train_mask)
        warm = time.time() - t0
        Y_hat = model.W_.astype(np.float64) @ model.components_.astype(np.float64)
        rows.append({
            "config": f"{ds} K={p['k']} a={p['alpha']} b={p['beta']}",
            "test_perplexity": round(compute_perplexity(Y, Y_hat, test_mask), 4),
            "train_perplexity": None,
            "n_iter": model.n_iter_,
            "fit_time_cold_s": round(wall, 3),
            "fit_time_warm_s": round(warm, 3),
            "sweeps_per_sec": None,
        })
        print(rows[-1], flush=True)
    return rows


def quickstart_row(dtype, device):
    """The README quickstart: synthetic binary 100 x 500, K=6, beta-dir; the
    quality metric is the train-set Bernoulli perplexity (no held-out
    split)."""
    from .. import NBMF

    rng = np.random.default_rng(0)
    X = (rng.random((100, 500)) < 0.3).astype(float)
    model = NBMF(n_components=6, random_state=0, dtype=dtype, device=device)
    t0 = time.time()
    model.fit(X)
    wall = time.time() - t0
    Y_hat = model.W_.astype(np.float64) @ model.components_.astype(np.float64)
    row = {
        "config": "synthetic 100x500 K=6 (quickstart)",
        "test_perplexity": None,
        "train_perplexity": round(compute_perplexity(X, Y_hat, np.ones_like(X)), 4),
        "n_iter": model.n_iter_,
        "fit_time_cold_s": round(wall, 3),
        "fit_time_warm_s": None,
        "sweeps_per_sec": None,
    }
    print(row, flush=True)
    return [row]


def loop_slope_ms(mn, k, sweeps, device, reps=5):
    """ms/sweep of the fused loop at ``mn x mn`` (density 0.3, seed 0), rank
    ``k``, float32, packed: the median over ``reps`` of ``(t(3s) - t(s)) /
    2s`` for ``s = sweeps`` (clamped), each run from the factors the run
    before it returned; CUDA events on the card, the host clock on the CPU."""
    import torch

    from ..ops import cuda_sweep as cs
    from ..solver.driver import _pad_last, _solve_core_fused

    lo = int(np.clip(sweeps, 1, MAX_TIMED_SWEEPS // 3))
    hi = 3 * lo
    rng = np.random.default_rng(0)
    Y = torch.as_tensor((rng.random((mn, mn)) < 0.3).astype(np.float32), device=device)
    bm, Mp, Np = cs.plan_packing(mn, mn)
    words = cs.pack_bits(torch.nn.functional.pad(Y, (0, Np - mn, 0, Mp - mn)), bm)
    del Y
    gen = torch.Generator().manual_seed(0)
    W = torch.rand((k, mn), generator=gen) * 0.8 + 0.1
    W = _pad_last(W / W.sum(dim=0, keepdim=True), Mp).to(device)
    H = _pad_last(torch.rand((k, mn), generator=gen) * 0.8 + 0.1, Np).to(device)
    kw = dict(packed=True, eps=1e-8, m_real=mn, n_real=mn, bm=bm, projection="normalize",
              verbose=0)
    on_card = torch.device(device).type == "cuda"
    state = [W, H]

    def run(n):
        if on_card:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = _solve_core_fused(words, None, None, *state, 1.2, 1.2, 0.0, float(mn * mn),
                                max_iter=n, **kw)
        state[:] = out[:2]  # the next run starts where this one ended
        if on_card:
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)
        return 1e3 * (time.perf_counter() - t0)

    run(lo)  # builds the kernels on first use
    slopes = [(run(hi) - run(lo)) / (hi - lo) for _ in range(reps)]
    return statistics.median(slopes), hi


def throughput_row(mn, k, sweeps, device):
    ms, hi = loop_slope_ms(mn, k, sweeps, device)
    print(f"throughput: {1e3 / ms:.2f} sweeps/s ({ms:.3f} ms/sweep) on {device}", flush=True)
    return [{
        "config": f"throughput {mn}x{mn} K={k} f32",
        "test_perplexity": None,
        "train_perplexity": None,
        "n_iter": hi,
        "fit_time_cold_s": round(ms / 1e3, 6),  # s/sweep
        "fit_time_warm_s": None,
        "sweeps_per_sec": round(1e3 / ms, 2),
    }]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, help="compute dtype of the fits (default: float32)")
    ap.add_argument("--mn", type=int, default=10000)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--outdir", type=Path, default=default_outdir())
    args = ap.parse_args(argv)
    from ..ops import cuda_sweep as cs

    device = str(cs.resolve_device(args.device))
    line = device_line(device)
    rows = (dataset_rows(args.dtype, device) + quickstart_row(args.dtype, device)
            + throughput_row(args.mn, args.k, args.sweeps, device))
    args.outdir.mkdir(parents=True, exist_ok=True)
    out = args.outdir / f"benchmark_suite_{'gpu' if device.startswith('cuda') else 'cpu'}.csv"
    with open(out, "w", newline="") as f:
        f.write(f"# provenance: nbmf_mm_tpu_torch.experiments.benchmark_suite on {line}\n")
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {out} [{line}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
