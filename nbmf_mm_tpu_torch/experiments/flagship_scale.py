"""Flagship-scale solves on one card: packed solves of 10^9 to 10^10
entries to convergence, one CSV row each (the counterpart of the
repository's ``experiments/flagship_scale.py``, with its columns).

- ``headline_1e9`` (10^5 x 10^4, K=128) and the ``--ceiling`` rows
  ``ceiling_4e9`` (4 x 10^5 x 10^4, K=64) and ``ceiling_1e10`` (10^6 x 10^4,
  K=32): the data is drawn on the card from a rank-16 Bernoulli ground truth
  ``W* H*`` (a seeded ``torch.Generator``) in row chunks, each packed as it
  is made (:func:`~nbmf_mm_tpu_torch.pack_matrix_chunked`), so no dense copy
  of the matrix exists anywhere; the ground truth's per-entry NLL of the
  draw (the oracle NLL) is added up chunk by chunk in float64;
- ``sparse_3pct_1e9`` (10^5 x 10^4 at 3%, K=128): a host ``scipy.sparse``
  matrix packed from its structure (:func:`~nbmf_mm_tpu_torch.pack_matrix_sparse`);
  its oracle NLL is the entropy of the density.

Each row runs ``solve(PackedMatrix, device_results=True)`` with the
converging budget (600 sweeps, 800 for 10^10; tol 1e-5) and records
``n_iter`` and whether it converged (a row that did not is written with
``converged=False``, never dropped), the final loss beside the oracle NLL,
the worst descent step, ms/sweep from CUDA events around the solve, the
factor pull timed apart, ``torch.cuda.max_memory_allocated`` over the row
(synthesis included) and the card's name and power limit.

    python -m nbmf_mm_tpu_torch.experiments.flagship_scale --device cuda
        [--ceiling] [--only NAME] [--outdir DIR]
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np

from .benchmark_suite import device_line
from .reproduce_magron2022 import default_outdir

# (name, M, N, K, K_true, max_iter)
CONFIGS = [("headline_1e9", 100_000, 10_000, 128, 16, 600)]
CEILING = [
    ("ceiling_4e9", 400_000, 10_000, 64, 16, 600),
    ("ceiling_1e10", 1_000_000, 10_000, 32, 16, 800),
]
# (name, M, N, K, density, max_iter): scipy.sparse host ingestion.
SPARSE = [("sparse_3pct_1e9", 100_000, 10_000, 128, 0.03, 600)]
# Rows of the ground truth drawn from one generator state: a chunk's draw
# does not depend on how the rows are chunked.
RNG_ROWS = 256
CHUNK_ENTRIES = 1 << 25  # entries of one synthesized chunk
FIELDS = ("config", "M", "N", "K", "entries", "packed_mb", "n_iter", "converged", "final_loss",
          "oracle_nll", "sweeps_per_sec", "ms_per_sweep", "solve_s", "retrieve_s", "gen_pack_s",
          "worst_descent_violation", "peak_hbm_gb", "device")


class GroundTruth:
    """A rank-``K_true`` Bernoulli ground truth ``P* = W* H*`` on ``device``
    (``W*`` rows on the simplex from U(0.05, 1), ``H*`` from U(0.05, 0.95),
    clipped to ``[1e-6, 1 - 1e-6]``), drawn from ``seed``.  :meth:`rows`
    draws ``Y ~ Bernoulli(P*)`` for rows ``[a, b)`` and their log-likelihood
    under ``P*``, in float64; every block of :data:`RNG_ROWS` rows
    has a generator state of its own, so any chunking gives the same
    matrix."""

    def __init__(self, seed: int, M: int, N: int, K_true: int, device):
        import torch

        self.seed, self.M, self.N, self.device = seed, M, N, torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        W = 0.05 + 0.95 * torch.rand((M, K_true), generator=gen, device=self.device)
        self.W = W / W.sum(dim=1, keepdim=True)
        self.H = 0.05 + 0.9 * torch.rand((K_true, N), generator=gen, device=self.device)
        self.gen = torch.Generator(device=self.device)

    def rows(self, a: int, b: int):
        import torch

        first, last = a // RNG_ROWS, -(-b // RNG_ROWS)
        u = []
        for block in range(first, last):
            self.gen.manual_seed(self.seed * 1_000_003 + 1 + block)
            u.append(torch.rand((RNG_ROWS, self.N), generator=self.gen, device=self.device))
        u = torch.cat(u)[a - first * RNG_ROWS: b - first * RNG_ROWS]
        P = torch.clamp(self.W[a:b] @ self.H, 1e-6, 1.0 - 1e-6)
        Y = (u < P).to(torch.float32)
        P = P.double()
        return Y, float(torch.sum(torch.where(Y > 0, torch.log(P), torch.log1p(-P))))


def synth_packed(seed, M, N, K_true, K_solve, device):
    """The ground truth's draw packed chunk by chunk on ``device``: returns
    ``(PackedMatrix, oracle per-entry NLL)``."""
    from .. import pack_matrix_chunked

    truth = GroundTruth(seed, M, N, K_true, device)
    ll_sum = [0.0]

    def row_chunk(a, b):
        Y, ll = truth.rows(a, b)
        ll_sum[0] += ll
        return Y

    pm = pack_matrix_chunked(row_chunk, M, N, K_solve, chunk_rows=max(1, CHUNK_ENTRIES // N),
                             validate=False, device=device)
    return pm, -ll_sum[0] / (M * N)


def _reset_peak(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    import torch

    if torch.device(device).type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**30, 3)


def run_config(name, M, N, K, K_true, max_iter, device, line):
    _reset_peak(device)
    print(f"[{name}] synthesizing {M}x{N} (K_true={K_true}) packed on {device} ...", flush=True)
    t0 = time.perf_counter()
    pm, oracle_nll = synth_packed(0, M, N, K_true, K, device)
    gen_s = time.perf_counter() - t0
    return solve_and_record(name, pm, oracle_nll, gen_s, K, max_iter, device, line)


def run_sparse_config(name, M, N, K, density, max_iter, device, line):
    """A host ``scipy.sparse`` binary matrix at ``density`` packed without a
    dense staging; i.i.d. Bernoulli(density) data, so the oracle per-entry
    NLL is its entropy."""
    import scipy.sparse as sp

    from .. import pack_matrix_sparse

    _reset_peak(device)
    print(f"[{name}] building {M}x{N} csr at {density:.0%} ...", flush=True)
    rng = np.random.default_rng(0)
    nnz = int(density * M * N)
    S = sp.csr_matrix((np.ones(nnz, dtype=np.float32),
                       (rng.integers(0, M, nnz), rng.integers(0, N, nnz))), shape=(M, N))
    S.data[:] = 1.0  # duplicates were summed at construction
    p_eff = S.nnz / (M * N)
    oracle_nll = -(p_eff * np.log(p_eff) + (1 - p_eff) * np.log1p(-p_eff))
    t0 = time.perf_counter()
    pm = pack_matrix_sparse(S, K, device=device)
    ingest_s = time.perf_counter() - t0
    print(f"[{name}] sparse->words {pm.nbytes / 2**20:.0f} MB in {ingest_s:.2f}s "
          f"({M * N / ingest_s / 1e6:.0f} Mentries/s)", flush=True)
    return solve_and_record(name, pm, oracle_nll, ingest_s, K, max_iter, device, line)


def solve_and_record(name, pm, oracle_nll, gen_s, K, max_iter, device, line):
    """One converging ``solve`` of ``pm`` and its CSV row (a dict of
    :data:`FIELDS`)."""
    import torch

    from .. import solve

    M, N = pm.shape
    print(f"[{name}] packed {pm.nbytes / 2**20:.0f} MB in {gen_s:.2f}s (oracle NLL "
          f"{oracle_nll:.5f}); solving K={K} ...", flush=True)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    res = solve(pm, K, max_iter=max_iter, tol=1e-5, random_state=0, alpha=1.2, beta=1.2,
                backend="fused", device_results=True, device=device)
    if on_card:
        end.record()
        torch.cuda.synchronize(device)
        solve_ms = start.elapsed_time(end)
    else:
        solve_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    res.W.cpu().numpy()  # the factor pull, timed apart
    retrieve_s = time.perf_counter() - t0
    losses = res.losses.double().cpu().numpy()
    worst = float(np.max(np.diff(losses))) if len(losses) > 1 else 0.0
    row = dict(
        config=name, M=M, N=N, K=K, entries=M * N, packed_mb=round(pm.nbytes / 2**20, 1),
        n_iter=res.n_iter, converged=res.converged, final_loss=float(losses[-1]),
        oracle_nll=float(oracle_nll), sweeps_per_sec=res.n_iter / (solve_ms / 1e3),
        ms_per_sweep=solve_ms / res.n_iter, solve_s=solve_ms / 1e3, retrieve_s=retrieve_s,
        gen_pack_s=gen_s, worst_descent_violation=f"{worst:.3e}", peak_hbm_gb=_peak_gb(device),
        device=line,
    )
    print(f"[{name}] {row}", flush=True)
    del pm, res
    return row


def run(configs, sparse, device, outdir: Path):
    """Every configuration, rows written to ``outdir/flagship_scale_gpu.csv``
    as they finish; returns the rows."""
    line = device_line(device)
    outdir.mkdir(parents=True, exist_ok=True)
    tag = "gpu" if str(device).startswith("cuda") else "cpu"
    out, rows = outdir / f"flagship_scale_{tag}.csv", []
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FIELDS)
        writer.writeheader()
        for cfg in configs:
            rows.append(run_config(*cfg, device, line))
            writer.writerow(rows[-1])
            f.flush()
        for cfg in sparse:
            rows.append(run_sparse_config(*cfg, device, line))
            writer.writerow(rows[-1])
            f.flush()
    print(f"wrote {out}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ceiling", action="store_true",
                    help="also run the ceiling rows (4e9 and 1e10 entries)")
    ap.add_argument("--only", default=None, help="run a single named configuration")
    ap.add_argument("--outdir", type=Path, default=default_outdir())
    args = ap.parse_args(argv)
    from ..ops import cuda_sweep as cs

    device = str(cs.resolve_device(args.device))
    configs = CONFIGS + (CEILING if args.ceiling else [])
    sparse = SPARSE
    if args.only:
        configs = [c for c in CONFIGS + CEILING if c[0] == args.only]
        sparse = [c for c in SPARSE if c[0] == args.only]
        if not configs and not sparse:
            ap.error(f"no configuration named {args.only!r}")
    rows = run(configs, sparse, device, args.outdir)
    # Finite losses and descent within 5e-4 of the loss: anything else is a
    # failed row (written all the same).
    bad = [r["config"] for r in rows if not np.isfinite(r["final_loss"])
           or float(r["worst_descent_violation"]) > 5e-4 * abs(r["final_loss"])]
    if bad:
        print(f"rows outside the descent bound: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
