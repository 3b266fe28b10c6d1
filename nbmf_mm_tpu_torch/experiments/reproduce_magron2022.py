"""Reproduce the Magron & Fevotte (2022) experiments on the port (the
counterpart of the repository's ``experiments/reproduce_magron2022.py``).

- **Figure 1** (hyperparameter validation): the 6 x 6 (alpha, beta) grid as
  one :func:`~nbmf_mm_tpu_torch.grid_solve` per dataset, all 36 cells lanes
  of one batched solve.
- **Figure 2** (test perplexity at the best hyperparameters, seed 12345): the
  fit; the paper's 10-init NBMF-MM protocol at the original author's best
  hyperparameters as one ``solve(n_init=10, return_all=True)``; the same
  protocol for the NBMF-EM and logPCA baselines
  (:mod:`nbmf_mm_tpu_torch.models.baselines`); each beside the author's
  stored results.
- **Figure 3**: the rank sweep K in {2, 4, 8, 16}.

The constants are the JAX runner's.  ``--dtype`` follows the port's rule
(``None`` is float32): on the card float32 takes the fused kernel loop, so
all three datasets (binary data under binary masks) run the packed passes.
One CSV per figure and dataset goes to ``--outdir`` with the JAX runner's
columns.

    python -m nbmf_mm_tpu_torch.experiments.reproduce_magron2022 --device cuda
        [--datasets animals lastfm paleo] [--figures 1 2 3] [--outdir DIR]
        [--dtype float32] [--no-baselines]
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np

from .data import (
    DATASETS,
    compute_perplexity,
    load_dataset_and_splits,
    magron_best_val_logpplx,
    magron_test_init,
)

SEED = 12345
N_INIT = 10  # the paper's test protocol: mean +- std over 10 random inits
ALPHA_GRID = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
BETA_GRID = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
FIG1_K = {"animals": 4, "lastfm": 8, "paleo": 4}
FIG2_PARAMS = {
    "animals": {"alpha": 2.0, "beta": 2.0, "k": 4},
    "lastfm": {"alpha": 1.0, "beta": 1.0, "k": 8},
    "paleo": {"alpha": 2.0, "beta": 2.0, "k": 4},
}
# The original author's best hyperparameters [K, alpha, beta] (the
# NBMF-MM_model.npz hyper_params of the reference outputs) and the
# per-method best K (their *_val.npz grids): the 10-init protocols run at
# these to compare with *_test_init.npz.
MAGRON_MM_PARAMS = {
    "animals": {"k": 4, "alpha": 1.6, "beta": 1.0},
    "lastfm": {"k": 4, "alpha": 1.6, "beta": 1.4},
    "paleo": {"k": 4, "alpha": 1.2, "beta": 1.6},
}
BASELINE_K = {
    "NBMF-EM": {"animals": 16, "lastfm": 2, "paleo": 16},
    "logPCA": {"animals": 2, "lastfm": 4, "paleo": 4},
}
# lastfm runs past 1000 sweeps before it converges: headroom, with n_iter
# and converged reported as they are.
FIG2_MAX_ITER = {"animals": 1000, "lastfm": 3000, "paleo": 1000}
FIG3_KS = [2, 4, 8, 16]
FIG3_PARAMS = {
    "animals": {"alpha": 2.0, "beta": 2.0},
    "lastfm": {"alpha": 1.0, "beta": 1.0},
    "paleo": {"alpha": 2.0, "beta": 2.0},
}


def default_outdir() -> Path:
    """``chiprun_out/experiments/`` of the repository."""
    return Path(__file__).resolve().parents[2] / "chiprun_out" / "experiments"


def _obs_nll(Y, P, mask, eps=1e-8):
    """Per-observed-entry Bernoulli NLL (the artifacts' log-perplexity
    units): the log of :func:`compute_perplexity`."""
    return float(np.log(compute_perplexity(Y, P, mask, eps=eps)))


def write_csv(path: Path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"  wrote {path}", flush=True)


def figure1_rows(ds, dtype, device):
    """Figure 1 of one dataset: the 6 x 6 grid as one batched solve, a row
    per cell."""
    from .. import grid_solve

    Y, train_mask, val_mask, _ = load_dataset_and_splits(ds)
    t0 = time.time()
    res = grid_solve(Y, FIG1_K[ds], ALPHA_GRID, BETA_GRID, max_iter=500, tol=1e-5,
                     mask=train_mask, random_state=SEED, dtype=dtype, device=device)
    grid_time = time.time() - t0
    rows = []
    for g in range(len(res["alpha"])):
        Y_hat = res["W"][g].astype(np.float64) @ res["H"][g].astype(np.float64)
        rows.append({
            "alpha": float(res["alpha"][g]),
            "beta": float(res["beta"][g]),
            "train_perplexity": compute_perplexity(Y, Y_hat, train_mask),
            "val_perplexity": compute_perplexity(Y, Y_hat, val_mask),
            "n_iter": int(res["n_iter"][g]),
            "time": grid_time / len(res["alpha"]),
        })
    return rows


def run_figure1(datasets, outdir: Path, dtype, device):
    print("\n=== Figure 1: hyperparameter grid (one batched solve) ===", flush=True)
    out = {}
    for ds in datasets:
        rows = out[ds] = figure1_rows(ds, dtype, device)
        best = min(rows, key=lambda r: r["val_perplexity"])
        print(f"{ds}: {len(rows)} cells in {rows[0]['time'] * len(rows):.2f}s (batched) | "
              f"best a={best['alpha']}, b={best['beta']} "
              f"val_pplx={best['val_perplexity']:.4f}", flush=True)
        write_csv(outdir / f"figure1_{ds}_results.csv", rows)
    return out


def mm_10init_protocol(Y, train_mask, test_mask, ds, dtype, device):
    """The paper's 10-init NBMF-MM test protocol at the original author's
    best hyperparameters as one batched solve (``n_init=10,
    return_all=True``), each restart scored on the test entries, beside
    ``NBMF-MM_test_init.npz``.  ``mm10_test_nlls`` lists the ten."""
    from .. import solve

    p = MAGRON_MM_PARAMS[ds]
    t0 = time.time()
    res = solve(Y, p["k"], alpha=p["alpha"], beta=p["beta"], max_iter=FIG2_MAX_ITER[ds],
                tol=1e-5, mask=train_mask, random_state=SEED, n_init=N_INIT, return_all=True,
                dtype=dtype, device=device)
    batch_time = time.time() - t0
    nlls = np.array([
        _obs_nll(Y, res.extras["all_W"][i].astype(np.float64)
                 @ res.extras["all_H"][i].astype(np.float64), test_mask)
        for i in range(N_INIT)
    ])
    ref = magron_test_init(ds, "NBMF-MM") or {}
    return {
        "mm10_test_nll_mean": float(nlls.mean()),
        "mm10_test_nll_std": float(nlls.std()),
        "mm10_iters_mean": float(np.mean(res.extras["all_n_iter"])),
        "mm10_batch_time": batch_time,
        "magron_mm_test_nll_mean": ref.get("mean", float("nan")),
        "magron_mm_test_nll_std": ref.get("std", float("nan")),
    }, nlls


def baseline_10init_protocol(Y, train_mask, test_mask, ds, dtype, device):
    """The 10-init protocol of the two baselines at the artifacts' per-method
    best K, refit from scratch, beside their stored results."""
    from ..models import NBMFEM, LogisticPCA

    out = {}
    for method, cls, kwargs in [
        ("NBMF-EM", NBMFEM, dict(max_iter=500, tol=1e-5)),
        ("logPCA", LogisticPCA, dict(max_iter=1000, tol=1e-5)),
    ]:
        k = BASELINE_K[method][ds]
        nlls, iters = [], []
        for seed in range(N_INIT):
            m = cls(n_components=k, random_state=seed, dtype=dtype, device=device, **kwargs)
            m.fit(Y, mask=train_mask)
            nlls.append(_obs_nll(Y, m.reconstruction(), test_mask))
            iters.append(m.n_iter_)
        ref = magron_test_init(ds, method) or {}
        tag = method.lower().replace("-", "_")
        out.update({
            f"{tag}_k": k,
            f"{tag}_test_nll_mean": float(np.mean(nlls)),
            f"{tag}_test_nll_std": float(np.std(nlls)),
            f"{tag}_iters_mean": float(np.mean(iters)),
            f"magron_{tag}_test_nll_mean": ref.get("mean", float("nan")),
        })
    return out


def figure2_row(ds, dtype, device, with_baselines=True):
    """Figure 2 of one dataset: the fit at ``FIG2_PARAMS`` and the 10-init
    protocols; returns ``(row, model, nlls)``."""
    from .. import NBMF

    Y, train_mask, _, test_mask = load_dataset_and_splits(ds)
    p = FIG2_PARAMS[ds]
    model = NBMF(n_components=p["k"], alpha=p["alpha"], beta=p["beta"],
                 orientation="beta-dir", max_iter=FIG2_MAX_ITER[ds], tol=1e-5,
                 random_state=SEED, dtype=dtype, device=device)
    t0 = time.time()
    model.fit(Y, mask=train_mask)
    fit_time = time.time() - t0
    Y_hat = model.W_.astype(np.float64) @ model.components_.astype(np.float64)
    magron_nll = magron_best_val_logpplx(ds, p["k"])
    row = {
        "dataset": ds,
        "k": p["k"],
        "alpha": p["alpha"],
        "beta": p["beta"],
        "test_perplexity": compute_perplexity(Y, Y_hat, test_mask),
        "magron_best_val_perplexity": (float(np.exp(magron_nll)) if magron_nll is not None
                                       else float("nan")),
        "n_iter": model.n_iter_,
        "converged": model.converged_,
        "time": fit_time,
    }
    mm, nlls = mm_10init_protocol(Y, train_mask, test_mask, ds, dtype, device)
    row.update(mm)
    if with_baselines:
        row.update(baseline_10init_protocol(Y, train_mask, test_mask, ds, dtype, device))
    return row, model, nlls


def run_figure2(datasets, outdir: Path, dtype, device, with_baselines: bool = True):
    print("\n=== Figure 2: test perplexity at best hyperparameters ===", flush=True)
    rows = []
    for ds in datasets:
        row, model, _ = figure2_row(ds, dtype, device, with_baselines)
        rows.append(row)
        print(f"{ds}: test_pplx={row['test_perplexity']:.4f} "
              f"(magron best-val={row['magron_best_val_perplexity']:.4f}) "
              f"iters={row['n_iter']} converged={row['converged']} time={row['time']:.2f}s",
              flush=True)
        print(f"  10-init MM:  test NLL {row['mm10_test_nll_mean']:.4f}"
              f"+-{row['mm10_test_nll_std']:.4f} (magron {row['magron_mm_test_nll_mean']:.4f}"
              f"+-{row['magron_mm_test_nll_std']:.4f}) iters~{row['mm10_iters_mean']:.0f} "
              f"[one batched solve, {row['mm10_batch_time']:.1f}s]", flush=True)
        if with_baselines:
            print(f"  10-init EM:  test NLL {row['nbmf_em_test_nll_mean']:.4f}"
                  f"+-{row['nbmf_em_test_nll_std']:.4f} "
                  f"(magron {row['magron_nbmf_em_test_nll_mean']:.4f}) "
                  f"| logPCA: {row['logpca_test_nll_mean']:.4f}"
                  f"+-{row['logpca_test_nll_std']:.4f} "
                  f"(magron {row['magron_logpca_test_nll_mean']:.4f})", flush=True)
        outdir.mkdir(parents=True, exist_ok=True)
        np.savez(outdir / f"figure2_{ds}_model.npz", W=model.W_, H=model.components_,
                 loss=np.asarray(model.loss_curve_), n_iter=model.n_iter_)
    write_csv(outdir / "figure2_results.csv", rows)
    return rows


def figure3_rows(ds, dtype, device):
    """Figure 3 of one dataset: a fit per rank of ``FIG3_KS``."""
    from .. import NBMF

    Y, train_mask, _, test_mask = load_dataset_and_splits(ds)
    p = FIG3_PARAMS[ds]
    rows = []
    for k in FIG3_KS:
        model = NBMF(n_components=k, alpha=p["alpha"], beta=p["beta"], orientation="beta-dir",
                     max_iter=1000, tol=1e-5, random_state=SEED, dtype=dtype, device=device)
        t0 = time.time()
        model.fit(Y, mask=train_mask)
        fit_time = time.time() - t0
        Y_hat = model.W_.astype(np.float64) @ model.components_.astype(np.float64)
        rows.append({
            "k": k,
            "alpha": p["alpha"],
            "beta": p["beta"],
            "test_perplexity": compute_perplexity(Y, Y_hat, test_mask),
            "n_iter": model.n_iter_,
            "time": fit_time,
        })
    return rows


def run_figure3(datasets, outdir: Path, dtype, device):
    print("\n=== Figure 3: rank sweep ===", flush=True)
    out = {}
    for ds in datasets:
        rows = out[ds] = figure3_rows(ds, dtype, device)
        for r in rows:
            print(f"{ds} K={r['k']}: test_pplx={r['test_perplexity']:.4f} "
                  f"iters={r['n_iter']} time={r['time']:.2f}s", flush=True)
        write_csv(outdir / f"figure3_{ds}_results.csv", rows)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--datasets", nargs="+", default=list(DATASETS), choices=DATASETS)
    ap.add_argument("--figures", nargs="+", type=int, default=[1, 2, 3], choices=[1, 2, 3])
    ap.add_argument("--outdir", type=Path, default=default_outdir())
    ap.add_argument("--dtype", default=None, help="compute dtype (default: float32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-baselines", action="store_true",
                    help="leave the NBMF-EM and logPCA protocols out of Figure 2")
    args = ap.parse_args(argv)
    args.outdir.mkdir(parents=True, exist_ok=True)
    if 1 in args.figures:
        run_figure1(args.datasets, args.outdir, args.dtype, args.device)
    if 2 in args.figures:
        run_figure2(args.datasets, args.outdir, args.dtype, args.device,
                    with_baselines=not args.no_baselines)
    if 3 in args.figures:
        run_figure3(args.datasets, args.outdir, args.dtype, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
