"""Dataset and split loading for the Magron & Fevotte (2022) reproduction
(a copy of the repository's ``experiments/data.py`` that reads ``.rda``
files with :mod:`nbmf_mm_tpu_torch.utils.rdata`).

- ``data/<name>.npz`` is read when present, else ``<name>.rda`` from
  ``NBMF_DATA_DIR`` (default: the repository's ``data/``);
- the animals split is the committed ``data/magron2022/animals_split.npz``;
  the lastfm and paleo split files are not in the reference snapshot, so
  those splits are a seeded 70/15/15 per-entry split (the animals split's
  observed fractions);
- the original author's stored results are read from
  ``data/magron2022/<dataset>/`` (``NBMF_MAGRON_OUTPUTS`` overrides).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..utils.rdata import load_r_matrix

LOCAL_DATA = Path(__file__).resolve().parents[2] / "data"
DATA_DIR = Path(os.environ.get("NBMF_DATA_DIR", LOCAL_DATA))
SPLIT_DIR = Path(os.environ.get("NBMF_SPLIT_DIR", DATA_DIR / "magron2022"))
MAGRON_OUTPUTS = Path(os.environ.get("NBMF_MAGRON_OUTPUTS", LOCAL_DATA / "magron2022"))

DATASETS = ("animals", "lastfm", "paleo")
_SPLIT_FRACTIONS = (0.70, 0.15, 0.15)  # train / val / test, by entry


def load_dataset(name: str) -> np.ndarray:
    """One of the paper's binary matrices, float64: ``data/<name>.npz``
    (converted once from the ``.rda`` originals; see ``data/README.md``), or
    the ``.rda`` file in ``NBMF_DATA_DIR``."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; choose from {DATASETS}")
    npz = LOCAL_DATA / f"{name}.npz"
    if npz.exists():
        with np.load(npz) as z:
            return z["Y"].astype(np.float64)
    Y, _ = load_r_matrix(DATA_DIR / f"{name}.rda")
    return Y


def generate_entry_split(shape: Tuple[int, int], seed: int = 12345) -> Dict[str, np.ndarray]:
    """Seeded 70/15/15 per-entry split (disjoint binary masks)."""
    rng = np.random.default_rng(seed)
    u = rng.random(shape)
    train = (u < _SPLIT_FRACTIONS[0]).astype(np.float64)
    val = ((u >= _SPLIT_FRACTIONS[0])
           & (u < _SPLIT_FRACTIONS[0] + _SPLIT_FRACTIONS[1])).astype(np.float64)
    test = (u >= _SPLIT_FRACTIONS[0] + _SPLIT_FRACTIONS[1]).astype(np.float64)
    return {"train_mask": train, "val_mask": val, "test_mask": test}


def load_splits(name: str, shape: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """The committed split masks when available; regenerated otherwise."""
    for path in (LOCAL_DATA / "magron2022" / f"{name}_split.npz",
                 SPLIT_DIR / f"{name}_split.npz"):
        if path.exists():
            with np.load(path) as z:
                return {k: z[k].astype(np.float64) for k in ("train_mask", "val_mask", "test_mask")}
    return generate_entry_split(shape)


def load_dataset_and_splits(name: str):
    Y = load_dataset(name)
    s = load_splits(name, Y.shape)
    return Y, s["train_mask"], s["val_mask"], s["test_mask"]


def compute_perplexity(Y, Y_hat, mask=None, eps: float = 1e-8) -> float:
    """Masked Bernoulli perplexity ``exp(-mean observed log-lik)``, the
    reproduction's metric."""
    if mask is None:
        mask = np.ones_like(Y)
    log_lik = Y * np.log(Y_hat + eps) + (1 - Y) * np.log(1 - Y_hat + eps)
    return float(np.exp(-np.sum(mask * log_lik) / np.count_nonzero(mask)))


def magron_test_init(name: str, method: str):
    """The original author's stored 10-init test results
    (``<dataset>/<method>_test_init.npz``: ``test_pplx`` is the per-entry NLL
    of 10 random inits), as ``{"mean", "std", "iters"}`` in log-NLL units, or
    ``None`` if absent.  ``method`` is ``"NBMF-MM"``, ``"NBMF-EM"`` or
    ``"logPCA"``."""
    path = MAGRON_OUTPUTS / name / f"{method}_test_init.npz"
    if not path.exists():
        return None
    with np.load(path, allow_pickle=True) as z:
        pplx = np.asarray(z["test_pplx"], dtype=float)
        iters = np.asarray(z["test_iter"], dtype=float)
    return {"mean": float(pplx.mean()), "std": float(pplx.std()), "iters": float(iters.mean())}


def magron_best_val_logpplx(name: str, k: int):
    """The best stored validation log-perplexity of the original author's
    artifacts at rank ``k`` (``<dataset>/NBMF-MM_val.npz``: ``val_pplx`` of
    shape (K-grid, alpha-grid, beta-grid) in per-entry NLL units; ``exp``
    converts it to a perplexity), or ``None``."""
    path = MAGRON_OUTPUTS / name / "NBMF-MM_val.npz"
    if not path.exists():
        return None
    with np.load(path, allow_pickle=True) as z:
        val = z["val_pplx"]
        k_grid = list(np.asarray(z["list_hyper"][0]).ravel())
    if k not in k_grid:
        return None
    return float(np.min(val[k_grid.index(k)]))
