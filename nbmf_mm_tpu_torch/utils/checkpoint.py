"""Checkpoint and resume (counterpart of the JAX package's
``utils/checkpoint.py``).

The full solver state (factors, loss history, iteration count, seed and
hyperparameters) round-trips through one ``.npz`` file in the JAX package's
format, key for key: ``W``, ``H``, ``losses`` (float64), ``n_iter`` and
``meta``, a JSON string with ``format_version`` 1, the seed and the
hyperparameters.  A file written by either package loads in the other.  The
file names no device and no dtype: :func:`load_model` and :func:`resume_fit`
take ``device`` (default ``"cuda"``, as every entry point), and the factors
keep the dtype they were saved in.

Fitted attributes that are tensors on the card (``solver_options=
{"device_results": True}``) are brought to the host before they are written
or concatenated.  The JAX package's Orbax pair is a JAX-library adapter
outside its ``__all__`` and has no counterpart here.
"""

from __future__ import annotations

import copy
import inspect
import json

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_model",
    "load_model",
    "resume_fit",
    "fit_checkpointed",
]

_FORMAT_VERSION = 1


def _host(x) -> np.ndarray:
    """An array or a tensor (on any device) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_losses(losses) -> list:
    return [float(x) for x in np.asarray(_host(losses), dtype=np.float64).ravel()]


def save_checkpoint(path, W, H, losses, n_iter, *, seed=None, hyperparams=None):
    """Write solver state to ``path`` (``.npz``; numpy appends the suffix
    when it is missing).  ``W``, ``H`` and ``losses`` may be tensors on any
    device; ``hyperparams`` is a JSON-serializable dict (alpha, beta,
    orientation, ...)."""
    meta = {
        "format_version": _FORMAT_VERSION,
        "seed": None if seed is None else int(seed),
        "hyperparams": hyperparams or {},
    }
    np.savez(
        path,
        W=_host(W),
        H=_host(H),
        losses=np.asarray(_host(losses), dtype=np.float64),
        n_iter=np.asarray(int(n_iter)),
        meta=np.asarray(json.dumps(meta)),
    )


def load_checkpoint(path) -> dict:
    """Read a checkpoint written by :func:`save_checkpoint` (of either
    package).  Returns a dict with keys ``W, H, losses, n_iter, seed,
    hyperparams``; the factors are host numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(f"checkpoint from a newer format: {meta}")
        return {
            "W": data["W"],
            "H": data["H"],
            "losses": [float(x) for x in data["losses"]],
            "n_iter": int(data["n_iter"]),
            "seed": meta.get("seed"),
            "hyperparams": meta.get("hyperparams", {}),
        }


def save_model(path, model):
    """Checkpoint a fitted :class:`~nbmf_mm_tpu_torch.NBMF` estimator with
    its eight hyperparameters."""
    from .validation import check_is_fitted

    check_is_fitted(model, ["components_"])
    hp = {
        "n_components": model.n_components,
        "alpha": model.alpha,
        "beta": model.beta,
        "orientation": model.orientation,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "projection": getattr(model, "projection", "normalize"),
        "mask_mode": getattr(model, "mask_mode", "parity"),
    }
    save_checkpoint(path, model.W_, model.components_, model.loss_curve_, model.n_iter_,
                    seed=model.random_state, hyperparams=hp)


def _estimator(ckpt: dict, overrides: dict, **extra):
    """An unfitted estimator from a checkpoint's hyperparameters, updated by
    ``overrides``.  An override that names another constructor parameter of
    the estimator (``dtype``, ``precision``, ``backend``, ...) is passed on
    as it is."""
    from ..models.estimator import NBMFMM

    hp = dict(ckpt["hyperparams"])
    hp.update(overrides)
    params = dict(
        n_components=hp.get("n_components", ckpt["W"].shape[1]),
        alpha=hp.get("alpha", 1.2),
        beta=hp.get("beta", 1.2),
        max_iter=hp.get("max_iter", 2000),
        tol=hp.get("tol", 1e-5),
        orientation=hp.get("orientation", "beta-dir"),
        projection=hp.get("projection", "normalize"),
        mask_mode=hp.get("mask_mode", "parity"),
        random_state=ckpt["seed"],
    )
    names = set(inspect.signature(NBMFMM.__init__).parameters) - {"self"}
    unknown = set(overrides) - names
    if unknown:
        raise TypeError(f"unknown estimator parameters: {sorted(unknown)}")
    params.update({k: v for k, v in overrides.items() if k not in params})
    params.update(extra)
    return NBMFMM(**params)


def load_model(path, device="cuda"):
    """Restore a fitted estimator from :func:`save_model` output (of either
    package), to run ``transform``/``score`` on ``device``.  The fitted
    attributes are host numpy arrays, as after a fit."""
    ckpt = load_checkpoint(path)
    model = _estimator(ckpt, {}, device=device)
    model.W_ = ckpt["W"]
    model.components_ = ckpt["H"]
    model.loss_curve_ = ckpt["losses"]
    model.objective_history_ = model.loss_curve_
    model.n_iter_ = ckpt["n_iter"]
    model.loss_ = ckpt["losses"][-1] if ckpt["losses"] else np.inf
    model.reconstruction_err_ = model.loss_
    return model


def resume_fit(path, X, mask=None, *, device="cuda", **overrides):
    """Continue fitting from a checkpoint: warm-start the solver with the
    stored factors and return a fitted estimator whose ``loss_curve_`` is
    the concatenated history (a host list) and whose ``n_iter_`` counts the
    checkpoint's sweeps too.  ``overrides`` replace the stored
    hyperparameters or set other constructor parameters (``max_iter=``,
    ``dtype=``, ...)."""
    ckpt = load_checkpoint(path)
    model = _estimator(ckpt, overrides, W_init=ckpt["W"], H_init=ckpt["H"], device=device)
    model.fit(X, mask=mask)
    model.loss_curve_ = ckpt["losses"] + _host_losses(model.loss_curve_)
    model.objective_history_ = model.loss_curve_
    model.n_iter_ += ckpt["n_iter"]
    return model


def fit_checkpointed(model, X, path, mask=None, every: int = 100):
    """Fit ``model`` on ``X`` in segments of ``every`` sweeps, overwriting the
    checkpoint at ``path`` after each segment.  Each segment warm-starts from
    the last one's factors, so the trajectory is the uninterrupted fit's up
    to the rounding of the re-normalization at segment starts; the
    relative-change stopping test restarts its warm-up at each segment, so
    stopping can differ by up to one segment.  Restart selection
    (``n_init``) happens in the first segment, and later segments continue
    the chosen restart (``n_init`` is set to 1).  Returns the estimator of
    the last segment with the whole history (a host list) and sweep count.
    """
    total = model.max_iter
    seg_model = copy.deepcopy(model)
    losses: list = []
    W_init, H_init = model.W_init, model.H_init
    done = 0
    while done < total:
        seg_model.max_iter = min(every, total - done)
        seg_model.W_init, seg_model.H_init = W_init, H_init
        seg_model.fit(X, mask=mask)
        losses.extend(_host_losses(seg_model.loss_curve_))
        done += seg_model.n_iter_
        save_checkpoint(
            path, seg_model.W_, seg_model.components_, losses, done,
            seed=model.random_state,
            hyperparams={"alpha": model.alpha, "beta": model.beta,
                         "orientation": seg_model.orientation,
                         "n_components": model.n_components},
        )
        if seg_model.n_iter_ < seg_model.max_iter:  # converged inside the segment
            break
        W_init, H_init = _host(seg_model.W_), _host(seg_model.components_)
        seg_model.n_init = 1
    seg_model.loss_curve_ = losses
    seg_model.objective_history_ = losses
    seg_model.n_iter_ = done
    seg_model.max_iter = total
    seg_model.W_init, seg_model.H_init = model.W_init, model.H_init
    return seg_model
