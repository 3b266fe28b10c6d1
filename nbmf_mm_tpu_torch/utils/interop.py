"""Carry fitted state across from the JAX package.

:func:`from_reference` reads plain attributes (numpy arrays and Python
scalars) off a fitted JAX-package ``NBMF``, a JAX-package ``SolverResult``
or a dict with the same names, and returns a fitted
:class:`~nbmf_mm_tpu_torch.models.estimator.NBMF`.  It never imports JAX.
The packed-word layout is shared, so words need no conversion either.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from ..models.estimator import NBMF

__all__ = ["from_reference"]

# Constructor arguments that carry over from a fitted JAX estimator.
_HYPERPARAMETERS = (
    "n_components", "alpha", "beta", "max_iter", "tol", "random_state",
    "verbose", "orientation", "projection", "mask_mode", "packed",
)


def from_reference(state, device="cuda", **params) -> NBMF:
    """A fitted port ``NBMF`` on ``device`` from JAX-package state.

    ``state`` holds either the estimator attributes ``W_``, ``components_``,
    ``loss_curve_``, ``n_iter_`` (plus the hyperparameters), or a solver
    result's ``W``, ``H``, ``losses``, ``n_iter``.  ``params`` set or override
    constructor arguments (e.g. ``orientation`` for a solver result).
    """
    if isinstance(state, Mapping):
        get = state.get
    else:
        def get(name, default=None):
            return getattr(state, name, default)

    if get("components_") is not None:
        W, H = get("W_"), get("components_")
        losses, n_iter = get("loss_curve_", []), get("n_iter_", 0)
        kwargs = {name: get(name) for name in _HYPERPARAMETERS if get(name) is not None}
        if get("dtype") is not None:
            kwargs["dtype"] = np.dtype(get("dtype")).name
    elif get("H") is not None:
        W, H = get("W"), get("H")
        losses, n_iter = get("losses", []), get("n_iter", 0)
        kwargs = {"n_components": np.asarray(H).shape[0]}
    else:
        raise ValueError("state has neither components_ (estimator) nor H (solver result)")

    kwargs.update(params)
    est = NBMF(device=device, **kwargs)
    est._set_fitted(
        np.asarray(W, dtype=np.float64),
        np.asarray(H, dtype=np.float64),
        [float(x) for x in np.asarray(losses).ravel()],
        int(n_iter),
        converged=bool(get("converged_", get("converged", False))),
        fit_time=float(get("fit_time_", get("time_elapsed", 0.0))),
    )
    return est
