"""Scikit-learn-style estimator for NBMF-MM on PyTorch (counterpart of
the JAX package's ``models/estimator.py``).

Keeps the reference estimator's contract (``siddC/nbmf_mm``
``src/nbmf_mm/_base.py``): constructor names, fitted attributes (``W_``,
``components_``, ``loss_curve_``, ``objective_history_``, ``loss_``,
``n_iter_``, ``reconstruction_err_``), orientation aliases, "X must be
binary", masked training, the 50-iteration ``transform`` fold-in and the
``score``/``perplexity`` refit semantics.  ``device`` (default ``"cuda"``)
and ``backend`` (``"auto"``/``"fused"``/``"plain"``) are this package's
own; see :func:`nbmf_mm_tpu_torch.solver.driver.solve`.  Large fold-ins on
the card run through the fused serving kernels
(:func:`nbmf_mm_tpu_torch.models.serving.fold_in_fused`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_sweep as cs
from ..ops.packed import PackedMatrix
from ..ops.updates import fold_in_w_update
from ..solver.driver import (
    _resolve_backend,
    canonical_backend,
    _resolve_dtype,
    _resolve_precision,
    ieee_fp32_products,
    solve,
)
from ..utils.validation import (
    check_array,
    check_is_fitted,
    densify,
    warn_large_sparse_densify,
)

__all__ = ["NBMFMM", "NBMF"]

try:  # sklearn is optional; the estimator works standalone.
    from sklearn.base import BaseEstimator, TransformerMixin

    _BASES = (BaseEstimator, TransformerMixin)
except Exception:  # pragma: no cover
    _BASES = (object,)


_ORIENTATION_ALIASES = {
    # Canonical forms and case/synonym aliases (reference _base.py:127-137).
    "beta-dir": "beta-dir",
    "dir-beta": "dir-beta",
    "Beta-Dir": "beta-dir",
    "Dir-Beta": "dir-beta",
    "Dir Beta": "dir-beta",
    "binary ICA": "beta-dir",
    "Binary ICA": "beta-dir",
    "bICA": "beta-dir",
    "Aspect Bernoulli": "dir-beta",
}

_FOLD_IN_ITERS = 50
_FOLD_IN_SEED_OFFSET = 0x7F01  # transform's draw is seeded apart from fit's
# Entry count from which backend="auto" routes transform through the fused
# fold-in kernels on the card (the JAX package's gate, estimator.py:292).
_FUSED_TRANSFORM_MIN_ENTRIES = 1 << 22


def _transform_core(H, Ym, Ym2, W0t, eps, *, n_iter: int, precision=None):
    """Fold-in: find W for new data with ``H`` fixed (reference
    ``_base.py:178-193``), ``n_iter`` beta-dir W updates from ``W0t (k, m)``
    with products in the tier ``precision``, then the final box clip and row
    renormalization (``_base.py:196-198``)."""
    n_features = H.shape[1]
    Wt = W0t
    for _ in range(n_iter):
        Wt = fold_in_w_update(Wt, H, Ym, Ym2, n_features=n_features, eps=eps,
                              precision=precision)
    W = torch.clamp(Wt.T, 1e-8, 1.0)
    return W / W.sum(dim=1, keepdim=True)


class NBMFMM(*_BASES):
    """Non-negative Binary Matrix Factorization via Majorization-Minimization.

    PyTorch implementation of the NBMF-MM algorithm from P. Magron and
    C. Fevotte, "A majorization-minimization algorithm for nonnegative binary
    matrix factorization," IEEE Signal Processing Letters, 2022.

    Parameters
    ----------
    n_components : int, default=10
        Latent dimension ``k``.
    alpha, beta : float, default=1.2
        Beta-prior parameters for the continuous factor.
    max_iter : int, default=2000
        Maximum number of MM sweeps.
    tol : float, default=1e-5
        Relative-loss-change convergence tolerance.
    W_init, H_init : array-like, optional
        Warm-start factors (shapes ``(n_samples, k)`` / ``(k, n_features)``).
    init : ignored
        Present for API compatibility with the reference.
    random_state : int or None
        Seed for factor initialization (and for ``transform``'s fold-in).
    verbose : int, default=0
        Print loss every 10 sweeps when > 0.
    orientation : str, default="beta-dir"
        ``"beta-dir"`` or ``"dir-beta"``; aliases such as ``"Binary ICA"`` /
        ``"Aspect Bernoulli"`` are canonicalized.
    n_init : int, default=1
        Random restarts, run as one batched solve over data staged once; the
        fit with the lowest final objective is kept, and
        ``solver_result_.best_restart`` / ``.all_final_losses`` say which it
        was and what every restart reached.  Excludes ``W_init``/``H_init``.
    projection : {"normalize", "duchi"}, default="normalize"
    mask_mode : {"parity", "corrected"}, default="parity"
    dtype : optional
        ``"float32"`` (default), ``"float64"`` or ``"bfloat16"``: the
        bf16-data mode, float32 factors over data stored bf16 on the kernel
        route (never packed; ``packed=True`` with it raises), the products at
        ``"default"``; ``transform`` stores its batch bf16 on the kernel route
        too.  See ``solve``.
    precision : optional
        The product tier of ``fit`` and ``transform``: ``None`` or
        ``"highest"`` IEEE fp32 products (the default); ``"high"`` every
        product operand rounded to TF32; ``"default"`` rounded to bf16;
        fp32 accumulation in every tier, on the CPU as on the card (the JAX
        package computes every tier in fp32 on the CPU).
    mesh : must be None
    mesh_axes : (str, str), default ("rows", "cols")
        Forwarded to ``solve``, which checks it only together with ``mesh``.
    backend : {"auto", "fused", "plain"}, default="auto"
        The JAX package's ``"pallas"`` and ``"jnp"`` name the fused and the
        plain loop.
    packed : {None, False, True}, default=None
        Stream exactly-binary operands as packed words (``None``), always
        dense (``False``), or require packing (``True``); see ``solve``.
    solver_options : dict, optional
        Extra keyword arguments that ``fit`` forwards to ``solve`` (for
        example ``device_results``, or the JAX package's ``block_m``,
        ``block_n`` and ``pallas_interpret``, which ``solve`` accepts).
        They override the constructor's on a key collision.
    use_numexpr, use_numba, projection_backend : ignored
        Legacy flags of the reference's README, accepted so that calls
        carry over.
    device : str or torch.device, default="cuda"
        Where ``fit`` and ``transform`` run.
    """

    def __init__(
        self,
        n_components=10,
        alpha=1.2,
        beta=1.2,
        max_iter=2000,
        tol=1e-5,
        W_init=None,
        H_init=None,
        init=None,
        random_state=None,
        verbose=0,
        orientation="beta-dir",
        n_init=1,
        projection="normalize",
        mask_mode="parity",
        dtype=None,
        precision=None,
        mesh=None,
        mesh_axes=("rows", "cols"),
        backend="auto",
        packed=None,
        solver_options=None,
        use_numexpr=None,
        use_numba=None,
        projection_backend=None,
        device="cuda",
    ):
        self.n_components = n_components
        self.alpha = alpha
        self.beta = beta
        self.max_iter = max_iter
        self.tol = tol
        self.W_init = W_init
        self.H_init = H_init
        self.init = init
        self.random_state = random_state
        self.verbose = verbose
        self.orientation = orientation
        self.n_init = n_init
        self.projection = projection
        self.mask_mode = mask_mode
        self.dtype = dtype
        self.precision = precision
        self.mesh = mesh
        self.mesh_axes = mesh_axes
        self.backend = backend
        self.packed = packed
        self.solver_options = solver_options
        self.use_numexpr = use_numexpr
        self.use_numba = use_numba
        self.projection_backend = projection_backend
        self.device = device

    # ------------------------------------------------------------------ fit
    def fit(self, X, y=None, mask=None):
        """Fit the NBMF model to binary (or [0,1]-valued) data ``X``.

        ``X`` may also be a :class:`~nbmf_mm_tpu_torch.ops.packed.PackedMatrix`
        (binary by construction; ``solve`` enforces its contract) or a
        ``scipy.sparse`` matrix, which goes to ``solve`` as it is: routings
        that run the packed loop pack it straight from its structure and
        every other routing densifies it, with the dense-input result
        either way.
        """
        if not isinstance(X, PackedMatrix):
            X = check_array(X, accept_sparse="csr", dtype=np.float64)
            values = X.data if hasattr(X, "toarray") else X
            if not np.all((values >= 0) & (values <= 1)):
                raise ValueError("X must be binary")

        # Canonicalize and *store* the normalized orientation (reference
        # _base.py:94-95).
        orientation = self._normalize_orientation(self.orientation)
        self.orientation = orientation

        solve_kwargs = dict(
            n_components=self.n_components,
            max_iter=self.max_iter,
            tol=self.tol,
            alpha=self.alpha,
            beta=self.beta,
            W_init=self.W_init,
            H_init=self.H_init,
            mask=mask,
            random_state=self.random_state,
            verbose=self.verbose,
            orientation=orientation,
            n_init=self.n_init,
            projection=self.projection,
            mask_mode=self.mask_mode,
            dtype=self.dtype,
            precision=self.precision,
            mesh=self.mesh,
            # getattr: an estimator pickled before mesh_axes existed has no
            # such attribute (unpickling skips __init__).
            mesh_axes=tuple(getattr(self, "mesh_axes", ("rows", "cols"))),
            backend=self.backend,
            packed=self.packed,
            device=self.device,
        )
        solve_kwargs.update(self.solver_options or {})
        result = solve(X, **solve_kwargs)
        self._set_fitted(result.W, result.H, result.losses, result.n_iter,
                         converged=result.converged, fit_time=result.time_elapsed)
        self.solver_result_ = result
        return self

    def _set_fitted(self, W, H, losses, n_iter, *, converged, fit_time):
        """Store the fitted attributes of the reference estimator."""
        if not isinstance(losses, torch.Tensor):  # a tensor under device_results
            losses = list(losses)
        self.W_ = W
        self.components_ = H
        self.loss_curve_ = losses
        self.objective_history_ = losses  # backward-compat alias
        self.loss_ = losses[-1] if len(losses) else np.inf
        self.n_iter_ = n_iter
        self.reconstruction_err_ = self.loss_
        self.converged_ = converged
        self.fit_time_ = fit_time

    def _normalize_orientation(self, orientation):
        """Map orientation aliases to canonical form (reference
        ``_base.py:124-143``); raise ``ValueError`` on unknown values."""
        try:
            return _ORIENTATION_ALIASES[orientation]
        except (KeyError, TypeError):
            raise ValueError(
                f"Unknown orientation: {orientation}. "
                f"Must be one of {list(_ORIENTATION_ALIASES.keys())}"
            ) from None

    def fit_transform(self, X, y=None):
        """Fit to ``X`` and return ``W_`` (exactly ``fit(X).W_``)."""
        self.fit(X)
        return self.W_

    # ------------------------------------------------------------ transform
    def _fold_in_init(self, m: int, dtype: torch.dtype) -> torch.Tensor:
        """Seeded U(0.1, 0.9) ``(k, m)`` start for the fold-in (CPU draw)."""
        seed = 0 if self.random_state is None else int(self.random_state)
        gen = torch.Generator().manual_seed(seed + _FOLD_IN_SEED_OFFSET)
        return torch.rand((self.n_components, m), generator=gen, dtype=dtype) * 0.8 + 0.1

    def _use_fused_transform(self, n_entries: int, dtype: torch.dtype,
                             device: torch.device) -> bool:
        """Route ``transform`` through the fused fold-in kernels?  Always
        under ``backend="fused"`` (which raises for a rank above the
        kernels' cap); under ``"auto"`` where ``solve`` would take the fused
        loop (float32 on a CUDA device, a rank within the cap) from
        ``_FUSED_TRANSFORM_MIN_ENTRIES`` entries; never under ``"plain"``."""
        route = _resolve_backend(self.backend, dtype, device, True, k=self.n_components)
        return route == "fused" and (canonical_backend(self.backend) == "fused"
                                     or n_entries >= _FUSED_TRANSFORM_MIN_ENTRIES)

    def transform(self, X, mask=None):
        """Fold in new data: find W for ``X`` with fitted ``components_`` held
        fixed, via 50 beta-dir multiplicative updates (reference
        ``_base.py:162-199``), seeded from ``random_state``, on ``device``.

        Large batches on the card (and any batch under ``backend="fused"``)
        run through the fused fold-in kernels with the same seeded start, so
        the two routes agree to the kernels' rounding."""
        check_is_fitted(self, ["components_"])
        X = check_array(X, accept_sparse="csr", dtype=np.float64)
        warn_large_sparse_densify(X, "transform")
        X = densify(X)
        if mask is not None:
            warn_large_sparse_densify(mask, "transform (mask)")
            mask = densify(mask)

        dtype, data_dtype = _resolve_dtype(self.dtype)
        tier = _resolve_precision(self.precision, data_dtype)
        device = cs.resolve_device(self.device)
        W0t = self._fold_in_init(X.shape[0], dtype)
        if self._use_fused_transform(X.size, dtype, device):
            from .serving import fold_in_fused

            W, _ = fold_in_fused(self.components_, X, mask, W0t, n_iter=_FOLD_IN_ITERS,
                                 dtype=data_dtype or dtype, packed=self.packed,
                                 mxu_precision=tier, device=device)
            return W
        Xt = torch.as_tensor(X, device=device).to(dtype)
        H = torch.tensor(np.asarray(self.components_), device=device).to(dtype)
        if mask is None:
            Ym, Ym2 = Xt, 1.0 - Xt
        else:
            mt = torch.as_tensor(np.asarray(mask, dtype=np.float64), device=device).to(dtype)
            Ym, Ym2 = Xt * mt, (1.0 - Xt) * mt
        with ieee_fp32_products():
            W = _transform_core(H, Ym, Ym2, W0t.to(device), 1e-8, n_iter=_FOLD_IN_ITERS,
                                precision=tier)
        return W.cpu().numpy()

    def inverse_transform(self, W):
        """Reconstruct data-space probabilities ``clip(W @ H, 0, 1)``
        (reference ``_base.py:201-210``)."""
        check_is_fitted(self, ["components_"])
        W = check_array(W, dtype=np.float64)
        return np.clip(W @ self.components_, 0.0, 1.0)

    # ---------------------------------------------------------------- score
    def score(self, X, mask=None):
        """Mean Bernoulli log-likelihood per observed entry of ``X`` under a
        reconstruction refit via ``transform`` (reference ``_base.py:212-247``,
        including the refit-from-scratch semantics and parity masking)."""
        check_is_fitted(self, ["components_"])
        X = check_array(X, accept_sparse="csr", dtype=np.float64)
        warn_large_sparse_densify(X, "score")
        X = densify(X)
        X_recon = self.inverse_transform(self.transform(X))
        eps = 1e-8
        if mask is None:
            log_lik = X * np.log(X_recon + eps) + (1 - X) * np.log(1 - X_recon + eps)
            n_obs = X.size
        else:
            warn_large_sparse_densify(mask, "score (mask)")
            mask = densify(mask)
            X_masked = X * mask
            log_lik = X_masked * np.log(X_recon + eps) + (1 - X_masked) * np.log(
                1 - X_recon + eps
            )
            n_obs = np.count_nonzero(mask)
        return float(np.sum(log_lik) / n_obs)

    def perplexity(self, X, mask=None):
        """``exp(-score(X, mask))`` (reference ``_base.py:249-265``)."""
        return float(np.exp(-self.score(X, mask)))


# Alias for backwards compatibility (reference _base.py:269).
NBMF = NBMFMM
