"""Comparison baselines of Magron & Fevotte (2022): NBMF-EM and logPCA
(counterpart of the JAX package's ``models/baselines.py``).

Both were identified there from the paper's stored artifacts
(``data/magron2022/``), and both keep that identification here:

- :class:`NBMFEM`: expectation-maximization for ``V ~ Bernoulli(W @ H^T)``
  with ``W (m, k)`` nonnegative (multiplicative ``/n`` update, no simplex
  renormalization) and ``H (n, k)`` in ``[0, 1]`` (responsibility-ratio
  update).  Under a mask the monitored observed-only NLL may rise; the
  signed stop then halts the fit, as the stored animals trace does.
- :class:`LogisticPCA`: the paper's "logPCA" is logistic SVD
  ``V ~ Bernoulli(sigmoid(1 mu^T + A B^T))`` with free scores ``A`` and
  orthonormal loadings ``B``, fit by the MM working-variable algorithm (one
  rank-k SVD per iteration).

Both stop at the first iteration from the second on where
``loss[t-1] - loss[t] < tol`` (a signed absolute difference, so a loss
increase stops them too).  The cores are plain functions on tensors that take
the inits (:func:`_em_core`, :func:`_lsvd_core`), run on the tensors' device
and read the stopping flag back to the host once per iteration.  The SVD and
the matmuls are library calls, as they are XLA's in the JAX package; neither
baseline has a kernel.

Inits come from a CPU ``torch.Generator`` seeded with ``random_state`` (0 for
``None``) and then move to ``device``, so a seed gives the same init on the
CPU and on the card (it differs from the JAX package's ``PRNGKey`` draw;
:func:`_em_inits` and :func:`_lsvd_inits` draw them, and are read at call
time).
``dtype`` is the compute dtype of everything, as in the JAX package:
``None`` is float32 (the port's default), and ``"bfloat16"`` runs NBMF-EM in
bf16 (its fitted arrays come back as float32 arrays of the bf16 values) and
is refused by logPCA, whose SVD has no bf16 form (the JAX package raises
there too).  NBMF-EM's ``precision`` is the product tier of
:mod:`~nbmf_mm_tpu_torch.ops.tiers`: the operands of each product rounded to
TF32 (``"high"``) or bf16 (``"default"``), on the CPU as on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_sweep as cs
from ..ops import tiers
from ..solver.driver import _dtype_name, ieee_fp32_products
from ..utils.validation import check_array, check_is_fitted, densify

__all__ = ["NBMFEM", "LogisticPCA"]


def _resolve_dtype(dtype) -> torch.dtype:
    """The baselines' compute dtype: ``None`` is float32; float32, float64
    and bfloat16 by any spelling."""
    name = "float32" if dtype is None else _dtype_name(dtype)
    if name not in ("float32", "float64", "bfloat16"):
        raise ValueError(f"dtype must be float32, float64 or bfloat16, got {dtype!r}")
    return getattr(torch, name)


def _em_inits(random_state, m: int, n: int, k: int, dtype: torch.dtype):
    """NBMF-EM's start, drawn on the CPU: ``W ~ U(0, 1/k)`` keeps
    ``P = W @ H.T`` inside (0, 1); ``H ~ U(0, 1)``."""
    gen = torch.Generator().manual_seed(0 if random_state is None else int(random_state))
    W0 = torch.rand((m, k), generator=gen, dtype=dtype) / k
    return W0, torch.rand((n, k), generator=gen, dtype=dtype)


def _lsvd_inits(random_state, m: int, n: int, k: int, dtype: torch.dtype):
    """logPCA's start, drawn on the CPU: scores and loadings ``0.1 N(0, 1)``."""
    gen = torch.Generator().manual_seed(0 if random_state is None else int(random_state))
    A0 = 0.1 * torch.randn((m, k), generator=gen, dtype=dtype)
    return A0, 0.1 * torch.randn((n, k), generator=gen, dtype=dtype)


def _signed_stop(prev: torch.Tensor, loss: torch.Tensor, tol: torch.Tensor, it: int) -> bool:
    """The signed stop, in the loss's dtype as in the JAX package (``tol``
    rounded to it): ``prev - loss < tol`` from the second iteration on.  The
    iteration's one host read."""
    return it > 0 and bool(prev - loss < tol)


def _signed_stop_loop(step, loss_fn, carry0, tol: float, max_iter: int):
    """Run ``carry -> step(carry)``, recording ``loss_fn(carry)`` after each
    step, until ``max_iter`` steps or the first ``loss[t-1] - loss[t] < tol``
    from the second step on (``prev`` starts infinite).  Returns ``(carry,
    losses, n_iter, converged)`` with ``losses`` a ``(max_iter,)`` tensor,
    zero past ``n_iter``."""
    carry, losses, prev = carry0, None, None
    it, done = 0, False
    while it < max_iter and not done:
        carry = step(carry)
        loss_t = loss_fn(carry)
        if losses is None:
            kw = dict(dtype=loss_t.dtype, device=loss_t.device)
            losses = torch.zeros((max_iter,), **kw)
            prev, tol = torch.tensor(float("inf"), **kw), torch.tensor(tol, **kw)
        losses[it] = loss_t
        done = _signed_stop(prev, loss_t, tol, it)
        prev = loss_t
        it += 1
    return carry, losses, it, done


# ------------------------------------------------------------------ NBMF-EM
def _em_core(Ym, Cm, W0, H0, tol, eps, n_obs, *, max_iter: int, precision=None):
    """EM loop in the artifacts' parameterization, the counterpart of the JAX
    ``_em_core``: ``W (m, k)`` free nonnegative, ``H (n, k)`` in ``[0, 1]``,
    ``P = W @ H.T``.  One iteration:

      A = Ym / (P + eps),  B = Cm / (1 - P + eps)
      W <- W * (A @ H + B @ (1 - H)) / n
      record the loss of (W, H); stop if loss[t-1] - loss[t] < tol
      H <- (A'.T @ W) / (A'.T @ W + B'.T @ W + eps)    (A', B' at the new W)

    so a converged iteration returns the new ``W`` with the previous ``H``,
    the pair its recorded loss was computed on.  The loss is the
    observed-only mean Bernoulli NLL.  ``precision`` is the products' tier.

    Returns ``(W, H, losses, n_iter, converged)`` with ``losses`` a
    ``(max_iter,)`` tensor, zero past ``n_iter``.
    """
    form = tiers.operand_form(precision)
    dot = lambda A, B: tiers.mxu_round(A, form) @ tiers.mxu_round(B, form)
    n = Ym.shape[1]

    def ratios(W, H):
        P = dot(W, H.T)
        return Ym / (P + eps), Cm / (1.0 - P + eps)

    def loss_of(W, H):
        P = dot(W, H.T)
        ll = Ym * torch.log(P + eps) + Cm * torch.log(1.0 - P + eps)
        return -torch.sum(ll) / n_obs

    W, H = W0, H0
    kw = dict(dtype=W0.dtype, device=W0.device)
    losses = torch.zeros((max_iter,), **kw)
    prev, tol = torch.tensor(float("inf"), **kw), torch.tensor(tol, **kw)
    it, done = 0, False
    while it < max_iter and not done:
        A, B = ratios(W, H)
        W = W * (dot(A, H) + dot(B, 1.0 - H)) / n
        loss_t = loss_of(W, H)
        losses[it] = loss_t
        done = _signed_stop(prev, loss_t, tol, it)
        if not done:  # H moves only when the loop goes on
            A2, B2 = ratios(W, H)
            num = dot(A2.T, W)
            H = num / (num + dot(B2.T, W) + eps)
        prev = loss_t
        it += 1
    return W, H, losses, it, done


def _host(t: torch.Tensor) -> np.ndarray:
    """A result on the host; bf16 values (which numpy has no dtype for) as
    float32, exactly."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _observed(X: np.ndarray, mask, dtype: torch.dtype, device: torch.device):
    """The data on ``device`` in ``dtype`` and the mask (None without one)."""
    Xd = torch.as_tensor(np.asarray(X, dtype=np.float64)).to(device=device, dtype=dtype)
    if mask is None:
        return Xd, None
    md = torch.as_tensor(np.asarray(densify(mask), dtype=np.float64))
    return Xd, md.to(device=device, dtype=dtype)


class NBMFEM:
    """Mean-parameterized Bernoulli factorization by EM (paper baseline).

    Same model as ``NBMF`` (``V ~ Bernoulli(W @ H^T)``) without the Beta and
    Dirichlet priors, in the parameterization of the paper's stored
    artifacts (see the module docstring).  ``converged_`` says whether the
    stop came from the tolerance rule rather than ``max_iter``.  ``device``
    (default ``"cuda"``) is where the fit runs; the fitted attributes are
    host numpy arrays.
    """

    def __init__(self, n_components=10, max_iter=500, tol=1e-5, random_state=None, dtype=None,
                 precision=None, eps=1e-8, device="cuda"):
        self.n_components = n_components
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.dtype = dtype
        self.precision = precision
        self.eps = eps
        self.device = device

    @ieee_fp32_products()
    def fit(self, X, y=None, mask=None):
        X = densify(check_array(X, dtype=np.float64))
        if not np.all((X >= 0) & (X <= 1)):
            raise ValueError("X must be binary")
        dtype = _resolve_dtype(self.dtype)
        tiers.resolve_tier(self.precision)  # an unknown tier raises before any work
        device = cs.resolve_device(self.device)
        m, n = X.shape
        k = self.n_components

        W0, H0 = (A.to(device) for A in _em_inits(self.random_state, m, n, k, dtype))

        Xd, md = _observed(X, mask, dtype, device)
        if md is None:
            Ym, Cm, n_obs = Xd, 1.0 - Xd, float(X.size)
        else:
            Ym, Cm, n_obs = Xd * md, (1.0 - Xd) * md, float(torch.count_nonzero(md))
        W, H, losses, n_iter, done = _em_core(Ym, Cm, W0, H0, self.tol, self.eps, n_obs,
                                              max_iter=self.max_iter, precision=self.precision)
        self.W_ = _host(W)
        self.components_ = _host(H.T)  # (k, n) like NBMF
        self.n_iter_ = n_iter
        self.loss_curve_ = [float(x) for x in _host(losses[:n_iter])]
        self.loss_ = self.loss_curve_[-1] if self.loss_curve_ else np.inf
        self.converged_ = bool(done)
        return self

    def reconstruction(self):
        check_is_fitted(self, ["components_"])
        return np.clip(self.W_ @ self.components_, 0.0, 1.0)

    def inverse_transform(self, W):
        check_is_fitted(self, ["components_"])
        return np.clip(np.asarray(W) @ self.components_, 0.0, 1.0)


# ------------------------------------------------------------------- logPCA
def _lsvd_core(Ym, Mask, A0, B0, tol, *, k: int, max_iter: int, masked: bool):
    """Logistic SVD by MM (Landgraf & Lee 2020), the counterpart of the JAX
    ``_lsvd_core``: minimize the masked Bernoulli NLL of
    ``sigmoid(1 mu^T + A B^T)`` over the column effects ``mu``, the scores
    ``A (m, k)`` and the loadings ``B (n, k)``.  Each iteration majorizes the
    NLL at the natural parameter ``Theta`` with the quadratic bound
    (Hessian <= 1/4):

      Z  = Theta + 4 * mask * (Y - sigmoid(Theta))
      mu = colmean(Z - A B^T)
      A B^T = rank-k truncated SVD of (Z - 1 mu^T)

    The loss is ``softplus(Theta) - Y * Theta`` (masked, per observed
    entry), with ``softplus`` as ``logaddexp(Theta, 0)``: torch's
    ``softplus`` is linear above its threshold and would drift from the JAX
    package's.  ``Mask`` is read only when ``masked``.  Returns
    ``(mu, A, B, losses, n_iter, converged)``.
    """
    n_obs = float(Mask.sum()) if masked else float(Ym.shape[0] * Ym.shape[1])

    def theta(carry):
        mu, A, B = carry
        return mu[None, :] + A @ B.T

    def step(carry):
        mu, A, B = carry
        Th = theta(carry)
        G = Ym - torch.sigmoid(Th)
        if masked:
            G = Mask * G
        Z = Th + 4.0 * G
        mu_new = torch.mean(Z - A @ B.T, dim=0)
        U, S, Vt = torch.linalg.svd(Z - mu_new[None, :], full_matrices=False)
        return mu_new, U[:, :k] * S[:k], Vt[:k].T

    def loss_fn(carry):
        Th = theta(carry)
        ll = torch.logaddexp(Th, torch.zeros((), dtype=Th.dtype, device=Th.device)) - Ym * Th
        if masked:
            ll = Mask * ll
        return torch.sum(ll) / n_obs

    mu0 = torch.zeros((Ym.shape[1],), dtype=Ym.dtype, device=Ym.device)
    (mu, A, B), losses, n_iter, done = _signed_stop_loop(step, loss_fn, (mu0, A0, B0), tol,
                                                        max_iter)
    return mu, A, B, losses, n_iter, done


class LogisticPCA:
    """The paper's "logPCA" baseline: rank-k logistic SVD
    ``V ~ Bernoulli(sigmoid(1 mu^T + A B^T))`` fit by MM (see the module
    docstring).  ``device`` (default ``"cuda"``) is where the fit runs; the
    fitted attributes are host numpy arrays.  ``dtype`` is float32 (the
    default) or float64.
    """

    def __init__(self, n_components=10, max_iter=1000, tol=1e-5, random_state=None, dtype=None,
                 device="cuda"):
        self.n_components = n_components
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.dtype = dtype
        self.device = device

    @ieee_fp32_products()
    def fit(self, X, y=None, mask=None):
        X = densify(check_array(X, dtype=np.float64))
        dtype = _resolve_dtype(self.dtype)
        if dtype == torch.bfloat16:
            raise TypeError("LogisticPCA computes in float32 or float64: its SVD has no "
                            "bfloat16 form")
        device = cs.resolve_device(self.device)
        m, n = X.shape
        k = self.n_components
        A0, B0 = (A.to(device) for A in _lsvd_inits(self.random_state, m, n, k, dtype))
        Xd, Mask = _observed(X, mask, dtype, device)
        masked = Mask is not None
        Ym = Xd * Mask if masked else Xd
        mu, A, B, losses, n_iter, done = _lsvd_core(Ym, Mask, A0, B0, self.tol, k=k,
                                                    max_iter=self.max_iter, masked=masked)
        self.mu_ = mu.cpu().numpy()
        self.W_ = A.cpu().numpy()
        self.components_ = B.T.cpu().numpy()  # (k, n)
        self.n_iter_ = n_iter
        self.loss_curve_ = [float(x) for x in losses[:n_iter].cpu().numpy()]
        self.loss_ = self.loss_curve_[-1] if self.loss_curve_ else np.inf
        self.converged_ = bool(done)
        return self

    def reconstruction(self):
        check_is_fitted(self, ["components_"])
        return _stable_sigmoid(self.mu_[None, :] + self.W_ @ self.components_)

    def inverse_transform(self, W):
        check_is_fitted(self, ["components_"])
        return _stable_sigmoid(self.mu_[None, :] + np.asarray(W) @ self.components_)


def _stable_sigmoid(theta):
    """Overflow-free sigmoid on the host."""
    out = np.empty_like(theta, dtype=np.float64)
    pos = theta >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-theta[pos]))
    e = np.exp(theta[~pos])
    out[~pos] = e / (1.0 + e)
    return out
