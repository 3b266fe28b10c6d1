"""Dense sweep passes: the three kernel wrappers and their plain versions
(counterpart of the dense half of the JAX package's ``ops/pallas_sweep.py``:
``hloss_terms``/``hloss_terms_stripe``, ``w_terms``/``w_terms_stripe`` and
``loglik_sum``).

They serve ``[0, 1]``-valued data and weighted masks, where the operands
cannot be packed into words.  Operands are zero-padded ``(Mp, Np)`` f32
tensors at :func:`~nbmf_mm_tpu_torch.ops.cuda_sweep.plan_packing`'s
geometry, with the JAX package's contract (``pad_operands``):

- the H pass (and ``loglik_sum``) takes ``Yc=None`` for ``1 - Ym`` over
  every entry (unmasked and parity) or an explicit ``Yc`` (corrected mode,
  where it is the ``Ym2`` buffer itself);
- the W pass takes ``Ym2=None`` for the unmasked complement ``1 - Ym`` at
  ``col < n_real`` or an explicit ``Ym2 = (1 - Y) * mask`` (both masked
  modes).

Per entry, with ``a = WH + eps``, ``b = max(1 - WH, 0) + eps`` and
``r = 1/(a b)``: ``p = ym (b r)``, ``q = yc (a r)``,
``ll = ym log a + yc log b``, the log-likelihood masked exactly to
``row < m_real and col < n_real``.  On exactly-binary operands each value
equals the packed select bitwise, so the dense and packed passes agree
bitwise, on the CPU and on the card.

Each wrapper takes CPU tensors to its plain version and launches its kernel
(``csrc/sweep_dense.cu``) for CUDA tensors, or raises; ``LAUNCHES`` counts
the launches.  ``bm`` is the stripe whose bit-plane row order the kernels
walk (the packed kernels' order, which keeps the two bitwise equal); the
plain versions do not need it.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_sweep as cs

__all__ = [
    "LAUNCHES",
    "hloss_terms_plain",
    "w_terms_plain",
    "loglik_sum_plain",
    "hloss_terms",
    "w_terms",
    "loglik_sum",
]

LAUNCHES = {"hloss_terms": 0, "w_terms": 0, "loglik_sum": 0}


# ------------------------------------------------------------ plain versions
def _masked_ll(Ym, yc, a, b, m_real, n_real):
    """``sum(ym log a + yc log b)`` over the real region, added in f64."""
    Mp, Np = Ym.shape
    rows = torch.arange(Mp, device=Ym.device)[:, None] < m_real
    cols = torch.arange(Np, device=Ym.device)[None, :] < n_real
    ll = Ym * torch.log(a) + yc * torch.log(b)
    return torch.where(rows & cols, ll, 0.0).sum(dtype=torch.float64).to(a.dtype)


def hloss_terms_plain(W, H, Ym, Yc=None, *, eps, m_real, n_real):
    """Plain PyTorch version of the dense H pass: ``(Num, Den, ll)``."""
    a, b, r = cs._ratio_terms(W, H, eps)
    yc = 1.0 - Ym if Yc is None else Yc
    p = Ym * (b * r)
    q = yc * (a * r)
    return W @ p, W @ q, _masked_ll(Ym, yc, a, b, m_real, n_real)


def w_terms_plain(W, H_new, Ym, Ym2=None, *, eps, n_real):
    """Plain PyTorch version of the dense W pass: ``T (k, Mp)``."""
    a, b, r = cs._ratio_terms(W, H_new, eps)
    if Ym2 is None:
        cols = torch.arange(Ym.shape[1], device=Ym.device)[None, :] < n_real
        Ym2 = torch.where(cols, 1.0 - Ym, 0.0)
    p = Ym * (b * r)
    q = Ym2 * (a * r)
    # Two nonnegative products; never H (P - Q)^T + sum Q (cancellation).
    return H_new @ p.T + (1.0 - H_new) @ q.T


def loglik_sum_plain(W, H, Ym, Yc=None, *, eps, m_real, n_real):
    """Plain PyTorch version of ``loglik_sum``: the H pass's ``ll`` alone."""
    a, b, _ = cs._ratio_terms(W, H, eps)
    yc = 1.0 - Ym if Yc is None else Yc
    return _masked_ll(Ym, yc, a, b, m_real, n_real)


# ------------------------------------------------------------------ wrappers
def hloss_terms(
    W: torch.Tensor,
    H: torch.Tensor,
    Ym: torch.Tensor,
    Yc: Optional[torch.Tensor] = None,
    *,
    eps: float,
    m_real: int,
    n_real: int,
    bm: int,
):
    """Fused dense H-update + loss pass: ``(Num, Den, ll)``."""
    if W.device.type == "cpu":
        return hloss_terms_plain(W, H, Ym, Yc, eps=eps, m_real=m_real, n_real=n_real)
    cs._check_cuda_operands("hloss_terms", W, H, Ym, Yc, bm, dense=True)
    out = cs._launch_hloss("nbmf_hloss_terms_dense", "hloss_terms", W, H, Ym, Yc,
                           eps=eps, m_real=m_real, n_real=n_real, bm=bm)
    LAUNCHES["hloss_terms"] += 1
    return out


def w_terms(
    W: torch.Tensor,
    H_new: torch.Tensor,
    Ym: torch.Tensor,
    Ym2: Optional[torch.Tensor] = None,
    *,
    eps: float,
    n_real: int,
    bm: int,
) -> torch.Tensor:
    """Dense W-update contraction ``T = H P^T + (1 - H) Q^T`` (``(k, Mp)``)."""
    if W.device.type == "cpu":
        return w_terms_plain(W, H_new, Ym, Ym2, eps=eps, n_real=n_real)
    cs._check_cuda_operands("w_terms", W, H_new, Ym, Ym2, bm, dense=True)
    T = cs._launch_wterms("nbmf_w_terms_dense", "w_terms", W, H_new, Ym, Ym2,
                          eps=eps, n_real=n_real, bm=bm)
    LAUNCHES["w_terms"] += 1
    return T


def loglik_sum(
    W: torch.Tensor,
    H: torch.Tensor,
    Ym: torch.Tensor,
    Yc: Optional[torch.Tensor] = None,
    *,
    eps: float,
    m_real: int,
    n_real: int,
    bm: int,
) -> torch.Tensor:
    """Masked Bernoulli log-likelihood of ``(W, H)`` over the real region (a
    0-d tensor); on the card bitwise the ``ll`` of :func:`hloss_terms`."""
    if W.device.type == "cpu":
        return loglik_sum_plain(W, H, Ym, Yc, eps=eps, m_real=m_real, n_real=n_real)
    cs._check_cuda_operands("loglik_sum", W, H, Ym, Yc, bm, dense=True)
    _, _, ll = cs._launch_hloss("nbmf_loglik_sum_dense", "loglik_sum", W, H, Ym, Yc,
                                eps=eps, m_real=m_real, n_real=n_real, bm=bm, terms=False)
    LAUNCHES["loglik_sum"] += 1
    return ll
