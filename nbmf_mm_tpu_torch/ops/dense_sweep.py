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

Operand forms (:mod:`~nbmf_mm_tpu_torch.ops.tiers`): every wrapper takes
``precision=`` and a bf16 ``Ym`` (with ``Yc``/``Ym2`` bf16 too).  f32 data
under ``None``/``"highest"`` runs the f32 instance (``csrc/sweep_dense.cu``);
``"high"`` the tensor-core instance whose product operands are all TF32
(``sweep_wgmma_tf32_dense.cu``, wgmma kernels of ``sweep_wgmma_tf32.cuh``);
``"default"`` the tensor-core instance whose product operands are all bf16
(``sweep_tiers_bf16r.cu``, wgmma kernels of ``sweep_wgmma.cuh``); bf16 data,
whatever ``precision`` says, the bf16-data instance on the tensor cores
(``sweep_bf16.cu``), with the W pass's ``1 - h`` formed from the bf16 ``h``.  A bf16 ``Ym`` on the card is never
widened to run another instance.  The plain versions round the same
operands by the same rules.

Each wrapper takes CPU tensors to its plain version and launches its kernel
for CUDA tensors, or raises; ``LAUNCHES`` counts the launches per operand
form (the key is the wrapper's name with the form's suffix,
:func:`tiers.suffix`) and ``LANES`` the lanes they carried;
``H_WS_LAUNCHES`` counts the float32 H-pass launches that ran the
warp-specialised block (:func:`cuda_sweep.h_warp_specialised`), as the
library's launcher reports them.  The three production
passes (not ``h_terms``) also take factors with a leading lane axis,
``W (R, k, Mp)`` with ``H (R, k, Np)``, over the same data, as the packed
passes do (:mod:`~nbmf_mm_tpu_torch.ops.cuda_sweep`): one launch for all
lanes, each bitwise the unbatched call.  ``bm`` is the stripe whose
bit-plane row order the kernels walk (the packed kernels' order, which keeps
the two bitwise equal); the plain versions do not need it.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_sweep as cs
from . import tiers

__all__ = [
    "LAUNCHES",
    "LANES",
    "H_WS_LAUNCHES",
    "hloss_terms_plain",
    "h_terms_plain",
    "w_terms_plain",
    "loglik_sum_plain",
    "hloss_terms",
    "h_terms",
    "w_terms",
    "loglik_sum",
]

LAUNCHES = {name + tiers.suffix(form): 0
            for name in ("hloss_terms", "h_terms", "w_terms", "loglik_sum") for form in tiers.FORMS}
LANES = {name: 0 for name in LAUNCHES if not name.startswith("h_terms")}
# Launches that ran the warp-specialised float32 H pass (k = 129..256), by
# wrapper, as the library reports them.
H_WS_LAUNCHES = {"hloss_terms": 0, "h_terms": 0}


# ------------------------------------------------------------ plain versions
def _operands(W, H, Ym, Y2, precision):
    """``(form, rounded W, rounded H, Ym, Y2)`` of a plain version: the
    form of ``precision`` over ``Ym``'s dtype, the factors rounded by it, and
    bf16 data widened (exactly) to the factors' dtype."""
    form = tiers.operand_form(precision, Ym.dtype)
    widen = lambda A: None if A is None else A.to(W.dtype)
    return (form, tiers.mxu_round(W, form), tiers.mxu_round(H, form), widen(Ym),
            widen(Y2))


def _masked_ll(Ym, yc, a, b, m_real, n_real):
    """``sum(ym log a + yc log b)`` over the real region, added in f64."""
    Mp, Np = Ym.shape
    rows = torch.arange(Mp, device=Ym.device)[:, None] < m_real
    cols = torch.arange(Np, device=Ym.device)[None, :] < n_real
    ll = Ym * torch.log(a) + yc * torch.log(b)
    return torch.where(rows & cols, ll, 0.0).sum(dtype=torch.float64).to(a.dtype)


def hloss_terms_plain(W, H, Ym, Yc=None, *, eps, m_real, n_real, precision=None):
    """Plain PyTorch version of the dense H pass: ``(Num, Den, ll)``."""
    form, W, H, Ym, Yc = _operands(W, H, Ym, Yc, precision)
    a, b, r = cs._ratio_terms(W, H, eps, form)
    yc = 1.0 - Ym if Yc is None else Yc
    p = tiers.mxu_round(Ym * (b * r), form)
    q = tiers.mxu_round(yc * (a * r), form)
    return W @ p, W @ q, _masked_ll(Ym, yc, a, b, m_real, n_real)


def h_terms_plain(W, H, Ym, Yc=None, *, eps, precision=None):
    """Plain PyTorch version of ``h_terms``: ``(Num, Den)`` without ll."""
    form, W, H, Ym, Yc = _operands(W, H, Ym, Yc, precision)
    a, b, r = cs._ratio_terms(W, H, eps, form)
    yc = 1.0 - Ym if Yc is None else Yc
    return (W @ tiers.mxu_round(Ym * (b * r), form),
            W @ tiers.mxu_round(yc * (a * r), form))


def w_terms_plain(W, H_new, Ym, Ym2=None, *, eps, n_real, precision=None):
    """Plain PyTorch version of the dense W pass: ``T (k, Mp)``."""
    form, Wr, H, Ym, Ym2 = _operands(W, H_new, Ym, Ym2, precision)
    a, b, r = cs._ratio_terms(Wr, H, eps, form)
    if Ym2 is None:
        cols = torch.arange(Ym.shape[1], device=Ym.device)[None, :] < n_real
        Ym2 = torch.where(cols, 1.0 - Ym, 0.0)
    p = tiers.mxu_round(Ym * (b * r), form)
    q = tiers.mxu_round(Ym2 * (a * r), form)
    # Two nonnegative products; never H (P - Q)^T + sum Q (cancellation).
    return H @ p.T + tiers.complement(H_new, form) @ q.T


def loglik_sum_plain(W, H, Ym, Yc=None, *, eps, m_real, n_real, precision=None):
    """Plain PyTorch version of ``loglik_sum``: the H pass's ``ll`` alone."""
    form, W, H, Ym, Yc = _operands(W, H, Ym, Yc, precision)
    a, b, _ = cs._ratio_terms(W, H, eps, form)
    yc = 1.0 - Ym if Yc is None else Yc
    return _masked_ll(Ym, yc, a, b, m_real, n_real)


# ------------------------------------------------------------------ wrappers
def _checked(wrapper, W, H, y, y2, bm, precision, *, batched=False):
    """``(counter name, C entry point, lane count)`` of the form that
    ``precision`` and ``y``'s dtype select, after the launch checks: for
    ``hloss_terms`` on bf16 data, ``hloss_terms_bf16d`` and
    ``nbmf_hloss_terms_dense_bf16d``."""
    end = tiers.suffix(tiers.operand_form(precision, y.dtype))
    lanes = cs._check_cuda_operands(wrapper + end, W, H, y, y2, bm, dense=True,
                                    batched=batched, bf16=y.dtype == torch.bfloat16)
    return wrapper + end, f"nbmf_{wrapper}_dense{end}", lanes


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
    precision=None,
):
    """Fused dense H-update + loss pass: ``(Num, Den, ll)``, each with the
    factors' leading lane axis when they have one."""
    if W.device.type == "cpu":
        return cs.per_lane(hloss_terms_plain, W, H, Ym, Yc, eps=eps, m_real=m_real,
                           n_real=n_real, precision=precision)
    name, entry, lanes = _checked("hloss_terms", W, H, Ym, Yc, bm, precision, batched=True)
    out = cs._launch_hloss(entry, name, W, H, Ym, Yc, eps=eps, m_real=m_real,
                           n_real=n_real, bm=bm, split_counts=H_WS_LAUNCHES)
    LAUNCHES[name] += 1
    LANES[name] += lanes or 1
    return out


def h_terms(
    W: torch.Tensor,
    H: torch.Tensor,
    Ym: torch.Tensor,
    Yc: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-8,
    bm: int,
    precision=None,
):
    """Dense H-update contractions alone: ``(Num, Den)`` (``(k, Np)`` each),
    the JAX ``h_terms``; no caller in the library, timed by the measurement
    path.  On the card bitwise the ``Num``/``Den`` of :func:`hloss_terms`."""
    if cs.lane_count("h_terms", W, H) is not None:
        raise ValueError("h_terms: takes one pair of factors, W (k, Mp) and H (k, Np)")
    if W.device.type == "cpu":
        return h_terms_plain(W, H, Ym, Yc, eps=eps, precision=precision)
    name, entry, _ = _checked("h_terms", W, H, Ym, Yc, bm, precision)
    Mp, Np = Ym.shape
    num, den, _ = cs._launch_hloss(entry, name, W, H, Ym, Yc, eps=eps, m_real=Mp,
                                   n_real=Np, bm=bm, loss=False, split_counts=H_WS_LAUNCHES)
    LAUNCHES[name] += 1
    return num, den


def w_terms(
    W: torch.Tensor,
    H_new: torch.Tensor,
    Ym: torch.Tensor,
    Ym2: Optional[torch.Tensor] = None,
    *,
    eps: float,
    n_real: int,
    bm: int,
    precision=None,
) -> torch.Tensor:
    """Dense W-update contraction ``T = H P^T + (1 - H) Q^T`` (``(k, Mp)``,
    or ``(R, k, Mp)`` for factors with a leading lane axis)."""
    if W.device.type == "cpu":
        return cs.per_lane(w_terms_plain, W, H_new, Ym, Ym2, eps=eps, n_real=n_real,
                           precision=precision)
    name, entry, lanes = _checked("w_terms", W, H_new, Ym, Ym2, bm, precision, batched=True)
    T = cs._launch_wterms(entry, name, W, H_new, Ym, Ym2, eps=eps, n_real=n_real, bm=bm)
    LAUNCHES[name] += 1
    LANES[name] += lanes or 1
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
    precision=None,
) -> torch.Tensor:
    """Masked Bernoulli log-likelihood of ``(W, H)`` over the real region (a
    0-d tensor, or ``(R,)`` for factors with a leading lane axis); on the
    card bitwise the ``ll`` of :func:`hloss_terms`."""
    if W.device.type == "cpu":
        return cs.per_lane(loglik_sum_plain, W, H, Ym, Yc, eps=eps, m_real=m_real,
                           n_real=n_real, precision=precision)
    name, entry, lanes = _checked("loglik_sum", W, H, Ym, Yc, bm, precision, batched=True)
    _, _, ll = cs._launch_hloss(entry, name, W, H, Ym, Yc, eps=eps, m_real=m_real,
                                n_real=n_real, bm=bm, terms=False)
    LAUNCHES[name] += 1
    LANES[name] += lanes or 1
    return ll
