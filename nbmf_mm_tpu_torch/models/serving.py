"""Serving: fold-in of new rows against a fitted model (counterpart of the JAX
package's ``models/serving.py``).

:class:`FoldInServer` scores streams of new rows against a fixed
``components_``:

- **buckets**: a request's rows pad up to the next of a few row counts and
  requests beyond the top bucket are chunked by it; pad rows are all-zero
  observations with a zero mask, sliced away afterwards.  Given a fixed H
  each row's fold-in is independent of the others (every contraction runs
  over the feature axis), so padding never changes a real row;
- the fold-in is the reference's 50-iteration multiplicative W update, and
  its contraction is exactly the solver's W pass: an exactly-binary chunk is
  packed on the host (:func:`~nbmf_mm_tpu_torch.ops.cuda_sweep.pack_bits_host`,
  1/32 of the f32 bytes cross to the card) and streams through
  ``w_terms_packed`` every iteration; any other chunk (``[0, 1]`` values, a
  weighted mask) streams dense through ``w_terms``.  The two give bitwise
  the same results on binary chunks;
- outputs: the simplex weights ``W`` and each row's mean observed Bernoulli
  log-likelihood, computed once after the loop with ``torch.matmul`` (the
  JAX package computes it outside any kernel too, pinned to DEFAULT; here it
  stays an fp32 product whatever the tier);
- ``precision`` is the product tier of every fold-in iteration, on the
  kernels and on the plain fold-in (:mod:`~nbmf_mm_tpu_torch.ops.tiers`), and
  ``dtype="bfloat16"`` stores each chunk's ``Ym``/``Ym2`` bf16 on the kernel
  route, never packed, through the bf16-data W pass; the factors stay
  float32.  (The JAX package's bf16 serving computes the factors in bf16
  too.)

``scipy.sparse`` requests densify one chunk at a time.  On the CPU the
kernel wrappers run their plain versions, as everywhere in this package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_sweep as cs
from ..ops import dense_sweep as ds
from ..ops.updates import fold_in_w_update
from ..solver.driver import (
    _check_interpret,
    _check_mesh,
    _resolve_backend,
    _resolve_dtype,
    _resolve_precision,
    ieee_fp32_products,
)
from ..utils import debugging
from ..utils.validation import check_is_fitted, densify

__all__ = ["FoldInServer", "fold_in_fused"]

_EPS = 1e-8  # the fold-in's eps (FoldInServer's, and fold_in_fused's default)


def _host_binary(A: np.ndarray) -> bool:
    return bool(((A == 0) | (A == 1)).all())


def _fold_in_chunk(Hp, A, B, W0t, *, route: str, packed: bool, n_iter: int, n_real: int,
                   bm: int, precision: str = "highest", eps: float = _EPS):
    """Fold-in on padded operands: ``(W (Bp, k), per-row loglik (Bp,))``,
    every iteration's products under the tier ``precision``.

    ``packed``: ``A``/``B`` are int32 words of ``Ym = X*mask`` /
    ``Ym2 = (1-X)*mask`` and every iteration streams them through
    ``w_terms_packed``; the single scoring pass unpacks them once.
    Otherwise ``A``/``B`` are the dense ``Ym``/``Ym2`` (bf16 in the bf16-data
    mode) and the iterations go through ``w_terms`` (``route="fused"``) or
    the plain
    :func:`~nbmf_mm_tpu_torch.ops.updates.fold_in_w_update`
    (``route="plain"``).  Contract: ``Hp (k, Np)`` with zero pad columns;
    operands zero in pad rows and columns; ``W0t (k, Bp)`` with zero pad
    columns, which the multiplicative updates keep exactly zero.
    """
    kw = dict(eps=eps, n_real=n_real, bm=bm, precision=precision)
    if packed:
        Ym = cs.unpack_bits(A, bm, W0t.dtype)
        Ym2 = cs.unpack_bits(B, bm, W0t.dtype)
        contraction = lambda Wt: cs.w_terms_packed(Wt, Hp, A, B, **kw)
    else:
        contraction = lambda Wt: ds.w_terms(Wt, Hp, A, B, **kw)
        Ym, Ym2 = A.to(W0t.dtype), B.to(W0t.dtype)  # bf16 data widens exactly
    Wt = W0t
    check_nan = debugging.nan_checks_enabled()
    for it in range(n_iter):
        if route == "plain":
            Wt = fold_in_w_update(Wt, Hp, Ym, Ym2, n_features=n_real, eps=eps,
                                  precision=precision)
        else:
            Wt = Wt * contraction(Wt) / n_real
            col = Wt.sum(dim=0, keepdim=True)
            Wt = Wt / torch.where(col > 0, col, 1.0)
        if check_nan:
            debugging.check_finite("fold-in loop", it, W=Wt)
    W = torch.clamp(Wt.T, 1e-8, 1.0)
    W = W / W.sum(dim=1, keepdim=True)
    R = W @ Hp
    ll = Ym * torch.log(R + _EPS) + Ym2 * torch.log(torch.clamp_min(1.0 - R, 0.0) + _EPS)
    n_obs = torch.clamp_min((Ym + Ym2).sum(dim=1), 1.0)
    scores = ll.sum(dim=1) / n_obs
    if check_nan:
        debugging.check_finite("fold-in loop", n_iter - 1, loglik=scores)
    return W, scores


def _stage_chunk(X, mask, *, rows_padded: int, n_cols: int, bm: int, dtype: torch.dtype,
                 device: torch.device, route: str, packed: Optional[bool], data_dtype=None):
    """Pad a chunk on the host and move it to ``device``: packed words when
    the fused route may pack and the chunk is exactly binary, else the
    dense ``Ym``/``Ym2``, formed in bf16 on ``device`` when ``data_dtype``
    is bf16 (which never packs).  Returns ``(A, B, use_packed)``."""
    rows, n_features = X.shape
    host_dtype = np.float32 if dtype == torch.float32 else np.float64
    Xp = np.zeros((rows_padded, n_cols), dtype=host_dtype)
    Xp[:rows, :n_features] = X
    mp = np.zeros((rows_padded, n_cols), dtype=host_dtype)
    mp[:rows, :n_features] = 1.0 if mask is None else mask
    binary = (route == "fused" and packed is not False and data_dtype is None
              and _host_binary(Xp) and _host_binary(mp))
    if packed is True and not binary:
        raise ValueError("packed=True requires exactly binary data (and mask) in every chunk")
    if binary:
        observed = mp != 0
        A = torch.from_numpy(cs.pack_bits_host((Xp != 0) & observed, bm)).to(device)
        B = torch.from_numpy(cs.pack_bits_host((Xp == 0) & observed, bm)).to(device)
        return A, B, True
    Xt = torch.from_numpy(Xp).to(device).to(data_dtype or dtype)
    mt = torch.from_numpy(mp).to(device).to(data_dtype or dtype)
    return Xt * mt, (1.0 - Xt) * mt, False


def _padded_H(H, dtype: torch.dtype, device: torch.device, Np: int) -> torch.Tensor:
    H = H if isinstance(H, torch.Tensor) else torch.as_tensor(np.asarray(H))
    H = H.to(device=device, dtype=dtype)
    return torch.nn.functional.pad(H, (0, Np - H.shape[1])).contiguous()


def _zero_pad_columns(W0t: torch.Tensor, rows: int) -> torch.Tensor:
    W0t = W0t.clone()
    W0t[:, rows:] = 0.0
    return W0t


@ieee_fp32_products()
def fold_in_fused(
    H,
    X,
    mask=None,
    W0t=None,
    *,
    n_iter: int = 50,
    dtype=None,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    interpret: bool = False,
    packed: Optional[bool] = None,
    random_state: int = 0,
    eps: float = _EPS,
    mxu_precision=None,
    device="cuda",
):
    """One-shot fused fold-in of ``X (rows, n_features)`` against a fixed
    ``H (k, n_features)``, through the serving kernels without the buckets.

    Used by ``NBMF.transform``'s fused route, whose caller supplies the
    seeded start ``W0t (k, rows)`` (internal layout); without one it is
    drawn U(0.1, 0.9) from ``random_state``.  ``packed`` follows the
    ``solve`` contract: ``None`` packs an exactly-binary batch, ``True``
    requires it, ``False`` streams dense.  ``eps`` is the iterations' eps
    (the per-row scores keep 1e-8, as in the JAX package);
    ``mxu_precision`` the kernels' product tier; ``dtype="bfloat16"``
    stores the batch bf16 and is never packed.  ``block_m``/``block_n``
    (the JAX package's tile sizes) are accepted and ignored: the port plans
    its own tiling; ``interpret=True`` is what CPU tensors do anyway and
    raises ``ValueError`` on a CUDA device.  Returns ``(W (rows, k),
    per_row_loglik (rows,))`` as numpy arrays.
    """
    dtype, data_dtype = _resolve_dtype(dtype)
    tier = _resolve_precision(mxu_precision, data_dtype)
    device = cs.resolve_device(device)
    _check_interpret(interpret, device, "interpret")
    k = H.shape[0]
    route = _resolve_backend("fused", dtype, device, True, k=k)
    if packed is True and data_dtype is not None:
        raise ValueError("packed=True is incompatible with dtype='bfloat16': packing replaces "
                         "the data stream (and is both smaller and exact)")
    X = np.asarray(densify(X))
    if mask is not None:
        mask = np.asarray(densify(mask))
    rows, n_features = X.shape
    bm, Bp, Np = cs.plan_packing(rows, n_features)
    if W0t is None:
        gen = torch.Generator().manual_seed(int(random_state))
        W0t = torch.rand((k, rows), generator=gen, dtype=dtype) * 0.8 + 0.1
    W0t_full = torch.zeros((k, Bp), dtype=dtype)
    W0t_full[:, :rows] = torch.as_tensor(W0t, dtype=dtype)
    A, B, use_packed = _stage_chunk(X, mask, rows_padded=Bp, n_cols=Np, bm=bm, dtype=dtype,
                                    device=device, route=route, packed=packed,
                                    data_dtype=data_dtype)
    W, scores = _fold_in_chunk(_padded_H(H, dtype, device, Np), A, B, W0t_full.to(device),
                               route=route, packed=use_packed, n_iter=n_iter,
                               n_real=n_features, bm=bm, precision=tier, eps=eps)
    return W[:rows].cpu().numpy(), scores[:rows].cpu().numpy()


class FoldInServer:
    """Shape-bucketed fold-in against a fitted model.

    Parameters
    ----------
    model_or_H : a fitted port ``NBMF``, a ``SolverResult`` (from ``solve``),
        or a ``(k, n_features)`` array or tensor
    n_iter : fold-in iterations (the reference uses a fixed 50)
    buckets : ascending row counts; requests pad to the next bucket and
        chunk by the largest.  Default: 64..8192.
    random_state : seed of each bucket's U(0.1, 0.9) start ``(k, bucket)``
    dtype : ``"float32"`` (default), ``"float64"`` or ``"bfloat16"``: on the
        kernel route each chunk's ``Ym``/``Ym2`` stored bf16 and never
        packed (the bf16-data W pass), the factors float32; on the plain
        route the data stays float32 and the tier is ``"default"``
    precision : the product tier of every iteration (``None``/``"highest"``
        IEEE fp32, ``"high"`` TF32-rounded operands, ``"default"``
        bf16-rounded operands; ``ops.tiers``), on the kernels and on the
        plain fold-in alike, on the CPU too (where the JAX package computes
        every tier in fp32)
    backend : {"auto", "fused", "plain"} — ``"auto"`` serves through the
        kernels for float32 on a CUDA device at a rank within the kernels'
        cap and through the plain fold-in otherwise; ``"fused"`` raises for
        a rank above the cap (see ``solve``); the JAX package's ``"pallas"``
        and ``"jnp"`` stand for ``"fused"`` and ``"plain"``
    block_m, block_n : the JAX package's tile sizes, accepted and ignored
        (the port plans its own tiling)
    pallas_interpret : ``True`` is what CPU tensors do anyway (the kernels'
        plain versions); on a CUDA device it raises ``ValueError``
    packed : ``None`` (default) packs each exactly-binary chunk on the host
        and streams its words through ``w_terms_packed``, and streams every
        other chunk dense through ``w_terms``; ``True`` requires every chunk
        to be exactly binary and raises otherwise (and with
        ``dtype="bfloat16"``); ``False`` streams dense.  Packed and dense
        results are bitwise equal, in every tier.
    mesh, mesh_axes : not ported yet (``mesh`` raises; ``mesh_axes`` is
        stored, and checked only with ``mesh``)
    device : where the fold-in runs (default ``"cuda"``)
    """

    def __init__(
        self,
        model_or_H,
        *,
        n_iter: int = 50,
        buckets: Tuple[int, ...] = (64, 256, 1024, 4096, 8192),
        random_state: Optional[int] = 0,
        dtype=None,
        precision=None,
        backend: str = "auto",
        block_m: Optional[int] = None,
        block_n: Optional[int] = None,
        pallas_interpret: bool = False,
        mesh=None,
        mesh_axes: Tuple[str, str] = ("rows", "cols"),
        packed: Optional[bool] = None,
        device="cuda",
    ):
        _check_mesh(mesh, mesh_axes, "FoldInServer(mesh=...)")
        self.block_m, self.block_n = block_m, block_n
        self.pallas_interpret = pallas_interpret
        self.mesh, self.mesh_axes = mesh, mesh_axes
        if hasattr(model_or_H, "n_components"):  # an estimator
            check_is_fitted(model_or_H, ["components_"])
            H = model_or_H.components_
        elif hasattr(model_or_H, "H") and hasattr(model_or_H, "losses"):  # a SolverResult
            H = model_or_H.H
        else:
            H = model_or_H
        self.dtype, data_dtype = _resolve_dtype(dtype)
        self.precision = _resolve_precision(precision, data_dtype)
        self.device = cs.resolve_device(device)
        _check_interpret(pallas_interpret, self.device)
        self.k, self.n_features = H.shape
        self.route = _resolve_backend(backend, self.dtype, self.device, True, packed, self.k)
        if packed is True and data_dtype is not None:
            raise ValueError("packed=True is incompatible with dtype='bfloat16': packing "
                             "replaces the data stream (and is both smaller and exact)")
        # bf16 storage is the kernels'; the plain fold-in keeps float32 data.
        self.data_dtype = data_dtype if self.route == "fused" else None
        self.packed = packed
        self.n_iter = int(n_iter)
        self.buckets = tuple(sorted(buckets))
        self.random_state = 0 if random_state is None else int(random_state)
        self._Np = cs.round_up(self.n_features, 4)
        self.H = _padded_H(H, self.dtype, self.device, self._Np)

    def _bucket(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def _serve_chunk(self, X, mask):
        rows = X.shape[0]
        bm, Bp, _ = cs.plan_packing(self._bucket(rows), self.n_features)
        gen = torch.Generator().manual_seed(self.random_state)
        W0t = torch.rand((self.k, Bp), generator=gen, dtype=self.dtype) * 0.8 + 0.1
        A, B, use_packed = _stage_chunk(X, mask, rows_padded=Bp, n_cols=self._Np, bm=bm,
                                        dtype=self.dtype, device=self.device, route=self.route,
                                        packed=self.packed, data_dtype=self.data_dtype)
        W, scores = _fold_in_chunk(self.H, A, B, _zero_pad_columns(W0t, rows).to(self.device),
                                   route=self.route, packed=use_packed, n_iter=self.n_iter,
                                   n_real=self.n_features, bm=bm, precision=self.precision)
        return W[:rows].cpu().numpy(), scores[:rows].cpu().numpy()

    @ieee_fp32_products()
    def transform(self, X, mask=None):
        """Fold in new rows; returns ``(W, per_row_loglik)`` as numpy arrays.

        Requests larger than the top bucket are chunked.  ``X``/``mask`` may
        be ``scipy.sparse``: rows densify one chunk at a time, so peak host
        memory is one bucket's dense staging.
        """
        sparse_in = hasattr(X, "toarray") and not isinstance(X, np.ndarray)
        X = X.tocsr() if sparse_in else np.asarray(X)
        mask_sparse = mask is not None and hasattr(mask, "toarray") and not isinstance(
            mask, np.ndarray)
        if mask is not None:
            mask = mask.tocsr() if mask_sparse else np.asarray(mask)
        if X.shape[0] == 0:  # empty batch: well-defined empty result
            return np.zeros((0, self.k)), np.zeros((0,))
        top = self.buckets[-1]
        Ws, Ss = [], []
        for start in range(0, X.shape[0], top):
            sl = slice(start, start + top)
            Xc = X[sl].toarray() if sparse_in else X[sl]
            mc = None if mask is None else (mask[sl].toarray() if mask_sparse else mask[sl])
            W, s = self._serve_chunk(Xc, mc)
            Ws.append(W)
            Ss.append(s)
        return np.concatenate(Ws, axis=0), np.concatenate(Ss, axis=0)

    def warmup(self):
        """Run every bucket once through every variant a request can take —
        with ``packed=None`` on the kernel route a binary request takes the
        packed kernel and a weighted-mask request the dense one — so the
        kernel library is built and loaded before the first request."""
        for b in self.buckets:
            zeros = np.zeros((b, self.n_features))
            self._serve_chunk(zeros, None)
            if self.route == "fused" and self.packed is None and self.data_dtype is None:
                self._serve_chunk(zeros, np.full_like(zeros, 0.5))
        return self
