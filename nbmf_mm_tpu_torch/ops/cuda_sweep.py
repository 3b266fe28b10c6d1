"""Bit-packed sweep passes: packing, the planner, and the two kernel wrappers
(counterpart of the packed half of the JAX package's ``ops/pallas_sweep.py``).

Binary operands are packed 32 entries per int32 word in the stripe-local
bit-plane layout of the JAX package, kept bit-identical: for stripe block
``bm`` (a multiple of 32) and ``bmw = bm // 32``,

    word row w = j*bmw + i, bit b  <->  data row j*bm + b*bmw + i.

Because unpacked values are exactly 0/1, every per-entry formula of the
sweep collapses to a select (``p = where(bit, b*r, 0)``, one ``log`` of
``where(bit, a, b)``).

Each kernel has a wrapper with two routes, chosen by where its tensors lie:

- CPU tensors run the plain PyTorch version beside it (unpack, ``matmul``,
  ``where``) — that is how the tests exercise the fused solver loop;
- CUDA tensors launch the hand-written kernel in ``csrc/sweep_packed.cu`` on
  the current stream, or raise.  There is no fallback between the two.
  The launch helpers here also serve the dense wrappers of
  :mod:`~nbmf_mm_tpu_torch.ops.dense_sweep`.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that it
went through the kernels.  Pad handling: the data, W's pad columns and H's
pad columns are zero; the log-likelihood is masked exactly to
``row < m_real and col < n_real`` (the JAX packed kernel instead adds
``log(1 + eps)`` per pad entry).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "LAUNCHES",
    "PACKED_WORD_BITS",
    "round_up",
    "plan_packing",
    "pack_bits",
    "pack_bits_host",
    "unpack_bits",
    "apply_col_validity",
    "hloss_terms_packed",
    "w_terms_packed",
]

PACKED_WORD_BITS = 32
MAX_RANK = 256  # largest k the kernels take

LAUNCHES = {"hloss_terms_packed": 0, "w_terms_packed": 0}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_packing(m: int, n: int) -> Tuple[int, int, int]:
    """Packing geometry ``(bm, Mp, Np)`` for an ``(m, n)`` matrix.

    ``bm = 256`` when ``m >= 256``, else ``round_up(m, 32)``;
    ``Mp = round_up(m, bm)``; ``Np = round_up(n, 4)`` so each word row is a
    whole number of 16-byte vectors.  Any ``m`` plans (the JAX package's
    ``select_stripe`` rejects ``Mp = 128 (mod 256)``, e.g. ``m = 300``).
    """
    if m < 1 or n < 1:
        raise ValueError(f"plan_packing: empty matrix ({m}, {n})")
    bm = 256 if m >= 256 else round_up(m, PACKED_WORD_BITS)
    return bm, round_up(m, bm), round_up(n, 4)


def _check_stripe(Mp: int, bm: int, who: str) -> int:
    if bm < PACKED_WORD_BITS or bm % PACKED_WORD_BITS or Mp % bm:
        raise ValueError(f"{who}: invalid stripe {bm} for Mp={Mp}")
    return bm // PACKED_WORD_BITS


def pack_bits(Ymp: torch.Tensor, bm: int) -> torch.Tensor:
    """Pack a zero-padded binary ``(Mp, Np)`` tensor into ``(Mp//32, Np)``
    int32 words in the bit-plane layout for stripe ``bm``, on its device."""
    Mp, Np = Ymp.shape
    bmw = _check_stripe(Mp, bm, "pack_bits")
    planes = Ymp.reshape(Mp // bm, PACKED_WORD_BITS, bmw, Np)
    words = torch.zeros((Mp // bm, bmw, Np), dtype=torch.int32, device=Ymp.device)
    for b in range(PACKED_WORD_BITS):
        words |= (planes[:, b] != 0).to(torch.int32) << b
    return words.reshape(Mp // PACKED_WORD_BITS, Np)


def pack_bits_host(Ymp: np.ndarray, bm: int) -> np.ndarray:
    """NumPy mirror of :func:`pack_bits` — identical words, computed on the
    host (``np.packbits`` over a contiguous trailing 32-bit axis)."""
    Mp, Np = Ymp.shape
    bmw = _check_stripe(Mp, bm, "pack_bits_host")
    if not np.little_endian:  # pragma: no cover
        raise RuntimeError("pack_bits_host requires a little-endian host")
    bits = np.ascontiguousarray(Ymp, dtype=np.uint8).reshape(Mp // bm, PACKED_WORD_BITS, bmw, Np)
    bits = np.ascontiguousarray(np.moveaxis(bits, 1, -1))  # (S, bmw, Np, 32)
    # bitorder="little": byte j of each 4-byte group holds bits 8j..8j+7, so
    # the little-endian uint32 view has value bit b == plane bit b.
    words = np.packbits(bits, axis=-1, bitorder="little")  # (S, bmw, Np, 4) u8
    return words.view(np.uint32).view(np.int32).reshape(Mp // PACKED_WORD_BITS, Np)


def _unpack_planes(words: torch.Tensor, bm: int) -> torch.Tensor:
    """``(Mp//32, Np)`` words -> ``(Mp, Np)`` bool in original row order."""
    Mw, Np = words.shape
    Mp = Mw * PACKED_WORD_BITS
    bmw = _check_stripe(Mp, bm, "unpack_bits")
    w = words.reshape(Mp // bm, bmw, Np)
    planes = torch.stack([((w >> b) & 1).bool() for b in range(PACKED_WORD_BITS)], dim=1)
    return planes.reshape(Mp, Np)


def unpack_bits(words: torch.Tensor, bm: int, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: words back to a dense 0/1 ``(Mp, Np)``."""
    return _unpack_planes(words, bm).to(dtype)


def apply_col_validity(H: torch.Tensor, n_real: int) -> torch.Tensor:
    """Zero the pad columns (beyond ``n_real``) of a ``(k, Np)`` factor."""
    if H.shape[1] == n_real:
        return H
    col = torch.arange(H.shape[1], device=H.device)
    return torch.where(col < n_real, H, 0.0)


# ------------------------------------------------------------ plain versions
def _ratio_terms(W, H, eps):
    """``a = WH + eps``, ``b = max(1 - WH, 0) + eps``, ``r = 1/(a b)`` for
    the whole ``(Mp, Np)`` product — the formulas of the Pallas kernels."""
    wh = W.T @ H
    a = wh + eps
    b = torch.clamp_min(1.0 - wh, 0.0) + eps
    r = 1.0 / (a * b)
    return a, b, r


def hloss_terms_packed_plain(W, H, words, words2=None, *, eps, m_real, n_real, bm):
    """Plain PyTorch version of the K1 kernel: ``(Num, Den, ll)``."""
    bit = _unpack_planes(words, bm)
    a, b, r = _ratio_terms(W, H, eps)
    p = torch.where(bit, b * r, 0.0)
    if words2 is not None:
        bit2 = _unpack_planes(words2, bm)
        q = torch.where(bit2, a * r, 0.0)
        sel = torch.where(bit, a, torch.where(bit2, b, 1.0))
    else:
        q = torch.where(bit, 0.0, a * r)
        sel = torch.where(bit, a, b)
    Mp, Np = bit.shape
    rows = torch.arange(Mp, device=W.device)[:, None] < m_real
    cols = torch.arange(Np, device=W.device)[None, :] < n_real
    ll = torch.where(rows & cols, torch.log(sel), 0.0).sum(dtype=torch.float64)
    return W @ p, W @ q, ll.to(W.dtype)


def w_terms_packed_plain(W, H_new, words, words2=None, *, eps, n_real, bm):
    """Plain PyTorch version of the K2 kernel: ``T (k, Mp)``."""
    bit = _unpack_planes(words, bm)
    a, b, r = _ratio_terms(W, H_new, eps)
    if words2 is not None:
        bit2 = _unpack_planes(words2, bm)
    else:
        cols = torch.arange(bit.shape[1], device=W.device)[None, :] < n_real
        bit2 = ~bit & cols
    p = torch.where(bit, b * r, 0.0)
    q = torch.where(bit2, a * r, 0.0)
    # Two nonnegative products; never H (P - Q)^T + sum Q (cancellation).
    return H_new @ p.T + (1.0 - H_new) @ q.T


# ------------------------------------------------------------------ wrappers
def _check_cuda_operands(who, W, H, y, y2, bm, *, dense=False):
    """Device, type, contiguity and shape checks before a launch: ``y``/``y2``
    are int32 words ``(Mp//32, Np)``, or with ``dense`` f32 ``(Mp, Np)``."""
    if W.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {W.device}")
    k, Mp = W.shape
    Np = H.shape[1]
    dev = W.device
    y_dtype = torch.float32 if dense else torch.int32
    for name, t, dtype in (("W", W, torch.float32), ("H", H, torch.float32),
                           ("y", y, y_dtype), ("y2", y2, y_dtype)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, W on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{who}: {name} must be {dtype} on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if H.shape[0] != k:
        raise ValueError(f"{who}: H has {H.shape[0]} rows, W has {k}")
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"{who}: the CUDA kernel takes 1 <= k <= {MAX_RANK}, got k={k}")
    _check_stripe(Mp, bm, who)
    shape = (Mp, Np) if dense else (Mp // PACKED_WORD_BITS, Np)
    for name, t in (("y", y), ("y2", y2)):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} shape {tuple(t.shape)} != {shape}")


def _split_rows(Mw: int, Np: int, device) -> Tuple[int, int]:
    """``(rows_per_split, nsplit)`` of the H pass: split the ``Mw`` word rows
    across blocks until ~4 blocks per SM are in flight; the partial sums are
    then added in a fixed order by a second kernel."""
    col_tiles = -(-Np // 32)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(Mw, max(1, -(-4 * n_sm // col_tiles)))
    rows_per_split = -(-Mw // want)
    return rows_per_split, -(-Mw // rows_per_split)


def _raise_on_error(lib, who, err):
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err}: {lib.nbmf_error_string(err).decode()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_hloss(entry, who, W, H, y, y2, *, eps, m_real, n_real, bm, terms=True,
                  loss=True):
    """Allocate the outputs and scratch of an H-pass entry point (packed or
    dense; with ``terms=False`` the ll-only one, with ``loss=False`` one
    without ll) and launch it on the current stream.  Returns
    ``(Num, Den, ll)``, ``Num``/``Den`` None without terms, ``ll`` None
    without loss.  ``y`` may be None for an entry that reads no data."""
    from ._build import load_library

    lib = load_library()
    k, Mp = W.shape
    Np = H.shape[1]
    dev = W.device
    rows_per_split, nsplit = _split_rows(Mp // PACKED_WORD_BITS, Np, dev)
    ll = ll_part = None
    if loss:
        ll = torch.empty((), dtype=torch.float32, device=dev)
        ll_part = torch.empty(-(-Np // 32) * nsplit, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = (k, Mp, Np, bm, m_real, n_real, rows_per_split, float(eps), dev.index or 0, stream)
    num = den = num_part = den_part = None
    if terms:
        num = torch.empty((k, Np), dtype=torch.float32, device=dev)
        den = torch.empty_like(num)
        if nsplit > 1:
            num_part = torch.empty((nsplit, k, Np), dtype=torch.float32, device=dev)
            den_part = torch.empty_like(num_part)
        outs = (num.data_ptr(), den.data_ptr(), _ptr(num_part), _ptr(den_part))
    else:
        outs = ()
    err = getattr(lib, entry)(W.data_ptr(), H.data_ptr(), _ptr(y), _ptr(y2), *outs,
                              _ptr(ll_part), _ptr(ll), *tail)
    _raise_on_error(lib, who, err)
    return num, den, ll


def _launch_wterms(entry, who, W, H_new, y, y2, *, eps, n_real, bm, n_out=1):
    """Allocate ``T (n_out k, Mp)`` and launch a W-pass entry point on the
    current stream; ``y`` may be None for an entry that reads no data."""
    from ._build import load_library

    lib = load_library()
    k, Mp = W.shape
    T = torch.empty((n_out * k, Mp), dtype=torch.float32, device=W.device)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = getattr(lib, entry)(
        W.data_ptr(), H_new.data_ptr(), _ptr(y), _ptr(y2), T.data_ptr(),
        k, Mp, H_new.shape[1], bm, n_real, float(eps), W.device.index or 0, stream,
    )
    _raise_on_error(lib, who, err)
    return T


def hloss_terms_packed(
    W: torch.Tensor,
    H: torch.Tensor,
    words: torch.Tensor,
    words2: Optional[torch.Tensor] = None,
    *,
    eps: float,
    m_real: int,
    n_real: int,
    bm: int,
):
    """Fused H-update + loss pass over packed words: ``(Num, Den, ll)``.

    ``W`` is ``(k, Mp)``, ``H`` is ``(k, Np)``, ``words`` packs ``Ym``.
    ``words2=None`` takes the complement ``1 - Ym`` (unmasked and parity);
    an explicit ``words2`` packing ``(1 - Y) * mask`` serves
    ``mask_mode="corrected"``.  ``ll`` is the log-likelihood summed over the
    real ``(m_real, n_real)`` region.
    """
    if W.device.type == "cpu":
        return hloss_terms_packed_plain(
            W, H, words, words2, eps=eps, m_real=m_real, n_real=n_real, bm=bm
        )
    _check_cuda_operands("hloss_terms_packed", W, H, words, words2, bm)
    out = _launch_hloss("nbmf_hloss_terms_packed", "hloss_terms_packed", W, H, words, words2,
                        eps=eps, m_real=m_real, n_real=n_real, bm=bm)
    LAUNCHES["hloss_terms_packed"] += 1
    return out


def w_terms_packed(
    W: torch.Tensor,
    H_new: torch.Tensor,
    words: torch.Tensor,
    words2: Optional[torch.Tensor] = None,
    *,
    eps: float,
    n_real: int,
    bm: int,
) -> torch.Tensor:
    """Packed W-update contraction ``T = H P^T + (1 - H) Q^T`` (``(k, Mp)``).

    ``words2=None`` synthesizes the unmasked complement with column validity;
    an explicit ``words2`` (packing ``(1 - Y) * mask``) serves both masked
    modes.
    """
    if W.device.type == "cpu":
        return w_terms_packed_plain(W, H_new, words, words2, eps=eps, n_real=n_real, bm=bm)
    _check_cuda_operands("w_terms_packed", W, H_new, words, words2, bm)
    T = _launch_wterms("nbmf_w_terms_packed", "w_terms_packed", W, H_new, words, words2,
                       eps=eps, n_real=n_real, bm=bm)
    LAUNCHES["w_terms_packed"] += 1
    return T
