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

Restarts and hyperparameter grids batch the factors: every wrapper also takes
``W (R, k, Mp)`` with ``H (R, k, Np)`` over the same data and returns outputs
with that leading lane axis (``ll`` of shape ``(R,)``), the batch dimension
``jax.vmap`` gives the Pallas kernels.  On the card all lanes go through one
launch (the lane is a grid dimension of the kernels) on the block split of
the unbatched call, so lane ``r`` equals the unbatched call on
``(W[r], H[r])`` bitwise; the plain version of a batched call is the
unbatched plain version lane by lane (:func:`per_lane`), so the same holds
on the CPU.

Both wrappers take ``precision=`` (``None``/``"highest"``, ``"high"``,
``"default"``; :mod:`~nbmf_mm_tpu_torch.ops.tiers` defines the tiers): a
reduced tier launches the tensor-core instance that rounds every product
operand (``nbmf_*_packed_tf32r``, ``nbmf_*_packed_bf16r``), from copies of
the factors staged per call (:func:`plan_wgmma`; :func:`stage_bf16`,
:func:`stage_tf32`), and the plain version rounds the same operands by the
same rules.

``LAUNCHES`` counts kernel launches per wrapper and operand form (the key is
the wrapper's name with the form's suffix, :func:`tiers.suffix`) and
``LANES`` the lanes those launches carried, so a run can show that it went
through the kernels, in which form and with how many lanes;
``H_WS_LAUNCHES`` counts the launches that ran the warp-specialised fp32 H
pass (:func:`h_warp_specialised`), as the library's launcher reports them.
Pad handling: the data, W's pad columns and H's pad columns are zero; the
log-likelihood is masked exactly to ``row < m_real and col < n_real`` (the
JAX packed kernel instead adds ``log(1 + eps)`` per pad entry).
"""

from __future__ import annotations

import ctypes
import functools

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import tiers

__all__ = [
    "LAUNCHES",
    "LANES",
    "H_WS_LAUNCHES",
    "MAX_LANES",
    "per_lane",
    "PACKED_WORD_BITS",
    "resolve_device",
    "round_up",
    "plan_packing",
    "pack_bits",
    "pack_bits_host",
    "unpack_bits",
    "apply_col_validity",
    "bitplane_rows",
    "blocks_per_sm",
    "w_blocks_per_sm",
    "w_warp_specialised",
    "h_warp_specialised",
    "even_chunks",
    "WSplit",
    "column_chunks",
    "plan_w_split",
    "HSplit",
    "plan_h_split",
    "WGMMA_FORMS",
    "TF32_FORMS",
    "WgmmaPlan",
    "plan_wgmma",
    "WgmmaShape",
    "wgmma_shape",
    "stage_w_bf16_plain",
    "stage_h_bf16_plain",
    "stage_bf16",
    "SLOT8",
    "phase_b_order",
    "stage_tf32_plain",
    "stage_tf32",
    "tf32_occupancy",
    "hloss_terms_packed",
    "w_terms_packed",
]

PACKED_WORD_BITS = 32
MAX_RANK = 256  # largest k the kernels take

MAX_LANES = 65535  # largest lane count one launch takes (a grid dimension)

# The packed kernels' forms: the tiers over words (bf16 data never packs).
PACKED_FORMS = ("f32", "bf16r", "tf32r")
LAUNCHES = {name + tiers.suffix(form): 0 for name in ("hloss_terms_packed", "w_terms_packed")
            for form in PACKED_FORMS}
LANES = dict(LAUNCHES)
# Launches that ran the warp-specialised fp32 H pass (k = 129..256), by
# wrapper, as the library reports them (:func:`_split_launches`).
H_WS_LAUNCHES = {"hloss_terms_packed": 0}

# The W pass's block (csrc/sweep_kernels.cuh ``wpass_kernel``): 64 data rows
# (two word rows) by a column chunk walked in 32-column tiles.
W_ROWS = 64
W_TILE = 32
# The H pass's block (``hpass_kernel``): 64 columns by a chunk of word rows
# walked one word row (32 data rows) at a time.
H_COLS = 64
WAVES = 2  # rounds of resident blocks each pass's grid should fill at least
# A warp-specialised W-pass block's own cost (filling its pipeline, staging
# W, the epilogue), in 32-column tiles of its walk.
W_BLOCK_TILES = 4
# The operand forms whose passes run on the tensor cores from bf16 copies
# (csrc/sweep_wgmma.cuh): every product operand bf16, so a product is one
# wgmma.
WGMMA_FORMS = ("bf16r", "bf16d")
# The form that runs on the tensor cores from TF32 copies in two orders
# (csrc/sweep_wgmma_tf32.cuh): every product operand TF32.
TF32_FORMS = ("tf32r",)
# Physical slot j of each group of 8 in a TF32 phase-B copy holds logical
# index SLOT8[j]: the K indices of the m64nNk8.tf32 A fragment (t, t + 4)
# against those of the accumulator it is taken from (2t, 2t + 1).
SLOT8 = (0, 2, 4, 6, 1, 3, 5, 7)


def resolve_device(device) -> torch.device:
    """An explicit device; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be a CPU or CUDA device, got {device}")
    return device


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


def bitplane_rows(Mp: int, bm: int, device=None) -> torch.Tensor:
    """Data row of each bit in word-row order: entry ``32 w + b`` is the row
    that bit ``b`` of word row ``w`` holds for stripe ``bm`` (the order in
    which :func:`unpack_bits` reads the words back).  The H-pass kernel reads
    ``W[:, bitplane_rows(Mp, bm)]``, a copy it makes once per call, so that
    each word row's 32 data rows are contiguous."""
    bmw = _check_stripe(Mp, bm, "bitplane_rows")
    w = torch.arange(Mp // PACKED_WORD_BITS, device=device)[:, None]
    b = torch.arange(PACKED_WORD_BITS, device=device)[None, :]
    j = w // bmw
    return (j * bm + (w - j * bmw) + b * bmw).reshape(Mp)


def apply_col_validity(H: torch.Tensor, n_real: int) -> torch.Tensor:
    """Zero the pad columns (beyond ``n_real``) of a ``(..., k, Np)`` factor."""
    if H.shape[-1] == n_real:
        return H
    col = torch.arange(H.shape[-1], device=H.device)
    return torch.where(col < n_real, H, 0.0)


# ------------------------------------------------------------ plain versions
def _ratio_terms(W, H, eps, form="f32"):
    """``a = WH + eps``, ``b = max(1 - WH, 0) + eps``, ``r = 1/(a b)`` for
    the whole ``(Mp, Np)`` product — the formulas of the Pallas kernels —
    with ``WH`` formed as :func:`tiers.wh_product` forms it under ``form``."""
    wh = tiers.wh_product(W.T, H, form)
    a = wh + eps
    b = torch.clamp_min(1.0 - wh, 0.0) + eps
    r = 1.0 / (a * b)
    return a, b, r


def hloss_terms_packed_plain(W, H, words, words2=None, *, eps, m_real, n_real, bm,
                             precision=None):
    """Plain PyTorch version of the K1 kernel: ``(Num, Den, ll)``, each
    product operand rounded as the ``precision`` tier says."""
    form = tiers.operand_form(precision)
    W = tiers.mxu_round(W, form)
    bit = _unpack_planes(words, bm)
    a, b, r = _ratio_terms(W, tiers.mxu_round(H, form), eps, form)
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
    return W @ tiers.mxu_round(p, form), W @ tiers.mxu_round(q, form), ll.to(W.dtype)


def w_terms_packed_plain(W, H_new, words, words2=None, *, eps, n_real, bm, precision=None):
    """Plain PyTorch version of the K2 kernel: ``T (k, Mp)``, each product
    operand rounded as the ``precision`` tier says (``1 - H`` by
    :func:`tiers.complement`)."""
    form = tiers.operand_form(precision)
    bit = _unpack_planes(words, bm)
    H = tiers.mxu_round(H_new, form)
    a, b, r = _ratio_terms(tiers.mxu_round(W, form), H, eps, form)
    if words2 is not None:
        bit2 = _unpack_planes(words2, bm)
    else:
        cols = torch.arange(bit.shape[1], device=W.device)[None, :] < n_real
        bit2 = ~bit & cols
    p = tiers.mxu_round(torch.where(bit, b * r, 0.0), form)
    q = tiers.mxu_round(torch.where(bit2, a * r, 0.0), form)
    # Two nonnegative products; never H (P - Q)^T + sum Q (cancellation).
    return H @ p.T + tiers.complement(H_new, form) @ q.T


# ------------------------------------------------------------------ wrappers
def lane_count(who, W, H) -> Optional[int]:
    """``None`` for factors ``W (k, Mp)``, ``H (k, Np)``; ``R`` for batched
    factors ``W (R, k, Mp)``, ``H (R, k, Np)``; anything else raises."""
    if W.dim() == 2 and H.dim() == 2:
        return None
    if W.dim() != 3 or H.dim() != 3 or W.shape[0] != H.shape[0]:
        raise ValueError(f"{who}: W and H must be (k, Mp) and (k, Np), or (R, k, Mp) and "
                         f"(R, k, Np) with one R; got {tuple(W.shape)} and {tuple(H.shape)}")
    if not 1 <= W.shape[0] <= MAX_LANES:
        raise ValueError(f"{who}: one call takes 1 to {MAX_LANES} lanes, got {W.shape[0]}")
    return W.shape[0]


def per_lane(fn, W, H, *operands, **kw):
    """The plain version of a batched call: ``fn(W[r], H[r], *operands)``
    lane by lane, the outputs stacked.  It repeats the unbatched arithmetic
    exactly, so a lane equals the unbatched call bitwise.  Unbatched factors
    go straight to ``fn``."""
    lanes = lane_count(getattr(fn, "__name__", "per_lane"), W, H)
    if lanes is None:
        return fn(W, H, *operands, **kw)
    outs = [fn(W[r], H[r], *operands, **kw) for r in range(lanes)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(column) for column in zip(*outs))
    return torch.stack(outs)


def _check_cuda_operands(who, W, H, y, y2, bm, *, dense=False, batched=False, bf16=False):
    """Device, type, contiguity and shape checks before a launch: ``y``/``y2``
    are int32 words ``(Mp//32, Np)``, or with ``dense`` f32 ``(Mp, Np)``
    (bf16 with ``bf16``, the bf16-data instances).
    Factors with a leading lane axis pass only with ``batched`` (the five
    production passes).  Returns the lane count, ``None`` when unbatched."""
    if W.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {W.device}")
    lanes = lane_count(who, W, H)
    if lanes is not None and not batched:
        raise ValueError(f"{who}: takes one pair of factors, W (k, Mp) and H (k, Np)")
    k, Mp = W.shape[-2:]
    Np = H.shape[-1]
    dev = W.device
    y_dtype = (torch.bfloat16 if bf16 else torch.float32) if dense else torch.int32
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
    if H.shape[-2] != k:
        raise ValueError(f"{who}: H has {H.shape[-2]} rows, W has {k}")
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"{who}: the CUDA kernel takes 1 <= k <= {MAX_RANK}, got k={k}")
    _check_stripe(Mp, bm, who)
    shape = (Mp, Np) if dense else (Mp // PACKED_WORD_BITS, Np)
    for name, t in (("y", y), ("y2", y2)):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} shape {tuple(t.shape)} != {shape}")
    return lanes


class WSplit(NamedTuple):
    """The W pass's column split, as :func:`plan_w_split` plans it."""

    nsplit: int  # S, the column chunks (grid dimension y)
    chunks: Tuple[Tuple[int, int], ...]  # [begin, end) columns of chunk s, in order
    scratch: Optional[Tuple[int, int, int]]  # (S, n_out k, Mp) partials; None when S == 1
    blocks: int  # ceil(Mp / 64) row blocks times S
    waves: float  # blocks over the blocks the card holds at once


class HSplit(NamedTuple):
    """The H pass's row split, as :func:`plan_h_split` plans it."""

    nsplit: int  # S, the chunks of word rows (grid dimension y)
    chunks: Tuple[Tuple[int, int], ...]  # [begin, end) word rows of chunk s, in order
    scratch: Optional[Tuple[int, int, int]]  # (S, k, Np) partials of Num and Den; None when S == 1
    blocks: int  # ceil(Np / 64) column blocks times S
    waves: float  # blocks over the blocks the card holds at once


def blocks_per_sm(k: int) -> int:
    """Blocks of the H pass (and of the tensor-core W passes' planning) one
    SM holds at once: two while ``k <= 128`` (the kernels' launch bounds cap
    them at 128 registers a thread, and a block takes at most 112 KiB of
    shared memory), one above."""
    return 2 if k <= 128 else 1


def w_blocks_per_sm(k: int) -> int:
    """Blocks of the fp32 W pass one SM holds at once (``WPass::kMinBlocks``):
    two up to ``k = 64`` (256 threads of at most 128 registers, 72 KiB of
    shared memory a block), one above (at ``64 < k <= 128`` the
    warp-specialised block, 512 threads of at most 128 registers and up to
    224 KiB; above, 256 threads and up to 192 KiB)."""
    return 2 if k <= 64 else 1


def w_warp_specialised(k: int) -> bool:
    """Whether the fp32 W pass runs its warp-specialised block at ``k``
    (``WPass::kSplit``, ``64 < k <= 128``)."""
    return 64 < k <= 128


def h_warp_specialised(k: int) -> bool:
    """Whether the fp32 H pass runs its warp-specialised block at ``k``
    (``HPass::kSplit``, ``128 < k <= 256``: one producer and two consumer
    warpgroups, one block an SM, as :func:`blocks_per_sm` counts it)."""
    return 128 < k <= MAX_RANK


def even_chunks(n: int, nsplit: int) -> Tuple[Tuple[int, int], ...]:
    """``[begin, end)`` of ``nsplit`` runs of ``0..n``, in order, as the
    kernels cut them: the first ``n % nsplit`` take one unit more.  The H
    pass's chunks of word rows."""
    if not 1 <= nsplit <= n:
        raise ValueError(f"{nsplit} chunks of {n} units")
    base, extra = divmod(n, nsplit)
    chunks, t = [], 0
    for s in range(nsplit):
        chunks.append((t, t + base + (s < extra)))
        t = chunks[-1][1]
    return tuple(chunks)


def column_chunks(Np: int, nsplit: int) -> Tuple[Tuple[int, int], ...]:
    """``[begin, end)`` of each of ``nsplit`` column chunks of whole
    32-column tiles, as the W-pass kernels cut them: the first
    ``nt % nsplit`` chunks take one tile more than the rest; the last ends
    at ``Np``."""
    return tuple((b * W_TILE, min(Np, e * W_TILE))
                 for b, e in even_chunks(-(-Np // W_TILE), nsplit))


def _least_waste_split(units: int, other: int, slots: int, waves: int) -> int:
    """The split of ``units`` into chunks for a grid of ``other x S``
    blocks on ``slots`` resident blocks: ``S`` starts at the least count
    that gives ``waves`` rounds (at most one chunk per unit) and may grow to
    twice that where the last round and the chunks' unit counts waste less:
    blocks of one launch do equal work, so a round that is half full costs
    a full round."""
    s0 = min(units, -(-waves * slots // other))

    def used(s):
        blocks = other * s
        return blocks / (-(-blocks // slots) * slots) * units / (s * -(-units // s))

    return max(range(s0, min(units, 2 * s0) + 1), key=lambda s: (used(s), -s))


@functools.lru_cache(maxsize=None)
def _pipelined_split(units: int, other: int, slots: int) -> int:
    """The split of ``units`` tiles into chunks for a grid of ``other x S``
    warp-specialised blocks on ``slots`` resident blocks: the ``S`` of
    fewest rounds times tiles a block, each block's own cost counted as
    ``W_BLOCK_TILES`` more tiles (the smaller ``S`` on ties).  A block that
    walks few tiles spends its time filling its pipeline, so few rows take
    fewer, longer chunks than :func:`_least_waste_split` gives."""
    return min(range(1, units + 1),
               key=lambda s: (-(-other * s // slots) * (-(-units // s) + W_BLOCK_TILES), s))


def plan_w_split(Mp: int, Np: int, k: int, n_sm: int, n_out: int = 1, *,
                 tensor_cores: bool = False) -> WSplit:
    """Split the W pass's columns for its ``ceil(Mp/64) x S`` grid on
    ``n_sm`` SMs, counting the fp32 pass's resident blocks by
    :func:`w_blocks_per_sm` and the tensor-core forms' by
    :func:`blocks_per_sm`: for the warp-specialised block
    (:func:`w_warp_specialised`) by :func:`_pipelined_split`, else for at
    least ``WAVES`` rounds of resident blocks, wasting least
    (:func:`_least_waste_split`).  The partials are added in a fixed order
    by a second kernel, so every ``S`` gives a bitwise repeatable ``T``.
    """
    row_blocks = -(-Mp // W_ROWS)
    units = -(-Np // W_TILE)
    slots = n_sm * (blocks_per_sm(k) if tensor_cores else w_blocks_per_sm(k))
    if w_warp_specialised(k) and not tensor_cores:
        nsplit = _pipelined_split(units, row_blocks, slots)
    else:
        nsplit = _least_waste_split(units, row_blocks, slots, WAVES)
    blocks = row_blocks * nsplit
    return WSplit(nsplit, column_chunks(Np, nsplit),
                  (nsplit, n_out * k, Mp) if nsplit > 1 else None, blocks, blocks / slots)


def plan_h_split(Mp: int, Np: int, k: int, n_sm: int) -> HSplit:
    """Split the H pass's word rows so that its ``ceil(Np/64) x S`` grid
    fills ``n_sm`` SMs for at least ``WAVES`` rounds of resident blocks,
    wasting least (:func:`_least_waste_split`).  Num/Den partials and the ll
    partials are added in a fixed order by two more kernels, so every ``S``
    gives bitwise repeatable outputs.
    """
    col_blocks = -(-Np // H_COLS)
    slots = n_sm * blocks_per_sm(k)
    Mw = Mp // PACKED_WORD_BITS
    nsplit = _least_waste_split(Mw, col_blocks, slots, WAVES)
    blocks = col_blocks * nsplit
    return HSplit(nsplit, even_chunks(Mw, nsplit), (nsplit, k, Np) if nsplit > 1 else None,
                  blocks, blocks / slots)


class WgmmaPlan(NamedTuple):
    """The staged bf16 copies of the tensor-core forms, as :func:`plan_wgmma`
    plans them (``csrc/sweep_wgmma.cuh`` computes the same)."""

    kn: int  # phase B's width: the output k rows of one block (32, 64 or 128)
    nkb: int  # blocks over the output k (grid x): 1, or 2 above k = 128
    kstage: int  # k rows of the staged copies, kn * nkb (zero beyond k)
    Mps: int  # row length of W's bit-plane copy (zero beyond Mp)
    Nps: int  # row length of H's (and 1 - H's) copy (zero beyond Np)


def plan_wgmma(k: int, Mp: int, Np: int) -> WgmmaPlan:
    """Geometry of the tensor-core passes' bf16 copies for rank ``k``: the
    phase-B width ``kn`` (the smallest of 32, 64, 128 that holds ``k``, 128
    above), ``ceil(k / kn)`` blocks over the output k, and rows padded past
    ``Mp + 32``/``Np + 32`` to a multiple of 64 elements, so every 64-wide
    tile a step reads (two word rows from any word row, 64 columns from any
    32-column boundary) lies inside its row and starts on 16 bytes."""
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"plan_wgmma: the kernels take 1 <= k <= {MAX_RANK}, got k={k}")
    kn = 32 if k <= 32 else 64 if k <= 64 else 128
    nkb = -(-k // kn)
    return WgmmaPlan(kn, nkb, kn * nkb, round_up(Mp + 32, 64), round_up(Np + 32, 64))


class WgmmaShape(NamedTuple):
    """A tensor-core pass's steps and the shared memory a block asks for, as
    its launcher plans them (``csrc/sweep_wgmma.cuh``, ``sweep_wgmma_tf32.cuh``)."""

    step: int  # data rows (H pass) or columns (W pass) of one step
    stages_a: int  # stages of the streamed phase-A tile
    stages_b: int  # stages of the phase-B tiles (0: phase B reads phase A's tile)
    h_smem: int  # bytes of an H-pass block with phase B (loglik_sum takes less)
    w_smem: int  # bytes of a W-pass block


def wgmma_shape(k: int, form: str) -> WgmmaShape:
    """The steps and shared memory of the tensor-core passes of ``form`` at
    rank ``k``.  The bf16 forms step 64 wide and read one 128-byte-swizzled
    copy of each tile in both phases.  TF32 takes twice the bytes and two
    layouts (wgmma reads TF32 only K-major), so its steps are 32 wide, the
    phase-A tile streams in two stages and the phase-B tiles in one: the
    resident 64-row phase-A tile, two 32-row ones, one ``[kn][32]`` phase-B
    tile in the H pass and two in the W pass, 4 bytes a value.  Each adds
    1024 bytes for aligning the tiles to the swizzle's 1024-byte period."""
    plan = plan_wgmma(k, PACKED_WORD_BITS, 4)
    if form in WGMMA_FORMS:
        row = 128  # a 64-wide bf16 row of a tile
        return WgmmaShape(64, 2, 0, 3 * plan.kstage * row + 1024, 5 * plan.kstage * row + 1024)
    if form not in TF32_FORMS:
        raise ValueError(f"wgmma_shape: no tensor-core form {form!r}")
    phase_a = 4 * (64 + 2 * 32) * plan.kstage
    return WgmmaShape(32, 2, 1, phase_a + 4 * plan.kn * 32 + 1024,
                      phase_a + 2 * 4 * plan.kn * 32 + 1024)


def stage_w_bf16_plain(W, bm, plan: WgmmaPlan):
    """Plain version of the W copy of the tensor-core passes: ``(..., kstage,
    Mps)`` bf16, column ``32 w + b`` holding W's data row of bit ``b`` of word
    row ``w`` (:func:`bitplane_rows`), zero beyond ``k`` and ``Mp``."""
    *lead, k, Mp = W.shape
    out = torch.zeros((*lead, plan.kstage, plan.Mps), dtype=torch.bfloat16, device=W.device)
    out[..., :k, :Mp] = W[..., bitplane_rows(Mp, bm, W.device)].to(torch.bfloat16)
    return out


def stage_h_bf16_plain(H, plan: WgmmaPlan, form: Optional[str] = None):
    """Plain version of the H copy of the tensor-core passes: ``(..., kstage,
    Nps)`` bf16, zero beyond ``k`` and ``Np``; with ``form``, the W pass's
    ``1 - h`` copy instead, by :func:`tiers.complement`'s rule for that form."""
    *lead, k, Np = H.shape
    value = H if form is None else tiers.complement(H, form)
    out = torch.zeros((*lead, plan.kstage, plan.Nps), dtype=torch.bfloat16, device=H.device)
    out[..., :k, :Np] = value.to(torch.bfloat16)
    return out


def stage_bf16(W, H, bm: int, form: str = "bf16r"):
    """The bf16 copies a tensor-core pass of ``form`` makes of ``W`` (bit-plane
    order), ``H`` and the W pass's ``1 - H``, as ``(W copy, H copy, 1 - H
    copy)``: the staging kernels on CUDA tensors (one launch of
    ``nbmf_stage_bf16``), their plain versions on the CPU.  The passes stage
    inside their own entry points; this serves checking the staging alone."""
    if form not in WGMMA_FORMS:
        raise ValueError(f"stage_bf16: form must be one of {WGMMA_FORMS}, got {form!r}")
    k, Mp = W.shape[-2:]
    plan = plan_wgmma(k, Mp, H.shape[-1])
    if W.device.type == "cpu":
        return (stage_w_bf16_plain(W, bm, plan), stage_h_bf16_plain(H, plan),
                stage_h_bf16_plain(H, plan, form))
    from ._build import load_library

    lanes = _check_cuda_operands("stage_bf16", W, H, None, None, bm, batched=True)
    lead = tuple(W.shape[:-2])
    lib = load_library()
    bf = dict(dtype=torch.bfloat16, device=W.device)
    wst = torch.empty((*lead, plan.kstage, plan.Mps), **bf)
    hst, hcst = (torch.empty((*lead, plan.kstage, plan.Nps), **bf) for _ in range(2))
    err = lib.nbmf_stage_bf16(W.data_ptr(), H.data_ptr(), wst.data_ptr(), hst.data_ptr(),
                              hcst.data_ptr(), k, Mp, H.shape[-1], bm, int(form == "bf16d"),
                              lanes or 1, W.device.index or 0,
                              torch.cuda.current_stream(W.device).cuda_stream)
    _raise_on_error(lib, "stage_bf16", err)
    return wst, hst, hcst


def phase_b_order(n: int) -> torch.Tensor:
    """Logical index of each physical position of a TF32 phase-B copy's rows
    of ``n`` values (``n % 8 == 0``): position ``8 g + j`` holds ``8 g +
    SLOT8[j]``."""
    if n % 8:
        raise ValueError(f"phase_b_order: {n} is not a multiple of 8")
    return (torch.arange(n).reshape(-1, 8)[:, list(SLOT8)]).reshape(n)


def stage_tf32_plain(W, H, bm, plan: WgmmaPlan):
    """Plain version of the TF32 copies of the tensor-core passes, each
    TF32-rounded (:func:`tiers.round_tf32`) float32 with ``W``'s leading
    axes, zero beyond ``k`` and ``Mp``/``Np``: ``(W^T (Mps, kstage) in
    bit-plane order (:func:`bitplane_rows`), W's phase-B copy (kstage, Mps),
    H^T (Nps, kstage), H's and 1 - H's phase-B copies (kstage, Nps))``, the
    phase-B copies' columns in :func:`phase_b_order` and 1 - H by
    :func:`tiers.complement` under ``"tf32r"``, ``round(1 - h)``."""
    *lead, k, Mp = W.shape
    Np = H.shape[-1]
    f32 = dict(dtype=torch.float32, device=W.device)
    w = torch.zeros((*lead, plan.kstage, plan.Mps), **f32)
    w[..., :k, :Mp] = tiers.round_tf32(W[..., bitplane_rows(Mp, bm, W.device)])
    h, hc = (torch.zeros((*lead, plan.kstage, plan.Nps), **f32) for _ in range(2))
    h[..., :k, :Np] = tiers.round_tf32(H)
    hc[..., :k, :Np] = tiers.complement(H, "tf32r")
    wk, hk, hck = (t[..., phase_b_order(t.shape[-1]).to(W.device)] for t in (w, h, hc))
    return (w.transpose(-1, -2).contiguous(), wk, h.transpose(-1, -2).contiguous(), hk, hck)


def stage_tf32(W, H, bm: int):
    """The TF32 copies a tensor-core pass of the ``"tf32r"`` form makes
    (:func:`stage_tf32_plain`'s five): the staging kernels on CUDA tensors
    (one launch of ``nbmf_stage_tf32``), their plain version on the CPU.
    The passes stage inside their own entry points (the H pass the first
    three, the W pass W^T, H^T and the last two); this serves checking the
    staging alone."""
    k, Mp = W.shape[-2:]
    plan = plan_wgmma(k, Mp, H.shape[-1])
    if W.device.type == "cpu":
        return stage_tf32_plain(W, H, bm, plan)
    from ._build import load_library

    lanes = _check_cuda_operands("stage_tf32", W, H, None, None, bm, batched=True)
    lead = tuple(W.shape[:-2])
    f32 = dict(dtype=torch.float32, device=W.device)
    copies = (torch.empty((*lead, plan.Mps, plan.kstage), **f32),
              torch.empty((*lead, plan.kstage, plan.Mps), **f32),
              torch.empty((*lead, plan.Nps, plan.kstage), **f32),
              *(torch.empty((*lead, plan.kstage, plan.Nps), **f32) for _ in range(2)))
    lib = load_library()
    err = lib.nbmf_stage_tf32(W.data_ptr(), H.data_ptr(), *(t.data_ptr() for t in copies), k, Mp,
                              H.shape[-1], bm, lanes or 1, W.device.index or 0,
                              torch.cuda.current_stream(W.device).cuda_stream)
    _raise_on_error(lib, "stage_tf32", err)
    return copies


# The TF32 passes' instances by entry point, as nbmf_tf32_occupancy_* numbers them.
_TF32_OCCUPANCY = (("nbmf_tf32_occupancy_packed", ("hloss_terms_packed", "w_terms_packed")),
                   ("nbmf_tf32_occupancy_dense", ("hloss_terms", "h_terms", "loglik_sum",
                                                  "w_terms")))


def tf32_occupancy(ranks=(32, 64, 128, 256)) -> dict:
    """``{(pass, k, second): (blocks per SM, shared memory bytes)}`` of the
    TF32 tensor-core instance each pass launches for rank ``k`` with
    (``second``) and without its second operand, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives it on the
    current card.  Needs the card."""
    import ctypes

    from ._build import load_library

    lib = load_library()
    out = {}
    for entry, passes in _TF32_OCCUPANCY:
        for index, name in enumerate(passes):
            for k in ranks:
                for second in (False, True):
                    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
                    err = getattr(lib, entry)(index, k, int(second), ctypes.addressof(blocks),
                                              ctypes.addressof(smem))
                    _raise_on_error(lib, entry, err)
                    out[(name, k, second)] = (blocks.value, smem.value)
    return out


def wgmma_entry(entry: str) -> bool:
    """Whether a pass's C entry point is a bf16 tensor-core form, which takes
    the bf16 copies as scratch (:func:`plan_wgmma`)."""
    return entry.startswith("nbmf_") and entry.rsplit("_", 1)[-1] in WGMMA_FORMS


def tf32_entry(entry: str) -> bool:
    """Whether a pass's C entry point is the TF32 tensor-core form, which
    takes the TF32 copies as scratch (:func:`stage_tf32_plain` lists them)."""
    return entry.startswith("nbmf_") and entry.rsplit("_", 1)[-1] in TF32_FORMS


def _raise_on_error(lib, who, err):
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err}: {lib.nbmf_error_string(err).decode()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_aligned(who, lane_strides=(), **tensors):
    """The kernels copy these operands' rows as 16-byte vectors, in every
    lane: the base pointers and the lanes' strides (in floats) must be
    multiples of 16 bytes."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must start on a 16-byte boundary")
    for stride in lane_strides:
        if stride % 4:
            raise ValueError(f"{who}: a lane stride of {stride} floats breaks 16-byte alignment")


def _split_launches(lib):
    """The launches of the warp-specialised H pass the library's launcher has
    counted (``nbmf_h_split_launches``), or None for a stand-in that is not
    a loaded library."""
    if not isinstance(lib, ctypes.CDLL):
        return None
    return ctypes.c_longlong.in_dll(lib, "nbmf_h_split_launches").value


def _launch_hloss(entry, who, W, H, y, y2, *, eps, m_real, n_real, bm, terms=True,
                  loss=True, split_counts=None):
    """Allocate the outputs and scratch of an H-pass entry point (packed or
    dense; with ``terms=False`` the ll-only one, with ``loss=False`` one
    without ll), the row split's partials (:func:`plan_h_split`) and W's
    bit-plane copy (for a tensor-core form the bf16 copies of W and H, or
    the TF32 copies W^T, W's phase-B copy and H^T: :func:`plan_wgmma`), and
    launch it on the current stream.  Returns
    ``(Num, Den, ll)``, ``Num``/``Den`` None without terms, ``ll`` None
    without loss.  ``y`` may be None for an entry that reads no data.  If the
    launch ran the warp-specialised body, as the library reports it,
    ``split_counts[who]`` goes up by one.

    Factors with a leading lane axis ``R`` go through the one launch; every
    output and scratch array gains that axis, and the split is planned as
    for one lane, so a lane adds its partials in the unbatched order."""
    from ._build import load_library

    lead = tuple(W.shape[:-2])  # () or (R,)
    lanes = lead[0] if lead else 1
    k, Mp = W.shape[-2:]
    Np = H.shape[-1]
    _check_aligned(who, (k * Mp, k * Np), y=y, y2=y2)
    lib = load_library()
    dev = W.device
    plan = plan_h_split(Mp, Np, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=dev)
    ll = ll_part = None
    if loss:
        ll = torch.empty(lead, **f32)
        ll_part = torch.empty(lanes * -(-Np // H_COLS) * plan.nsplit, dtype=torch.float64,
                              device=dev)
    wg = plan_wgmma(k, Mp, Np) if wgmma_entry(entry) or tf32_entry(entry) else None
    if wgmma_entry(entry):  # the bf16 copies of W and H
        bf = dict(dtype=torch.bfloat16, device=dev)
        staged = (torch.empty((lanes, wg.kstage, wg.Mps), **bf),
                  torch.empty((lanes, wg.kstage, wg.Nps), **bf))
    elif tf32_entry(entry):  # W^T, W's phase-B copy, H^T
        staged = (torch.empty((lanes, wg.Mps, wg.kstage), **f32),
                  torch.empty((lanes, wg.kstage, wg.Mps), **f32),
                  torch.empty((lanes, wg.Nps, wg.kstage), **f32))
    else:  # W's bit-plane copy
        staged = (torch.empty((lanes, k, Mp), **f32),)
    stream = torch.cuda.current_stream(dev).cuda_stream
    num = den = num_part = den_part = None
    outs = ()
    if terms:
        num, den = torch.empty((*lead, k, Np), **f32), torch.empty((*lead, k, Np), **f32)
        if plan.scratch is not None:
            num_part, den_part = (torch.empty((lanes, *plan.scratch), **f32) for _ in range(2))
        outs = (num.data_ptr(), den.data_ptr(), _ptr(num_part), _ptr(den_part))
    split_before = _split_launches(lib) if split_counts and who in split_counts else None
    err = getattr(lib, entry)(W.data_ptr(), H.data_ptr(), _ptr(y), _ptr(y2), *outs,
                              _ptr(ll_part), _ptr(ll), *map(_ptr, staged), k, Mp, Np, bm, m_real,
                              n_real, plan.nsplit, lanes, float(eps), dev.index or 0, stream)
    _raise_on_error(lib, who, err)
    if split_before is not None and _split_launches(lib) > split_before:
        split_counts[who] += 1
    return num, den, ll


def _launch_wterms(entry, who, W, H_new, y, y2, *, eps, n_real, bm, n_out=1):
    """Allocate ``T (n_out k, Mp)``, the split scratch (:func:`plan_w_split`)
    and, for a tensor-core form, the bf16 copies of W, H and 1 - H, or the
    TF32 copies W^T, H^T and H's and 1 - H's phase-B copies
    (:func:`plan_wgmma`), and launch a W-pass entry point on the current
    stream; ``y`` may be None for an entry that reads no data.  The kernel
    copies ``H``'s and the operands' rows as 16-byte vectors.  A leading lane
    axis on the factors goes through the one launch, as in
    :func:`_launch_hloss`."""
    from ._build import load_library

    lead = tuple(W.shape[:-2])  # () or (R,)
    lanes = lead[0] if lead else 1
    k, Mp = W.shape[-2:]
    Np = H_new.shape[-1]
    _check_aligned(who, (k * Mp, k * Np), H=H_new, y=y, y2=y2)
    lib = load_library()
    dev = W.device
    tensor_cores = wgmma_entry(entry) or tf32_entry(entry)
    plan = plan_w_split(Mp, Np, k, torch.cuda.get_device_properties(dev).multi_processor_count,
                        n_out, tensor_cores=tensor_cores)
    T = torch.empty((*lead, n_out * k, Mp), dtype=torch.float32, device=dev)
    part = None if plan.scratch is None else torch.empty((lanes, *plan.scratch),
                                                         dtype=torch.float32, device=dev)
    staged = ()
    wg = plan_wgmma(k, Mp, Np) if tensor_cores else None
    if wgmma_entry(entry):  # the bf16 copies of W, H and 1 - H
        bf = dict(dtype=torch.bfloat16, device=dev)
        staged = (torch.empty((lanes, wg.kstage, wg.Mps), **bf),
                  *(torch.empty((lanes, wg.kstage, wg.Nps), **bf) for _ in range(2)))
    elif tf32_entry(entry):  # W^T, H^T, H's and 1 - H's phase-B copies
        f32 = dict(dtype=torch.float32, device=dev)
        staged = (torch.empty((lanes, wg.Mps, wg.kstage), **f32),
                  torch.empty((lanes, wg.Nps, wg.kstage), **f32),
                  *(torch.empty((lanes, wg.kstage, wg.Nps), **f32) for _ in range(2)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(
        W.data_ptr(), H_new.data_ptr(), _ptr(y), _ptr(y2), T.data_ptr(), _ptr(part),
        *map(_ptr, staged), k, Mp, Np, bm, n_real, plan.nsplit, lanes, float(eps), dev.index or 0, stream,
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
    precision=None,
):
    """Fused H-update + loss pass over packed words: ``(Num, Den, ll)``.

    ``W`` is ``(k, Mp)``, ``H`` is ``(k, Np)``, or both with a leading lane
    axis ``R`` (then every output has it too); ``words`` packs ``Ym``.
    ``words2=None`` takes the complement ``1 - Ym`` (unmasked and parity);
    an explicit ``words2`` packing ``(1 - Y) * mask`` serves
    ``mask_mode="corrected"``.  ``ll`` is the log-likelihood summed over the
    real ``(m_real, n_real)`` region.  ``precision`` picks the tier.
    """
    name = "hloss_terms_packed" + tiers.suffix(tiers.operand_form(precision))
    if W.device.type == "cpu":
        return per_lane(hloss_terms_packed_plain, W, H, words, words2, eps=eps, m_real=m_real,
                        n_real=n_real, bm=bm, precision=precision)
    lanes = _check_cuda_operands(name, W, H, words, words2, bm, batched=True)
    out = _launch_hloss("nbmf_" + name, name, W, H, words, words2, eps=eps, m_real=m_real,
                        n_real=n_real, bm=bm, split_counts=H_WS_LAUNCHES)
    LAUNCHES[name] += 1
    LANES[name] += lanes or 1
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
    precision=None,
) -> torch.Tensor:
    """Packed W-update contraction ``T = H P^T + (1 - H) Q^T`` (``(k, Mp)``,
    or ``(R, k, Mp)`` for factors with a leading lane axis).

    ``words2=None`` synthesizes the unmasked complement with column validity;
    an explicit ``words2`` (packing ``(1 - Y) * mask``) serves both masked
    modes.  ``precision`` picks the tier.
    """
    name = "w_terms_packed" + tiers.suffix(tiers.operand_form(precision))
    if W.device.type == "cpu":
        return per_lane(w_terms_packed_plain, W, H_new, words, words2, eps=eps, n_real=n_real,
                        bm=bm, precision=precision)
    lanes = _check_cuda_operands(name, W, H_new, words, words2, bm, batched=True)
    T = _launch_wterms("nbmf_" + name, name, W, H_new, words, words2, eps=eps, n_real=n_real,
                       bm=bm)
    LAUNCHES[name] += 1
    LANES[name] += lanes or 1
    return T
