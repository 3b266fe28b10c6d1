"""Bit-packed data as input: build and hold a binary matrix as int32
bit-plane words without ever staging it dense (counterpart of the JAX
package's ``ops/packed.py``, same names).

The packed kernels (:mod:`nbmf_mm_tpu_torch.ops.cuda_sweep`) stream 32
matrix entries per int32 word.  ``solve`` reaches them by itself for dense
binary input, but the dense staging then sets the memory ceiling: a
10^5 x 10^4 matrix is 4 GB as float32 and 125 MB packed.  This module
removes that ceiling:

- :class:`PackedMatrix` — the words, the real shape and the stripe they
  were packed for;
- :func:`pack_matrix` — pack a dense matrix (numpy on the host, a tensor on
  its device);
- :func:`pack_matrix_chunked` — pack row chunks produced on demand, so only
  one chunk is ever dense;
- :func:`pack_matrix_sparse` — pack a ``scipy.sparse`` matrix straight from
  its structure;
- :func:`pack_sparse_words` — the host packer under it, also used by
  ``solve`` for sparse data under a sparse mask.

Every packer gives exactly the words ``solve`` builds from the dense matrix
(:func:`plan_packing` is ``solve``'s own geometry), so a solve on them is
bitwise equal to the dense-input solve.  The packers are ``torch`` and numpy
code; the kernels that read the words are in ``csrc/sweep_packed.cu``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import cuda_sweep as cs

__all__ = [
    "PackedMatrix",
    "csr_binary_canonical",
    "pack_matrix",
    "pack_matrix_chunked",
    "pack_matrix_sparse",
    "pack_sparse_words",
    "plan_packing",
]

_CHUNK_ENTRIES = 1 << 26  # default dense entries per transient row chunk


def csr_binary_canonical(S):
    """CSR form of a scipy.sparse matrix with duplicates summed, or ``None``
    when a stored value of its dense equivalent is not exactly 0 or 1.

    Never mutates the input: duplicate entries sum in the dense view (two
    stored ones at one position are a dense 2), so a non-canonical input is
    canonicalized on a copy before the check and such sums are rejected
    instead of being packed as one bit.
    """
    Sr = S.tocsr()
    if not Sr.has_canonical_format:
        Sr = Sr.copy()
        Sr.sum_duplicates()
    if Sr.data.size and not bool(((Sr.data == 0) | (Sr.data == 1)).all()):
        return None
    return Sr


def binary_as_uint8(A: np.ndarray) -> Optional[np.ndarray]:
    """A uint8 copy of ``A`` when every entry is exactly 0 or 1, else
    ``None``: the cast, then one comparison against the original (whatever an
    out-of-range or NaN entry casts to, it cannot equal its source)."""
    with np.errstate(invalid="ignore"):
        U = np.asarray(A).astype(np.uint8)
    if U.size and (int(U.max()) > 1 or not bool((U == A).all())):
        return None
    return U


@dataclass(frozen=True)
class PackedMatrix:
    """A zero-padded binary matrix stored as stripe-local bit-plane words.

    ``words`` is an int32 tensor ``(Mp // 32, Np)`` (``Mp``/``Np`` the padded
    sizes), ``shape`` the real ``(m, n)``, ``block_m`` the stripe height the
    words were packed for (the layout is stripe-local: words only combine
    with kernels that use the same ``block_m``).  Pad rows and columns must
    be zero; the packers here guarantee it.
    """

    words: torch.Tensor
    shape: Tuple[int, int]
    block_m: int

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return self.words.shape[0] * cs.PACKED_WORD_BITS, self.words.shape[1]

    @property
    def nbytes(self) -> int:
        return self.words.numel() * 4

    def unpack(self) -> torch.Tensor:
        """Dense 0/1 float32 ``(m, n)`` on the words' device (for tests and
        small inspections)."""
        m, n = self.shape
        return cs.unpack_bits(self.words, self.block_m)[:m, :n]


def plan_packing(m: int, n: int, k: Optional[int] = None, *, block_m: Optional[int] = None,
                 block_n: Optional[int] = None) -> Tuple[int, int, int]:
    """Padded sizes and stripe height ``(Mp, Np, block_m)`` for packing an
    ``(m, n)`` matrix: the geometry ``solve`` derives for dense binary input
    (:func:`nbmf_mm_tpu_torch.ops.cuda_sweep.plan_packing`), in the JAX
    package's argument and return order.

    The plan does not depend on the rank and every shape plans.  ``block_m``
    and ``block_n`` exist so that calls carry over: ``None`` always works,
    and a value that would give other words than the plan's raises.
    """
    bm, Mp, Np = cs.plan_packing(m, n)
    if block_m is not None and block_m != bm:
        raise ValueError(f"block_m={block_m} differs from the plan for {(m, n)}: "
                         f"block_m={bm}, padded {(Mp, Np)}; pass block_m=None")
    if block_n is not None and cs.round_up(n, block_n) != Np:
        raise ValueError(f"block_n={block_n} differs from the plan for {(m, n)}: columns pad "
                         f"to a multiple of 4 (Np={Np}); pass block_n=None")
    return Mp, Np, bm


def _tensor_binary(C: torch.Tensor) -> bool:
    return bool(((C == 0) | (C == 1)).all())


def _pack_tensor(C: torch.Tensor, rows: int, Np: int, bm: int) -> torch.Tensor:
    """Words of a binary tensor zero-padded to ``(rows, Np)``, on its device."""
    C = C.to(torch.uint8)
    C = torch.nn.functional.pad(C, (0, Np - C.shape[1], 0, rows - C.shape[0]))
    return cs.pack_bits(C, bm)


def _pack_host(C: np.ndarray, rows: int, Np: int, bm: int) -> np.ndarray:
    """Words of a binary uint8 array zero-padded to ``(rows, Np)``."""
    Cp = np.zeros((rows, Np), dtype=np.uint8)
    Cp[: C.shape[0], : C.shape[1]] = C
    return cs.pack_bits_host(Cp, bm)


def _default_chunk_rows(Np: int, bm: int) -> int:
    return max(bm, (_CHUNK_ENTRIES // max(Np, 1)) // bm * bm)


def pack_matrix(Y, k: Optional[int] = None, *, block_m: Optional[int] = None,
                block_n: Optional[int] = None, device="cuda") -> PackedMatrix:
    """Pack a dense exactly-binary ``(m, n)`` matrix, words on ``device``.

    A numpy array is packed on the host, so only the words (1/32 of the
    float32 bytes) cross to ``device``; a tensor is packed on its own device.
    Anything but exact zeros and ones raises ``ValueError``.
    """
    device = cs.resolve_device(device)
    m, n = Y.shape
    Mp, Np, bm = plan_packing(m, n, k, block_m=block_m, block_n=block_n)
    if isinstance(Y, torch.Tensor):
        if not _tensor_binary(Y):
            raise ValueError("pack_matrix requires exactly binary data")
        words = _pack_tensor(Y, Mp, Np, bm)
    else:
        U = binary_as_uint8(np.asarray(Y))
        if U is None:
            raise ValueError("pack_matrix requires exactly binary data")
        words = torch.from_numpy(_pack_host(U, Mp, Np, bm))
    return PackedMatrix(words=words.to(device), shape=(m, n), block_m=bm)


def pack_matrix_chunked(
    row_chunk: Callable[[int, int], "np.ndarray | torch.Tensor"],
    m: int,
    n: int,
    k: Optional[int] = None,
    *,
    chunk_rows: Optional[int] = None,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    validate: bool = True,
    device="cuda",
) -> PackedMatrix:
    """Build a :class:`PackedMatrix` on ``device`` from row chunks made on
    demand.

    ``row_chunk(start, stop)`` returns the dense rows ``[start, stop)``
    (``stop - start`` rows by ``n`` columns; a numpy array or a tensor, any
    0/1 dtype).  The layout is stripe-local, so chunks whose heights are
    multiples of the stripe concatenate into exactly the words of the whole
    matrix and only one chunk is ever dense: peak memory is one chunk plus
    the words.  A numpy chunk is packed on the host, a tensor chunk on its
    own device.

    ``chunk_rows`` defaults to about 2^26 entries' worth of rows and is
    rounded up to the stripe height.  ``validate=False`` skips each chunk's
    binary scan (chunks straight from a Bernoulli draw, say).
    """
    device = cs.resolve_device(device)
    Mp, Np, bm = plan_packing(m, n, k, block_m=block_m, block_n=block_n)
    chunk_rows = cs.round_up(chunk_rows or _default_chunk_rows(Np, bm), bm)

    parts = []
    for start in range(0, Mp, chunk_rows):
        stop = min(start + chunk_rows, Mp)
        real_stop = min(stop, m)
        rows = real_stop - start
        if rows <= 0:  # wholly inside the row padding
            parts.append(torch.zeros(((stop - start) // cs.PACKED_WORD_BITS, Np),
                                     dtype=torch.int32, device=device))
            continue
        C = row_chunk(start, real_stop)
        if tuple(C.shape) != (rows, n):
            raise ValueError(f"row_chunk({start}, {real_stop}) returned shape "
                             f"{tuple(C.shape)}, expected {(rows, n)}")
        if isinstance(C, torch.Tensor):
            if validate and not _tensor_binary(C):
                raise ValueError(f"rows [{start}, {real_stop}) are not exactly binary")
            part = _pack_tensor(C, stop - start, Np, bm)
        else:
            C = np.asarray(C)
            U = binary_as_uint8(C) if validate else C.astype(np.uint8, copy=False)
            if U is None:
                raise ValueError(f"rows [{start}, {real_stop}) are not exactly binary")
            part = torch.from_numpy(_pack_host(U, stop - start, Np, bm))
        parts.append(part.to(device))
    words = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
    return PackedMatrix(words=words, shape=(m, n), block_m=bm)


def pack_sparse_words(S, Mp: int, Np: int, block_m: int, *, complement: bool = False,
                      chunk_rows: Optional[int] = None) -> np.ndarray:
    """Host packer from a sparse binary matrix to stripe words: bit-identical
    to ``pack_bits_host`` of the ``(Mp, Np)`` zero-padded dense equivalent,
    built one transient uint8 row chunk at a time.

    ``complement=True`` packs ``1 - S`` over the real region (the pads stay
    zero): dense as a sparse matrix, free as bits.  Chunk heights are kept
    multiples of the stripe ``block_m``, so every chunk packs as the whole
    matrix would.
    """
    m, n = S.shape
    cs._check_stripe(Mp, block_m, "pack_sparse_words")
    if m > Mp or n > Np:
        raise ValueError(f"pack_sparse_words: shape {(m, n)} exceeds the padded {(Mp, Np)}")
    chunk = (_default_chunk_rows(Np, block_m) if chunk_rows is None
             else max(block_m, chunk_rows // block_m * block_m))
    S8 = S.tocsr().astype(np.uint8)  # so each chunk densifies as uint8
    parts = []
    for start in range(0, Mp, chunk):
        stop = min(start + chunk, Mp)
        real = min(stop, m)
        C = np.zeros((stop - start, Np), dtype=np.uint8)
        if real > start:
            D = S8[start:real].toarray()
            C[: real - start, :n] = (1 - D) if complement else D
        parts.append(cs.pack_bits_host(C, block_m))
    return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def pack_matrix_sparse(Y, k: Optional[int] = None, *, block_m: Optional[int] = None,
                       block_n: Optional[int] = None, chunk_rows: Optional[int] = None,
                       device="cuda") -> PackedMatrix:
    """Pack a scipy.sparse binary matrix without a dense staging, words on
    ``device``.

    Sparse matrices are the common source of binary data at scale (user-item
    interactions), and their dense float32 form is what packing avoids.  Only
    ``chunk_rows``-row slices are densified (uint8, transient) on the way into
    the host packer, so the peak extra host memory is one chunk plus the
    words, and the data crosses to the device packed.

    Stored values must be exactly 0 or 1 (explicit zeros are fine, duplicate
    entries sum first); anything else raises ``ValueError``.  The input is
    never mutated.
    """
    import scipy.sparse as sp

    if not sp.issparse(Y):
        raise TypeError(f"pack_matrix_sparse expects a scipy.sparse matrix, got {type(Y)}")
    device = cs.resolve_device(device)
    Yr = csr_binary_canonical(Y)
    if Yr is None:
        raise ValueError("pack_matrix_sparse requires exactly binary stored values")
    m, n = Yr.shape
    Mp, Np, bm = plan_packing(m, n, k, block_m=block_m, block_n=block_n)
    words = pack_sparse_words(Yr, Mp, Np, bm, chunk_rows=chunk_rows)
    return PackedMatrix(words=torch.from_numpy(words).to(device), shape=(m, n), block_m=bm)
