"""Carry fitted state across from the JAX package.

:func:`from_reference` reads plain attributes (numpy arrays and Python
scalars) off a fitted JAX-package ``NBMF``, a JAX-package ``SolverResult``
or a dict with the same names, and returns a fitted
:class:`~nbmf_mm_tpu_torch.models.estimator.NBMF`.  It never imports JAX.

:func:`packed_from_reference` turns the fields of a JAX-package
``PackedMatrix`` into this package's.  The bit layout is shared; the pad
geometry is not (the JAX package pads the columns to a multiple of 128 and
may pick another stripe), so the words are cropped or repacked.

:func:`restart_inits_from_reference` turns the JAX package's batched random
inits into the factors this package's solver cores start from, so that both
packages run every restart lane from the same numbers.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..models.estimator import NBMF
from ..ops import cuda_sweep as cs
from ..ops.packed import PackedMatrix, pack_matrix_chunked
from ..solver import driver

__all__ = ["from_reference", "packed_from_reference", "restart_inits_from_reference"]

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


def _unpack_bits_host(words: np.ndarray, bm: int) -> np.ndarray:
    """Inverse of ``pack_bits_host`` for whole stripes: ``(S * bm // 32, Np)``
    int32 words to ``(S * bm, Np)`` uint8."""
    Mw, Np = words.shape
    bmw = bm // cs.PACKED_WORD_BITS
    octets = np.ascontiguousarray(words, dtype=np.int32).view(np.uint8)
    bits = np.unpackbits(octets.reshape(Mw // bmw, bmw, Np, 4), axis=-1, bitorder="little")
    return np.moveaxis(bits, -1, 1).reshape(Mw * cs.PACKED_WORD_BITS, Np)


def packed_from_reference(words, shape, block_m: int, device="cuda") -> PackedMatrix:
    """This package's :class:`~nbmf_mm_tpu_torch.ops.packed.PackedMatrix` on
    ``device`` from a JAX-package one's fields: ``words`` as a numpy array
    (``np.asarray(pm.words)``), ``shape`` and ``block_m``.

    Where the stripe is the one this package plans, the layout agrees row for
    row and only the zero pad rows and columns are cropped.  Otherwise the
    words are unpacked and repacked on the host in row chunks of whole
    stripes, as uint8, never the whole matrix at once.
    """
    words = np.asarray(words)
    m, n = (int(x) for x in shape)
    if words.dtype != np.int32 or words.ndim != 2:
        raise TypeError(f"words must be a 2-D int32 array, got {words.dtype} {words.shape}")
    rows_ref = words.shape[0] * cs.PACKED_WORD_BITS
    # The JAX package's effective stripe: block_m shrunk for a short matrix,
    # then rounded up to a multiple of 128 (its ``_pick_block``).
    block_m = cs.round_up(min(block_m, cs.round_up(rows_ref, 128)), 128)
    cs._check_stripe(rows_ref, block_m, "packed_from_reference")
    bm, Mp, Np = cs.plan_packing(m, n)
    if rows_ref < m or words.shape[1] < n:
        raise ValueError(f"words of padded shape {(rows_ref, words.shape[1])} cannot hold "
                         f"a {(m, n)} matrix")
    if block_m == bm and rows_ref >= Mp and words.shape[1] >= Np:
        kept = words[: Mp // cs.PACKED_WORD_BITS, :Np]
        if words[:, Np:].any() or words[Mp // cs.PACKED_WORD_BITS:].any():
            raise ValueError("the words' pad rows or columns are not zero")
        out = torch.tensor(kept, device=cs.resolve_device(device))
        return PackedMatrix(words=out, shape=(m, n), block_m=bm)

    bmw_ref = block_m // cs.PACKED_WORD_BITS

    def row_chunk(a, b):  # the stripes of the source that hold rows [a, b)
        first, last = a // block_m, -(-b // block_m)
        dense = _unpack_bits_host(words[first * bmw_ref: last * bmw_ref], block_m)
        return dense[a - first * block_m: b - first * block_m, :n]

    return pack_matrix_chunked(row_chunk, m, n, validate=False, device=device)


def restart_inits_from_reference(W0_ext, H0, dtype=None, device="cuda"):
    """The batched inits of this package's solver cores on ``device`` from
    the JAX package's: ``W0_ext (n_init, m, k)`` and ``H0 (n_init, k, n)`` as
    numpy arrays, the way its ``_random_uniform_inits`` returns them
    (``np.asarray`` of each).

    Returns ``(W0, H0)`` as ``solve`` hands them to
    :func:`~nbmf_mm_tpu_torch.solver.driver._solve_core`: ``W0 (n_init, k, m)``
    in the internal layout, each lane with unit column sums, and
    ``H0 (n_init, k, n)``, contiguous, in ``dtype`` (float32 by default).
    The fused core takes them zero-padded to the planned geometry.
    """
    dtype, _ = driver._resolve_dtype(dtype)
    device = cs.resolve_device(device)
    W0_ext = torch.tensor(np.asarray(W0_ext), dtype=dtype)
    H0 = torch.tensor(np.asarray(H0), dtype=dtype)
    if W0_ext.dim() != 3 or H0.dim() != 3 or W0_ext.shape[0] != H0.shape[0] \
            or W0_ext.shape[2] != H0.shape[1]:
        raise ValueError(f"inits must be (n_init, m, k) and (n_init, k, n), got "
                         f"{tuple(W0_ext.shape)} and {tuple(H0.shape)}")
    W0 = torch.stack([driver._internal_simplex_factor(w, device) for w in W0_ext])
    return W0, H0.to(device).contiguous()
