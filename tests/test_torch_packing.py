"""The port's bit packing is bit-identical to the JAX package's layout, and
its planner packs the shapes the JAX ``select_stripe`` rejects."""

import numpy as np
import pytest
import torch

from nbmf_mm_tpu.ops import pallas_sweep as ps
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs

torch.set_num_threads(1)


def _padded_binary(Mp, Np, m=None, n=None, seed=0):
    rng = np.random.default_rng(seed)
    Y = np.zeros((Mp, Np))
    m, n = m or Mp, n or Np
    Y[:m, :n] = rng.random((m, n)) < 0.4
    return Y


def _layout_words(Y, bm):
    """Words straight from the layout definition: word row w = j*bmw + i,
    bit b holds data row j*bm + b*bmw + i."""
    Mp, Np = Y.shape
    bmw = bm // 32
    words = np.zeros((Mp // 32, Np), dtype=np.int64)
    for w in range(Mp // 32):
        j, i = divmod(w, bmw)
        for b in range(32):
            words[w] |= Y[j * bm + b * bmw + i].astype(np.int64) << b
    return np.where(words >= 2**31, words - 2**32, words).astype(np.int32)


@pytest.mark.parametrize("bm", [32, 64, 128, 256])
def test_packers_follow_the_layout(bm):
    Y = _padded_binary(512, 20, seed=bm)
    expected = _layout_words(Y, bm)
    np.testing.assert_array_equal(cs.pack_bits_host(Y, bm), expected)
    np.testing.assert_array_equal(cs.pack_bits(torch.tensor(Y), bm).numpy(), expected)
    np.testing.assert_array_equal(
        cs.unpack_bits(torch.tensor(expected), bm, torch.float64).numpy(), Y
    )


@pytest.mark.parametrize("bm", [32, 128, 256])
def test_packers_bit_identical_to_jax(bm):
    # The JAX packers round a stripe up to a multiple of 128 (_pick_block),
    # so at bm=32 they pack in the bm=128 layout: compare at that stripe.
    jax_bm = ps._pick_block(512, bm)
    Y = _padded_binary(512, 36, seed=bm)
    ref = np.asarray(ps.pack_bits_host(Y, bm))
    np.testing.assert_array_equal(np.asarray(ps.pack_bits(Y, bm)), ref)
    np.testing.assert_array_equal(cs.pack_bits_host(Y, jax_bm), ref)
    np.testing.assert_array_equal(cs.pack_bits(torch.tensor(Y), jax_bm).numpy(), ref)
    np.testing.assert_array_equal(
        cs.unpack_bits(torch.tensor(ref), jax_bm, torch.float64).numpy(),
        np.asarray(ps.unpack_bits(ref, bm, np.float64)),
    )


@pytest.mark.parametrize(
    "m, n, expected",
    [
        (300, 70, (256, 512, 72)),
        (1226, 285, (256, 1280, 288)),
        (10000, 10000, (256, 10240, 10000)),
        (40, 33, (64, 64, 36)),
        (1, 1, (32, 32, 4)),
    ],
)
def test_plan_packing(m, n, expected):
    assert cs.plan_packing(m, n) == expected


@pytest.mark.parametrize("m, n", [(300, 70), (1226, 285)])
def test_planner_packs_shapes_the_reference_rejects(m, n):
    bm, Mp, Np = cs.plan_packing(m, n)
    Y = _padded_binary(Mp, Np, m, n, seed=m)
    words = cs.pack_bits(torch.tensor(Y), bm)
    assert tuple(words.shape) == (Mp // 32, Np)
    np.testing.assert_array_equal(words.numpy(), np.asarray(ps.pack_bits_host(Y, bm)))
    np.testing.assert_array_equal(cs.unpack_bits(words, bm, torch.float64).numpy(), Y)


def test_invalid_stripe_raises():
    with pytest.raises(ValueError):
        cs.pack_bits_host(np.zeros((96, 4)), 64)
    with pytest.raises(ValueError):
        cs.pack_bits(torch.zeros((64, 4)), 48)
    with pytest.raises(ValueError):
        cs.plan_packing(0, 3)


def test_apply_col_validity():
    H = torch.ones((3, 8), dtype=torch.float64)
    out = cs.apply_col_validity(H, 5)
    assert out[:, :5].eq(1).all() and out[:, 5:].eq(0).all()
    assert cs.apply_col_validity(H, 8) is H
