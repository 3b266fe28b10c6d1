"""The plain versions of the port's two packed kernels against the JAX Pallas
kernels run in interpret mode on the CPU.

Tolerances: 1e-12 relative in float64 (same formulas, different summation
order); 1e-5 of max |ref| in float32, which allows for the summation order.
The JAX packed K1 adds log(1 + eps) per pad entry of the unmasked / parity
loss (0 in corrected mode); the port masks the loss exactly, so the test adds
that constant back on padded shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbmf_mm_tpu.ops import pallas_sweep as ps
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs

torch.set_num_threads(1)

EPS = 1e-8
K = 4
TOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(256, 256, 128), (240, 250, 256)]  # (m, n, bm): unpadded, padded


def _case(m, n, bm, mode, dtype, seed=0):
    rng = np.random.default_rng(seed)
    _, Mp, Np = cs.plan_packing(m, n)
    if (m, n) == (256, 256):
        Mp, Np = 256, 256
    Y = (rng.random((m, n)) < 0.35).astype(np.float64)
    mask = rng.random((m, n)) < 0.75
    Ym = Y if mode == "none" else Y * mask
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    words = cs.pack_bits_host(pad(Ym), bm)
    words2 = None if mode == "none" else cs.pack_bits_host(pad((1 - Y) * mask), bm)
    W = np.zeros((K, Mp), dtype)
    W[:, :m] = rng.uniform(0.1, 0.9, (K, m))
    W[:, :m] /= W[:, :m].sum(axis=0, keepdims=True)
    H = np.zeros((K, Np), dtype)
    H[:, :n] = rng.uniform(0.1, 0.9, (K, n))
    return dict(W=W, H=H, words=words, words2=words2, Mp=Mp, Np=Np)


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["none", "parity", "corrected"])
@pytest.mark.parametrize("m, n, bm", SHAPES, ids=["unpadded", "padded"])
def test_hloss_terms_packed_matches_pallas(m, n, bm, mode, dtype):
    c = _case(m, n, bm, mode, dtype)
    words2 = c["words2"] if mode == "corrected" else None  # parity: K2 only
    num_j, den_j, ll_j = ps.hloss_terms_packed(
        _j(c["W"]), _j(c["H"]), _j(c["words"]), _j(words2), eps=EPS, block_m=bm,
        interpret=True,
    )
    num_t, den_t, ll_t = cs.hloss_terms_packed(
        _t(c["W"]), _t(c["H"]), _t(c["words"]), _t(words2), eps=EPS, m_real=m, n_real=n, bm=bm,
    )
    assert num_t.dtype == den_t.dtype == ll_t.dtype == torch.tensor(c["W"]).dtype
    pad_entries = c["Mp"] * c["Np"] - m * n
    ll_port = float(ll_t) + (0.0 if mode == "corrected" else pad_entries * np.log1p(EPS))
    tol = TOL[dtype]
    assert _rel(num_t, num_j) <= tol
    assert _rel(den_t, den_j) <= tol
    assert abs(ll_port - float(ll_j)) <= tol * abs(float(ll_j))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["none", "parity", "corrected"])
@pytest.mark.parametrize("m, n, bm", SHAPES, ids=["unpadded", "padded"])
def test_w_terms_packed_matches_pallas(m, n, bm, mode, dtype):
    c = _case(m, n, bm, mode, dtype)
    T_j = ps.w_terms_packed(
        _j(c["W"]), _j(c["H"]), _j(c["words"]), _j(c["words2"]), n_real=n, eps=EPS, block_m=bm,
        interpret=True,
    )
    T_t = cs.w_terms_packed(
        _t(c["W"]), _t(c["H"]), _t(c["words"]), _t(c["words2"]), eps=EPS, n_real=n, bm=bm,
    )
    assert T_t.shape == (K, c["Mp"])
    assert _rel(T_t, T_j) <= TOL[dtype]


def test_loss_is_masked_exactly_to_the_real_region():
    m, n, bm = 240, 250, 256
    c = _case(m, n, bm, "none", np.float64)
    _, _, ll = cs.hloss_terms_packed(
        _t(c["W"]), _t(c["H"]), _t(c["words"]), eps=EPS, m_real=m, n_real=n, bm=bm,
    )
    Y = cs.unpack_bits(_t(c["words"]), bm, torch.float64)[:m, :n].numpy()
    WH = (c["W"].T @ c["H"])[:m, :n]
    dense = np.sum(Y * np.log(WH + EPS) + (1 - Y) * np.log(np.maximum(1 - WH, 0) + EPS))
    assert abs(float(ll) - dense) <= 1e-12 * abs(dense)
