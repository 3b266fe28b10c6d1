"""The port's three dense kernels (their plain versions, which CPU tensors take)
against the JAX Pallas kernels run in interpret mode on the CPU, and against
the port's packed kernels on binary data.

Tolerances: 1e-12 relative in float64 (same formulas, different summation
order); 1e-5 of max |ref| in float32, which allows for the summation order.
The JAX stripe H pass adds log(1 + eps) per pad entry of the unmasked /
parity loss (0 in corrected mode, whose Yc is zero-padded); the port masks
the loss exactly, as the JAX tiled kernels do, so the test adds that constant
back for the stripe form on padded shapes.  On binary operands the dense
and packed passes must agree bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbmf_mm_tpu.ops import pallas_sweep as ps
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds

torch.set_num_threads(1)

EPS = 1e-8
K = 4
BLOCK = 128  # JAX tile / stripe height; the padded extents are multiples of it
TOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(256, 256), (240, 250)]  # (m, n): unpadded, padded to 256 x 256
MODES = ["none", "parity", "corrected"]


def _operands(m, n, mode, dtype, *, binary=False, seed=0):
    """Zero-padded (256, 256) operands and (W, H): ``Ym`` and the H pass's
    ``Yc`` / the W pass's ``Ym2`` (None where the kernels synthesize the
    complement).  Continuous data and a weighted mask unless ``binary``."""
    rng = np.random.default_rng(seed)
    Mp = Np = 256
    if binary:
        Y = (rng.random((m, n)) < 0.35).astype(np.float64)
        mask = (rng.random((m, n)) < 0.75).astype(np.float64)
    else:
        Y = rng.random((m, n))
        mask = (rng.random((m, n)) < 0.75) * np.where(rng.random((m, n)) < 0.3, 0.5, 1.0)
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n))).astype(dtype)
    Ym = pad(Y if mode == "none" else Y * mask)
    Ym2 = None if mode == "none" else pad((1 - Y) * mask)
    W = np.zeros((K, Mp), dtype)
    W[:, :m] = rng.uniform(0.1, 0.9, (K, m))
    W[:, :m] /= W[:, :m].sum(axis=0, keepdims=True)
    H = np.zeros((K, Np), dtype)
    H[:, :n] = rng.uniform(0.1, 0.9, (K, n))
    return dict(W=W, H=H, Ym=Ym, Yc=Ym2 if mode == "corrected" else None, Ym2=Ym2,
                pad_entries=Mp * Np - m * n, m=m, n=n)


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("stripe", [False, True], ids=["tiled", "stripe"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m, n", SHAPES, ids=["unpadded", "padded"])
def test_hloss_terms_matches_pallas(m, n, mode, dtype, stripe):
    c = _operands(m, n, mode, dtype)
    num_j, den_j, ll_j = ps.hloss_terms(
        _j(c["W"]), _j(c["H"]), _j(c["Ym"]), _j(c["Yc"]), eps=EPS, m_real=m, n_real=n,
        block_m=BLOCK, block_n=BLOCK, interpret=True, stripe=stripe,
    )
    num_t, den_t, ll_t = ds.hloss_terms(
        _t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Yc"]), eps=EPS, m_real=m, n_real=n,
        bm=BLOCK,
    )
    assert num_t.dtype == den_t.dtype == ll_t.dtype == torch.tensor(c["W"]).dtype
    bias = c["pad_entries"] * np.log1p(EPS) if stripe and mode != "corrected" else 0.0
    tol = TOL[dtype]
    assert _rel(num_t, num_j) <= tol
    assert _rel(den_t, den_j) <= tol
    assert abs(float(ll_t) + bias - float(ll_j)) <= tol * abs(float(ll_j))


@pytest.mark.parametrize("stripe", [False, True], ids=["tiled", "stripe"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m, n", SHAPES, ids=["unpadded", "padded"])
def test_w_terms_matches_pallas(m, n, mode, dtype, stripe):
    c = _operands(m, n, mode, dtype)
    T_j = ps.w_terms(
        _j(c["W"]), _j(c["H"]), _j(c["Ym"]), _j(c["Ym2"]), n_real=n, eps=EPS,
        block_m=BLOCK, block_n=BLOCK, interpret=True, stripe=stripe,
    )
    T_t = ds.w_terms(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Ym2"]), eps=EPS, n_real=n,
                     bm=BLOCK)
    assert T_t.shape == (K, 256)
    assert _rel(T_t, T_j) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m, n", SHAPES, ids=["unpadded", "padded"])
def test_loglik_sum_matches_pallas(m, n, mode, dtype):
    c = _operands(m, n, mode, dtype)
    ll_j = ps.loglik_sum(_j(c["W"]), _j(c["H"]), _j(c["Ym"]), _j(c["Yc"]), m_real=m, n_real=n,
                         eps=EPS, block_m=BLOCK, block_n=BLOCK, interpret=True)
    ll_t = ds.loglik_sum(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Yc"]), eps=EPS, m_real=m,
                         n_real=n, bm=BLOCK)
    assert ll_t.dtype == torch.tensor(c["W"]).dtype
    assert abs(float(ll_t) - float(ll_j)) <= TOL[dtype] * abs(float(ll_j))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_dense_equals_packed_bitwise_on_binary_data(mode, dtype):
    m, n = 240, 250
    c = _operands(m, n, mode, dtype, binary=True, seed=3)
    W, H = _t(c["W"]), _t(c["H"])
    pack = lambda A: None if A is None else torch.tensor(cs.pack_bits_host(A, BLOCK))
    words, words2 = pack(c["Ym"]), pack(c["Ym2"])
    dense_h = ds.hloss_terms(W, H, _t(c["Ym"]), _t(c["Yc"]), eps=EPS, m_real=m, n_real=n,
                             bm=BLOCK)
    packed_h = cs.hloss_terms_packed(W, H, words, words2 if mode == "corrected" else None,
                                     eps=EPS, m_real=m, n_real=n, bm=BLOCK)
    for dense, packed in zip(dense_h, packed_h):
        assert torch.equal(dense, packed)
    ll = ds.loglik_sum(W, H, _t(c["Ym"]), _t(c["Yc"]), eps=EPS, m_real=m, n_real=n, bm=BLOCK)
    assert torch.equal(ll, dense_h[2])
    T_dense = ds.w_terms(W, H, _t(c["Ym"]), _t(c["Ym2"]), eps=EPS, n_real=n, bm=BLOCK)
    T_packed = cs.w_terms_packed(W, H, words, words2, eps=EPS, n_real=n, bm=BLOCK)
    assert torch.equal(T_dense, T_packed)


def test_cpu_tensors_do_not_count_launches():
    c = _operands(240, 250, "parity", np.float64)
    ds.LAUNCHES.update(hloss_terms=0, w_terms=0, loglik_sum=0)
    ds.hloss_terms(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), eps=EPS, m_real=240, n_real=250, bm=32)
    ds.w_terms(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Ym2"]), eps=EPS, n_real=250, bm=32)
    ds.loglik_sum(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), eps=EPS, m_real=240, n_real=250, bm=32)
    assert ds.LAUNCHES == {"hloss_terms": 0, "w_terms": 0, "loglik_sum": 0}


def test_wrappers_reject_other_devices():
    W = torch.zeros((2, 32), device="meta")
    H = torch.zeros((2, 4), device="meta")
    Y = torch.zeros((32, 4), device="meta")
    for call in (
        lambda: ds.hloss_terms(W, H, Y, eps=EPS, m_real=32, n_real=4, bm=32),
        lambda: ds.w_terms(W, H, Y, eps=EPS, n_real=4, bm=32),
        lambda: ds.loglik_sum(W, H, Y, eps=EPS, m_real=32, n_real=4, bm=32),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
