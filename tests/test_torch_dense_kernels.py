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


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["none", "corrected"], ids=["Yc-None", "Yc-explicit"])
@pytest.mark.parametrize("m, n", SHAPES, ids=["unpadded", "padded"])
def test_h_terms_matches_pallas(m, n, mode, dtype):
    c = _operands(m, n, mode, dtype)
    num_j, den_j = ps.h_terms(_j(c["W"]), _j(c["H"]), _j(c["Ym"]), _j(c["Yc"]), eps=EPS,
                              block_m=BLOCK, block_n=BLOCK, interpret=True)
    num_t, den_t = ds.h_terms(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Yc"]), eps=EPS,
                              bm=BLOCK)
    assert num_t.dtype == den_t.dtype == torch.tensor(c["W"]).dtype
    assert _rel(num_t, num_j) <= TOL[dtype]
    assert _rel(den_t, den_j) <= TOL[dtype]


@pytest.mark.parametrize("mode", MODES)
def test_h_terms_equals_hloss_terms_bitwise(mode):
    c = _operands(240, 250, mode, np.float32, seed=4)
    args = (_t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Yc"]))
    num, den = ds.h_terms(*args, eps=EPS, bm=BLOCK)
    num_l, den_l, _ = ds.hloss_terms(*args, eps=EPS, m_real=240, n_real=250, bm=BLOCK)
    assert torch.equal(num, num_l) and torch.equal(den, den_l)


def test_cpu_tensors_do_not_count_launches():
    c = _operands(240, 250, "parity", np.float64)
    ds.LAUNCHES.update(dict.fromkeys(ds.LAUNCHES, 0))  # every form's counter
    ds.hloss_terms(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), eps=EPS, m_real=240, n_real=250, bm=32)
    ds.h_terms(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), eps=EPS, bm=32)
    ds.w_terms(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Ym2"]), eps=EPS, n_real=250, bm=32)
    ds.loglik_sum(_t(c["W"]), _t(c["H"]), _t(c["Ym"]), eps=EPS, m_real=240, n_real=250, bm=32)
    assert set(ds.LAUNCHES.values()) == {0}


def test_wrappers_reject_other_devices():
    W = torch.zeros((2, 32), device="meta")
    H = torch.zeros((2, 4), device="meta")
    Y = torch.zeros((32, 4), device="meta")
    for call in (
        lambda: ds.hloss_terms(W, H, Y, eps=EPS, m_real=32, n_real=4, bm=32),
        lambda: ds.h_terms(W, H, Y, eps=EPS, bm=32),
        lambda: ds.w_terms(W, H, Y, eps=EPS, n_real=4, bm=32),
        lambda: ds.loglik_sum(W, H, Y, eps=EPS, m_real=32, n_real=4, bm=32),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# ----------------------------------------------- a leading lane axis (restarts)
# Batched factors W (R, k, Mp), H (R, k, Np) over shared data: on CPU tensors
# the wrappers run their plain versions lane by lane, so lane r must equal the
# unbatched call bitwise; against the JAX kernels under jax.vmap (interpret
# mode, float64) the bar is the unbatched tests' 1e-12 of max |ref| (a lane
# of a batch runs the same formulas), stated here as 1e-10.
TOL_VMAP = 1e-10
LANES = [1, 3]


def _lane_factors(c, R, dtype, seed=11):
    """``R`` pairs of factors at the padded geometry of case ``c``."""
    rng = np.random.default_rng(seed)
    K_, Mp = c["W"].shape
    Np = c["H"].shape[1]
    W = np.zeros((R, K_, Mp), dtype)
    W[:, :, :c["m"]] = rng.uniform(0.1, 0.9, (R, K_, c["m"]))
    W[:, :, :c["m"]] /= W[:, :, :c["m"]].sum(axis=1, keepdims=True)
    H = np.zeros((R, K_, Np), dtype)
    H[:, :, :c["n"]] = rng.uniform(0.1, 0.9, (R, K_, c["n"]))
    return W, H


def _dense_calls(c, bm):
    m, n = c["m"], c["n"]
    Ym, Yc, Ym2 = _t(c["Ym"]), _t(c["Yc"]), _t(c["Ym2"])
    return {
        "hloss_terms": lambda W, H: ds.hloss_terms(W, H, Ym, Yc, eps=EPS, m_real=m, n_real=n,
                                                   bm=bm),
        "w_terms": lambda W, H: ds.w_terms(W, H, Ym, Ym2, eps=EPS, n_real=n, bm=bm),
        "loglik_sum": lambda W, H: ds.loglik_sum(W, H, Ym, Yc, eps=EPS, m_real=m, n_real=n,
                                                 bm=bm),
    }


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("R", LANES + [6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["hloss_terms", "w_terms", "loglik_sum"])
def test_batched_lane_equals_unbatched_bitwise(name, mode, dtype, R):
    c = _operands(240, 250, mode, dtype, seed=5)
    W, H = map(torch.tensor, _lane_factors(c, R, dtype))
    call = _dense_calls(c, BLOCK)[name]
    batched = _tuple(call(W, H))
    for out in batched:
        assert out.shape[0] == R and out.dtype == W.dtype
    for r in range(R):
        for got, want in zip(batched, _tuple(call(W[r], H[r]))):
            assert torch.equal(got[r], want)


@pytest.mark.parametrize("mode", MODES)
def test_batched_lane_equals_unbatched_at_a_shape_the_jax_planner_rejects(mode):
    """m = 300 pads to Mp = 512 with bm = 256 here; the JAX ``select_stripe``
    rejects it, so only the port's own tie is held."""
    m, n = 300, 70
    rng = np.random.default_rng(2)
    bm, Mp, Np = cs.plan_packing(m, n)
    Y, mask = rng.random((m, n)), (rng.random((m, n)) < 0.75) * 1.0
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    c = dict(Ym=pad(Y if mode == "none" else Y * mask), m=m, n=n,
             W=np.zeros((K, Mp)), H=np.zeros((K, Np)))
    c["Ym2"] = None if mode == "none" else pad((1 - Y) * mask)
    c["Yc"] = c["Ym2"] if mode == "corrected" else None
    W, H = map(torch.tensor, _lane_factors(c, 3, np.float64))
    for call in _dense_calls(c, bm).values():
        batched = _tuple(call(W, H))
        for r in range(3):
            for got, want in zip(batched, _tuple(call(W[r], H[r]))):
                assert torch.equal(got[r], want)


@pytest.mark.parametrize("R", LANES)
@pytest.mark.parametrize("stripe", [False, True], ids=["tiled", "stripe"])
@pytest.mark.parametrize("mode", MODES)
def test_batched_dense_passes_match_pallas_under_vmap(mode, stripe, R):
    import jax

    m, n = 240, 250
    c = _operands(m, n, mode, np.float64, seed=6)
    Wb, Hb = _lane_factors(c, R, np.float64)
    kw = dict(block_m=BLOCK, block_n=BLOCK, interpret=True)
    Ym, Yc, Ym2 = _j(c["Ym"]), _j(c["Yc"]), _j(c["Ym2"])
    num_j, den_j, ll_j = jax.vmap(lambda W, H: ps.hloss_terms(
        W, H, Ym, Yc, eps=EPS, m_real=m, n_real=n, stripe=stripe, **kw))(_j(Wb), _j(Hb))
    T_j = jax.vmap(lambda W, H: ps.w_terms(
        W, H, Ym, Ym2, n_real=n, eps=EPS, stripe=stripe, **kw))(_j(Wb), _j(Hb))
    ll2_j = jax.vmap(lambda W, H: ps.loglik_sum(
        W, H, Ym, Yc, m_real=m, n_real=n, eps=EPS, **kw))(_j(Wb), _j(Hb))
    calls = _dense_calls(c, BLOCK)
    num_t, den_t, ll_t = calls["hloss_terms"](_t(Wb), _t(Hb))
    assert num_t.shape == (R, K, 256) and ll_t.shape == (R,)
    bias = c["pad_entries"] * np.log1p(EPS) if stripe and mode != "corrected" else 0.0
    assert _rel(num_t, num_j) <= TOL_VMAP and _rel(den_t, den_j) <= TOL_VMAP
    assert _rel(ll_t.numpy() + bias, ll_j) <= TOL_VMAP
    assert _rel(calls["w_terms"](_t(Wb), _t(Hb)), T_j) <= TOL_VMAP
    assert _rel(calls["loglik_sum"](_t(Wb), _t(Hb)), ll2_j) <= TOL_VMAP


def test_batched_wrappers_reject_mismatched_lanes():
    c = _operands(240, 250, "none", np.float64)
    W, H = map(torch.tensor, _lane_factors(c, 3, np.float64))
    calls = _dense_calls(c, BLOCK)
    for call in calls.values():
        with pytest.raises(ValueError, match="one R"):
            call(W, H[:2])
        with pytest.raises(ValueError, match="one R"):
            call(W, H[0])
    with pytest.raises(ValueError, match="one R"):
        ds.h_terms(W, H[:2], _t(c["Ym"]), eps=EPS, bm=BLOCK)
