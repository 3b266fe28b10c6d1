"""The bf16-data mode (``dtype="bfloat16"``) of the port against the JAX package.

In that mode the data operands ``Ym``, ``Yc`` and ``Ym2`` are stored bf16, the
factors stay float32 and every product operand is rounded to bf16, the W
pass's ``1 - h`` as ``round(1 - round(h))`` (``nbmf_mm_tpu_torch/ops/tiers.py``).

- Kernel level: each dense kernel's plain version on a bf16 ``Ym`` against the
  JAX Pallas kernel in interpret mode (x64 off) on the same bf16 bits, for
  binary data, ``[0, 1]``-valued data and weighted masks in all three mask
  modes.  On the grid draw (W on a 1/64 grid, H on a 1/16 grid: every
  operand is bf16-exact and ``WH`` is exact whatever the order) within 1e-6
  of max |ref|; on random draws within 1e-4 (the order of an f32 sum can flip
  a bf16 rounding).  The small-h draw puts every ``h`` just above 2^-9, where
  the two rules for ``1 - h`` part: the port follows the JAX kernel there, and
  the DEFAULT tier over float32 data (``round(1 - h)``) does not.
- Solve level: 10 sweeps of ``solve(dtype="bfloat16", backend="fused")`` on
  the CPU against the JAX ``solve(dtype="bfloat16", backend="pallas",
  pallas_interpret=True)`` from the same inits: losses within 1e-4 relative,
  factors within 1e-3, at shapes the JAX planner takes.  Ten sweeps of bf16
  roundings can flip an operand that sits on a rounding midpoint in one sum
  order and not in the other, which moves a factor by ~1e-3; the draws here
  flip none.
- The contract: bf16 never packs, the JAX package's ``ValueError``s, the
  estimator, and the grid.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.ops import pallas_sweep as ps
from nbmf_mm_tpu.parallel.grid import grid_solve as jax_grid_solve
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds
from nbmf_mm_tpu_torch.ops import tiers

torch.set_num_threads(1)

EPS = 1e-8
M, N, K = 256, 384, 8
M_REAL, N_REAL = M - 20, N - 40  # a ragged real region inside the blocks
BLOCK = dict(block_m=256, block_n=384, interpret=True)
MODES = ("unmasked", "parity", "corrected")
TOL = {"grid": 1e-6, "random": 1e-4, "small-h": 1e-4}
CASES = [(data, mode) for data in ("binary", "soft", "weighted") for mode in MODES
         if not (data == "weighted" and mode == "unmasked")]


@pytest.fixture
def interpret_x32(monkeypatch):
    """Every pallas_call in interpret mode, and x64 off, for one test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def _factors(draw, seed):
    """``(W (K, M), H (K, N))`` float32 with zero pad columns."""
    rng = np.random.default_rng(seed)
    if draw == "grid":
        W = rng.integers(1, 8, (K, M)) / 64
        H = rng.integers(2, 15, (K, N)) / 16
    else:
        W = rng.uniform(0.1, 0.9, (K, M))
        W /= W.sum(axis=0, keepdims=True)
        # small-h: just above 2^-9, where round(1 - round(h)) is 1 and
        # round(1 - h) is 1 - 2^-8.
        H = (2.0 ** -9 + 2.0 ** -18 * rng.integers(1, 3, (K, N)) if draw == "small-h"
             else rng.uniform(0.1, 0.9, (K, N)))
    W[:, M_REAL:] = 0.0
    H[:, N_REAL:] = 0.0
    return torch.tensor(W, dtype=torch.float32), torch.tensor(H, dtype=torch.float32)


def _operands(data, mode, seed):
    """bf16 ``Ym``, the H pass's ``Yc`` and the W pass's ``Ym2``, formed in
    bf16 from the bf16 data and mask as ``solve`` forms them, zero outside
    the real region."""
    rng = np.random.default_rng(seed)
    real = np.zeros((M, N), bool)
    real[:M_REAL, :N_REAL] = True
    Y = (rng.random((M, N)) < 0.3) if data != "soft" else rng.random((M, N))
    u = rng.random((M, N))
    mask = np.where(u < 0.8, np.where(u < 0.16, 0.5, 1.0) if data == "weighted" else 1.0, 0.0)
    bf = lambda A: torch.tensor(np.where(real, A, 0.0), dtype=torch.float32).to(torch.bfloat16)
    Yb = bf(Y)
    if mode == "unmasked":
        return dict(Ym=Yb, Yc=None, Ym2=None)
    mb = bf(mask)
    Ym, Ym2 = Yb * mb, (1.0 - Yb) * mb
    return dict(Ym=Ym, Yc=Ym2 if mode == "corrected" else None, Ym2=Ym2)


def _jnp(t):
    """A torch tensor (bf16 or f32) as a JAX array of the same values and
    dtype (bf16 values cross as float32, exactly)."""
    if t is None:
        return None
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


KW_H = dict(eps=EPS, m_real=M_REAL, n_real=N_REAL)
KW_W = dict(eps=EPS, n_real=N_REAL)
KERNELS = {
    "hloss_terms": (lambda W, H, o: ps.hloss_terms(W, H, o["Ym"], o["Yc"], **KW_H, **BLOCK),
                    lambda W, H, o: ds.hloss_terms_plain(W, H, o["Ym"], o["Yc"], **KW_H)),
    "w_terms": (lambda W, H, o: ps.w_terms(W, H, o["Ym"], o["Ym2"], **KW_W, **BLOCK),
                lambda W, H, o: ds.w_terms_plain(W, H, o["Ym"], o["Ym2"], **KW_W)),
    "loglik_sum": (lambda W, H, o: ps.loglik_sum(W, H, o["Ym"], o["Yc"], **KW_H, **BLOCK),
                   lambda W, H, o: ds.loglik_sum_plain(W, H, o["Ym"], o["Yc"], **KW_H)),
    "h_terms": (lambda W, H, o: ps.h_terms(W, H, o["Ym"], o["Yc"], eps=EPS, **BLOCK),
                lambda W, H, o: ds.h_terms_plain(W, H, o["Ym"], o["Yc"], eps=EPS)),
}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _rel(port_out, ref) -> float:
    port_out = np.asarray(port_out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port_out.shape == ref.shape
    return float(np.abs(port_out - ref).max() / np.abs(ref).max())


# ------------------------------------------------------------ kernel level
@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("draw", ["grid", "random"])
@pytest.mark.parametrize("data, mode", CASES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_match_the_jax_kernels_on_bf16_data(kernel, data, mode, draw):
    W, H = _factors(draw, 1)
    o = _operands(data, mode, 2)
    ref_fn, port_fn = KERNELS[kernel]
    ref = _as_tuple(ref_fn(_jnp(W), _jnp(H), {name: _jnp(t) for name, t in o.items()}))
    got = _as_tuple(port_fn(W, H, o))
    assert all(t.dtype == torch.float32 for t in got)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL[draw]


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("mode", MODES)
def test_the_w_pass_forms_one_minus_h_from_the_bf16_h(mode):
    """At h just above 2^-9 the JAX kernel's ``1.0 - h`` in bf16 is 1, the
    port's bf16-data form follows it, and the DEFAULT tier over float32
    data, which rounds the f32 difference to 1 - 2^-8, does not."""
    W, H = _factors("small-h", 3)
    o = _operands("binary", mode, 4)
    ref = KERNELS["w_terms"][0](_jnp(W), _jnp(H), {name: _jnp(t) for name, t in o.items()})
    assert _rel(ds.w_terms_plain(W, H, o["Ym"], o["Ym2"], **KW_W), ref) <= TOL["small-h"]
    f32 = {name: None if t is None else t.float() for name, t in o.items()}
    tier = ds.w_terms_plain(W, H, f32["Ym"], f32["Ym2"], precision="default", **KW_W)
    assert _rel(tier, ref) > 1e-3
    # the rules differ on every h of this draw, and only there
    Hc = tiers.complement(H, "bf16d")[:, :N_REAL]
    assert torch.all(Hc == 1.0)
    assert torch.all(tiers.complement(H, "bf16r")[:, :N_REAL] == 1.0 - 2.0 ** -8)


def test_bf16_data_takes_its_form_whatever_the_precision():
    W, H = _factors("random", 5)
    o = _operands("binary", "corrected", 6)
    with pytest.raises(ValueError, match="unsupported device"):
        ds.hloss_terms(W.to("meta"), H.to("meta"), o["Ym"].to("meta"), eps=EPS, m_real=M,
                       n_real=N, bm=256)
    # the CPU route takes bf16 data through the bf16-data form, whatever
    # precision says
    a = ds.loglik_sum(W, H, o["Ym"], o["Yc"], bm=256, **KW_H)
    b = ds.loglik_sum(W, H, o["Ym"], o["Yc"], bm=256, precision="highest", **KW_H)
    assert torch.equal(a, b)


# ------------------------------------------------------------- solve level
def _solve_problem(m, n, data, mode):
    rng = np.random.default_rng(m * 1000 + n)
    Y = (rng.random((m, n)) < 0.3).astype(np.float32) if data != "soft" else (
        rng.random((m, n)).astype(np.float32))
    u = rng.random((m, n))
    mask = (u < 0.8).astype(np.float32)
    if data == "weighted":
        mask = mask * np.where(u < 0.16, 0.5, 1.0).astype(np.float32)
    kw = {} if mode == "unmasked" else dict(mask=mask, mask_mode=mode)
    rng = np.random.default_rng(7)
    inits = dict(W_init=rng.uniform(0.1, 0.9, (m, 4)).astype(np.float32),
                 H_init=rng.uniform(0.1, 0.9, (4, n)).astype(np.float32))
    return Y, dict(kw, **inits)


@pytest.mark.parametrize("m, n, data, mode", [
    (500, 130, "binary", "unmasked"), (256, 200, "binary", "parity"),
    (256, 200, "binary", "corrected"), (256, 256, "soft", "unmasked"),
    (256, 200, "soft", "parity"), (256, 200, "soft", "corrected"),
    (256, 200, "weighted", "parity"), (256, 200, "weighted", "corrected"),
])
def test_solve_matches_the_jax_bf16_solve(m, n, data, mode):
    Y, kw = _solve_problem(m, n, data, mode)
    ref = jref.solve(Y, 4, max_iter=10, tol=0.0, dtype="bfloat16", backend="pallas",
                     pallas_interpret=True, **kw)
    res = port.solve(Y, 4, max_iter=10, tol=0.0, dtype="bfloat16", backend="fused",
                     device="cpu", **kw)
    assert res.extras == {"backend": "fused", "packed": False, "precision": "default",
                          "data_dtype": "bfloat16"}
    assert res.n_iter == ref.n_iter == 10 and res.W.dtype == np.float32
    np.testing.assert_allclose(res.losses, np.asarray(ref.losses), rtol=1e-4, atol=0)
    np.testing.assert_allclose(res.W, ref.W, rtol=0, atol=1e-3)
    np.testing.assert_allclose(res.H, ref.H, rtol=0, atol=1e-3)


@pytest.mark.parametrize("spelling", ["bfloat16", torch.bfloat16, "BFLOAT16-name"])
def test_every_bfloat16_spelling_is_the_mode(spelling):
    if spelling == "BFLOAT16-name":
        spelling = np.dtype(jnp.bfloat16)  # the ml_dtypes numpy spelling
    Y = (np.random.default_rng(0).random((40, 30)) < 0.3).astype(np.float32)
    res = port.solve(Y, 3, max_iter=3, random_state=0, dtype=spelling, backend="fused",
                     device="cpu")
    assert res.extras["data_dtype"] == "bfloat16"


def test_the_plain_loop_keeps_the_data_float32_at_default():
    """The JAX package's XLA emulation of the mode: f32 data, DEFAULT
    products; here the plain loop at the DEFAULT tier, bitwise."""
    Y = (np.random.default_rng(1).random((40, 30)) < 0.3).astype(np.float32)
    kw = dict(max_iter=8, random_state=0, backend="plain", device="cpu")
    a = port.solve(Y, 3, dtype="bfloat16", **kw)
    b = port.solve(Y, 3, dtype="float32", precision="default", **kw)
    assert a.extras == b.extras == {"backend": "plain", "packed": False, "precision": "default"}
    assert a.losses == b.losses and np.array_equal(a.W, b.W)


# ---------------------------------------------------------------- contract
def _binary(m=64, n=48, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < 0.3).astype(np.float32)


FUSED = dict(backend="fused", device="cpu", random_state=0, max_iter=5)


def test_bf16_never_packs(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("pack_bits must not be called in bf16 mode")

    monkeypatch.setattr(cs, "pack_bits", boom)
    res = port.solve(_binary(), 4, dtype="bfloat16", **FUSED)
    assert res.extras["packed"] is False and np.isfinite(res.losses).all()
    res = port.solve(sp.csr_matrix(_binary()), 4, dtype="bfloat16", **FUSED)
    assert res.extras["packed"] is False
    res = port.solve(_binary(), 4, dtype="bfloat16", mask=_binary(seed=1) * 0 + 1, **FUSED)
    assert res.extras["packed"] is False


def test_bf16_equals_the_default_tier_in_the_h_pass_on_binary_data():
    """Binary data is bf16-exact, so the bf16-data H pass computes what the
    DEFAULT tier does over float32 data, bitwise; the W pass differs by the
    rule for 1 - h."""
    W, H = _factors("random", 8)
    o = _operands("binary", "corrected", 9)
    f32 = {name: None if t is None else t.float() for name, t in o.items()}
    a = ds.hloss_terms(W, H, o["Ym"], o["Yc"], bm=256, **KW_H)
    b = ds.hloss_terms(W, H, f32["Ym"], f32["Yc"], bm=256, precision="default", **KW_H)
    assert all(map(torch.equal, a, b))
    Hb = tiers.round_bf16(H)  # where the two rules agree
    assert torch.equal(ds.w_terms(W, Hb, o["Ym"], o["Ym2"], bm=256, **KW_W),
                       ds.w_terms(W, Hb, f32["Ym"], f32["Ym2"], bm=256, precision="default",
                                  **KW_W))


def test_packed_true_with_bf16_raises_the_reference_error():
    with pytest.raises(ValueError, match="packed=True is incompatible with dtype='bfloat16'"):
        port.solve(_binary(), 4, dtype="bfloat16", packed=True, **FUSED)
    with pytest.raises(ValueError, match="incompatible with dtype='bfloat16'"):
        jref.solve(_binary(), 4, dtype="bfloat16", packed=True, backend="pallas",
                   pallas_interpret=True, max_iter=2)


def test_packed_matrix_with_bf16_raises_the_reference_error():
    pm = port.pack_matrix(_binary(), 4, device="cpu")
    with pytest.raises(ValueError, match="PackedMatrix input requires float32 compute"):
        port.solve(pm, 4, dtype="bfloat16", **FUSED)
    ref_pm = jref.pack_matrix(_binary(256, 200), 4)
    with pytest.raises(ValueError, match="PackedMatrix input requires float32 compute"):
        jref.solve(ref_pm, 4, dtype="bfloat16", backend="pallas", pallas_interpret=True)


def test_grid_packed_true_with_bf16_raises():
    with pytest.raises(ValueError, match="bfloat16"):
        port.grid_solve(_binary(30, 24), 3, [1.0], [1.0], packed=True, dtype="bfloat16",
                        backend="fused", device="cpu", max_iter=10)
    with pytest.raises(ValueError, match="bfloat16"):
        jax_grid_solve(_binary(30, 24).astype(float), 3, [1.0], [1.0], packed=True,
                       dtype="bfloat16", backend="pallas", pallas_interpret=True,
                       block_m=128, block_n=128, max_iter=10)


def test_grid_bf16_is_data_storage_only():
    """As ``tests/test_rdata_and_grid.py`` pins it for the JAX package: the
    losses stay float32, the bf16 grid tracks the float32 grid on binary
    data, and it does not stop absurdly early."""
    X = (np.random.default_rng(6).random((30, 24)) < 0.3).astype(float)
    kw = dict(max_iter=40, tol=1e-7, backend="fused", device="cpu")
    res = port.grid_solve(X, 3, [1.0, 2.0], [1.5], dtype="bfloat16", **kw)
    ref = port.grid_solve(X, 3, [1.0, 2.0], [1.5], dtype="float32", **kw)
    assert res["losses"].dtype == np.float32
    np.testing.assert_allclose(res["losses"], ref["losses"], atol=5e-3)
    assert np.all(res["n_iter"] >= 10)
    # the cells are lanes of one solve: each equals the standalone bf16 solve
    for g, (a, b) in enumerate(zip(res["alpha"], res["beta"])):
        one = port.solve(X, 3, alpha=float(a), beta=float(b), dtype="bfloat16", random_state=0,
                         **kw)
        assert one.n_iter == res["n_iter"][g]
        np.testing.assert_allclose(one.W, res["W"][g], rtol=0, atol=1e-6)


def test_estimator_fits_and_transforms_in_bf16():
    X = _binary(80, 60)
    est = port.NBMF(n_components=4, max_iter=20, random_state=0, dtype="bfloat16",
                    backend="fused", device="cpu").fit(X)
    assert est.solver_result_.extras["data_dtype"] == "bfloat16"
    assert np.all(np.isfinite(est.loss_curve_)) and est.W_.dtype == np.float32
    W = est.transform(X[:10])  # the fused fold-in over bf16 data
    assert W.shape == (10, 4) and np.allclose(W.sum(axis=1), 1.0, atol=1e-5)
    plain = port.NBMF(n_components=4, max_iter=20, random_state=0, dtype="bfloat16",
                      backend="plain", device="cpu").fit(X)
    assert plain.solver_result_.extras == {"backend": "plain", "packed": False,
                                           "precision": "default"}
    assert np.isfinite(plain.transform(X[:10])).all()


def test_fold_in_server_in_bf16():
    """``FoldInServer(dtype="bfloat16")`` streams bf16 chunks through the
    bf16-data W pass, never packed; batched and unbatched agree row by row."""
    H = np.random.default_rng(3).uniform(0.1, 0.9, (4, 50))
    X = _binary(70, 50)
    server = port.FoldInServer(H, buckets=(32, 64), dtype="bfloat16", backend="fused",
                               device="cpu")
    assert server.data_dtype == torch.bfloat16 and server.precision == "default"
    W, s = server.transform(X)
    assert W.shape == (70, 4) and np.isfinite(s).all()
    W1, _ = port.fold_in_fused(H, X[:32], W0t=None, dtype="bfloat16", device="cpu")
    assert np.isfinite(W1).all()
    with pytest.raises(ValueError, match="bfloat16"):
        port.FoldInServer(H, dtype="bfloat16", packed=True, backend="fused", device="cpu")
