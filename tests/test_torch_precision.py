"""The port's product precision tiers (``precision="high"``/``"default"``).

``nbmf_mm_tpu_torch/ops/tiers.py`` defines them: ``"high"`` rounds each
operand of each product to TF32 (ties away from zero), ``"default"`` to bf16
(nearest even), both then multiply in fp32 and add in fp32; ``None`` and
``"highest"`` are IEEE fp32.  The rounding is explicit, so on the CPU the
plain versions compute the tier the kernels compute on the card.

- Each plain version (K1, K2 and the four dense kernels) against an
  emulation written here: its own bit-level roundings, the elementwise terms
  in float32 as the tier defines them, every product and the log-likelihood
  in float64.  On the grid draw (W on a 1/64 grid, H on a 1/16 grid: every
  operand is exact in both formats and ``WH`` is exact in any order) within
  1e-6 of max |ref|; on random draws within 2e-5, since a last-bit
  difference of an f32 sum can flip one operand's rounding (the worst case
  here is 4.7e-6, TF32 on ``[0, 1]``-valued data).
- DEFAULT on float32 binary data against the JAX package's bf16-data kernels
  (interpret mode, x64 off): the H pass and ``loglik_sum`` agree within 1e-6
  on the grid draw; the W pass agrees where ``h`` is bf16-exact and parts
  where ``h`` is small, by the rule for ``1 - h``.
- Against the JAX float32 kernels (on the CPU every JAX tier is fp32):
  ``"high"`` within 2e-3 and ``"default"`` within 1e-2 of max |ref|, and the
  error against the float64 truth is ordered highest < high < default.
- ``None`` and ``"highest"`` are bitwise the untiered results; the losses
  descend per tier (1e-4 at fp32, 2e-3 under a reduced tier, R5); packed
  equals dense bitwise in every tier; ``grid_solve``, ``FoldInServer``,
  ``fold_in_fused`` and ``NBMF.transform`` run their tier.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.ops import pallas_sweep as ps
from nbmf_mm_tpu_torch.models import estimator as port_estimator
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds
from nbmf_mm_tpu_torch.ops import tiers

torch.set_num_threads(1)

EPS = 1e-8
M, N, K, BM = 256, 384, 8, 256
M_REAL, N_REAL = M - 20, N - 40  # a ragged real region inside the blocks
BLOCK = dict(block_m=256, block_n=384, interpret=True)
MODES = ("unmasked", "parity", "corrected")
TOL = {"grid": 1e-6, "random": 2e-5}
FORM = {"highest": "f32", "high": "tf32r", "default": "bf16r"}
KW_H = dict(eps=EPS, m_real=M_REAL, n_real=N_REAL)
KW_W = dict(eps=EPS, n_real=N_REAL)


@pytest.fixture
def interpret_x32(monkeypatch):
    """Every pallas_call in interpret mode, and x64 off, for one test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


# -------------------------------------------------------------- emulation
def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)


def _bf16(x):
    """bf16, nearest even, on the float32 bits (finite values)."""
    u = _bits(x)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _tf32(x):
    """TF32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, ties away from zero."""
    return ((_bits(x) + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


ROUND = {"f32": lambda x: np.asarray(x, np.float32), "bf16r": _bf16, "tf32r": _tf32}


def _emulate(kind, form, W, H, Ym, Y2):
    """The outputs of an H pass (``kind`` "h": Num, Den, ll) or a W pass
    ("w": T) under ``form``: operands rounded, the ratios in float32, every
    product and the log-likelihood in float64."""
    rnd, f32, f64 = ROUND[form], np.float32, lambda A: A.astype(np.float64)
    W, H, Ym = W.numpy(), H.numpy(), Ym.float().numpy()
    Y2 = None if Y2 is None else Y2.float().numpy()
    Wr, Hr = rnd(W), rnd(H)
    WH = (f64(Wr).T @ f64(Hr)).astype(f32)
    a = WH + f32(EPS)
    b = np.maximum(f32(1) - WH, f32(0)) + f32(EPS)
    r = f32(1) / (a * b)
    if kind == "w":
        if Y2 is None:
            Y2 = np.where(np.arange(N) < N_REAL, f32(1) - Ym, f32(0))
        p, q = rnd(Ym * (b * r)), rnd(Y2 * (a * r))
        return (f64(Hr) @ f64(p).T + f64(rnd(f32(1) - H)) @ f64(q).T,)
    yc = f32(1) - Ym if Y2 is None else Y2
    p, q = rnd(Ym * (b * r)), rnd(yc * (a * r))
    real = (np.arange(M)[:, None] < M_REAL) & (np.arange(N)[None, :] < N_REAL)
    ll = np.where(real, f64(Ym) * np.log(f64(a)) + f64(yc) * np.log(f64(b)), 0.0).sum()
    return f64(Wr) @ f64(p), f64(Wr) @ f64(q), ll


# ---------------------------------------------------------------- operands
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
    """float32 ``Ym``, the H pass's ``Yc``, the W pass's ``Ym2`` (zero outside
    the real region) and, for binary masks, their words."""
    rng = np.random.default_rng(seed)
    real = np.zeros((M, N), bool)
    real[:M_REAL, :N_REAL] = True
    Y = (rng.random((M, N)) < 0.3) if data != "soft" else rng.random((M, N))
    u = rng.random((M, N))
    mask = np.where(u < 0.8, np.where(u < 0.16, 0.5, 1.0) if data == "weighted" else 1.0, 0.0)
    t = lambda A: torch.tensor(np.where(real, A, 0.0), dtype=torch.float32)
    Ym, Ym2 = (t(Y), None) if mode == "unmasked" else (t(Y * mask), t((1.0 - Y) * mask))
    o = dict(Ym=Ym, Yc=Ym2 if mode == "corrected" else None, Ym2=Ym2)
    if data == "binary":
        pack = lambda A: None if A is None else cs.pack_bits(A, BM)
        o.update(words=pack(Ym), words2_h=pack(o["Yc"]), words2_w=pack(Ym2))
    return o


# name: (pass kind, the second operand, the port's call under a precision)
KERNELS = {
    "hloss_terms_packed": ("h", "Yc", lambda W, H, o, pr: cs.hloss_terms_packed(
        W, H, o["words"], o["words2_h"], bm=BM, precision=pr, **KW_H)),
    "w_terms_packed": ("w", "Ym2", lambda W, H, o, pr: cs.w_terms_packed(
        W, H, o["words"], o["words2_w"], bm=BM, precision=pr, **KW_W)),
    "hloss_terms": ("h", "Yc", lambda W, H, o, pr: ds.hloss_terms(
        W, H, o["Ym"], o["Yc"], bm=BM, precision=pr, **KW_H)),
    "w_terms": ("w", "Ym2", lambda W, H, o, pr: ds.w_terms(
        W, H, o["Ym"], o["Ym2"], bm=BM, precision=pr, **KW_W)),
    "loglik_sum": ("ll", "Yc", lambda W, H, o, pr: ds.loglik_sum(
        W, H, o["Ym"], o["Yc"], bm=BM, precision=pr, **KW_H)),
    "h_terms": ("hterms", "Yc", lambda W, H, o, pr: ds.h_terms(
        W, H, o["Ym"], o["Yc"], eps=EPS, bm=BM, precision=pr)),
}
DENSE = [name for name in KERNELS if not name.endswith("_packed")]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _expected(kernel, form, W, H, o):
    kind, second, _ = KERNELS[kernel]
    out = _emulate("w" if kind == "w" else "h", form, W, H, o["Ym"], o[second])
    return {"h": out, "w": out, "ll": out[2:], "hterms": out[:2]}[kind]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _worst(got, ref) -> float:
    return max(_rel(g, r) for g, r in zip(_as_tuple(got), _as_tuple(ref)))


# ------------------------------------------------- plain versions vs emulation
EMULATION_CASES = (
    [(kernel, "binary", mode) for kernel in KERNELS for mode in MODES]
    + [(kernel, "weighted", mode) for kernel in DENSE for mode in ("parity", "corrected")]
    + [(kernel, "soft", "unmasked") for kernel in DENSE])


@pytest.mark.parametrize("draw", ["grid", "random"])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("kernel, data, mode", EMULATION_CASES)
def test_plain_versions_match_the_float64_emulation(kernel, data, mode, precision, draw):
    W, H = _factors(draw, 1)
    o = _operands(data, mode, 2)
    got = _as_tuple(KERNELS[kernel][2](W, H, o, precision))
    assert all(t.dtype == torch.float32 for t in got)
    assert _worst(got, _expected(kernel, FORM[precision], W, H, o)) <= TOL[draw]


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_emulation_tells_the_tiers_apart(kernel):
    """A tier's plain version is far nearer its own emulation than the other
    tiers' (the log-likelihood, a sum of logs, least so)."""
    W, H = _factors("random", 3)
    o = _operands("binary", "corrected", 4)
    got = KERNELS[kernel][2](W, H, o, "default")
    own = _worst(got, _expected(kernel, "bf16r", W, H, o))
    assert min(_worst(got, _expected(kernel, form, W, H, o)) for form in ("tf32r", "f32")) > (
        100 * own)


def test_tf32_rounding_is_the_hardware_rule():
    """``tiers.round_tf32`` on the values where the rule shows: ties go away
    from zero, the 13 low bits clear, infinities and NaNs pass."""
    one = 1.0 + 2.0 ** -10  # a TF32 value: unchanged
    tie = 1.0 + 2.0 ** -11  # half a TF32 ulp above 1: rounds up, not to even
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23
    x = torch.tensor([one, tie, below, -tie, float("inf"), 3.0e38], dtype=torch.float32)
    got = tiers.round_tf32(x)
    assert got[:4].tolist() == [one, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]
    assert got[4] == float("inf") and torch.isnan(tiers.round_tf32(torch.tensor(float("nan"))))
    np.testing.assert_array_equal(got.numpy(), _tf32(x.numpy()))
    y = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, 10_000).astype(np.float32))
    np.testing.assert_array_equal(tiers.round_bf16(y).numpy(), _bf16(y.numpy()))


# ------------------------------------------ DEFAULT against the bf16-data mode
def _jnp(t, bf16=False):
    if t is None:
        return None
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if bf16 else a


JAX_BF16 = {
    "hloss_terms": lambda W, H, o: ps.hloss_terms(W, H, o["Ym"], o["Yc"], **KW_H, **BLOCK),
    "loglik_sum": lambda W, H, o: ps.loglik_sum(W, H, o["Ym"], o["Yc"], **KW_H, **BLOCK),
    "h_terms": lambda W, H, o: ps.h_terms(W, H, o["Ym"], o["Yc"], eps=EPS, **BLOCK),
    "w_terms": lambda W, H, o: ps.w_terms(W, H, o["Ym"], o["Ym2"], **KW_W, **BLOCK),
}
JAX_OF = {"hloss_terms_packed": "hloss_terms", "w_terms_packed": "w_terms"}


def _jax_bf16_data(kernel, W, H, o):
    """The JAX kernel on the same values stored bf16 (its bf16-data mode)."""
    jo = {name: _jnp(o[name], bf16=True) for name in ("Ym", "Yc", "Ym2")}
    return _as_tuple(JAX_BF16[JAX_OF.get(kernel, kernel)](_jnp(W), _jnp(H), jo))


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", ["hloss_terms_packed", "hloss_terms", "loglik_sum",
                                    "h_terms"])
def test_default_h_pass_computes_the_jax_bf16_data_kernels(kernel, mode):
    """Binary data is bf16-exact, so the DEFAULT tier over float32 data rounds
    the operands the JAX bf16-data kernels round."""
    W, H = _factors("grid", 5)
    o = _operands("binary", mode, 6)
    got = _as_tuple(KERNELS[kernel][2](W, H, o, "default"))
    assert _worst(got, _jax_bf16_data(kernel, W, H, o)) <= 1e-6


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", ["w_terms_packed", "w_terms"])
def test_default_w_pass_parts_from_the_bf16_data_mode_only_at_small_h(kernel, mode):
    o = _operands("binary", mode, 7)
    W, H = _factors("grid", 8)  # h on a 1/16 grid: the two rules for 1 - h agree
    got = KERNELS[kernel][2](W, H, o, "default")
    assert _rel(got, _jax_bf16_data(kernel, W, H, o)[0]) <= 1e-6
    W, H = _factors("small-h", 9)  # round(1 - h) = 1 - 2^-8, round(1 - round(h)) = 1
    got = KERNELS[kernel][2](W, H, o, "default")
    assert _rel(got, _jax_bf16_data(kernel, W, H, o)[0]) > 1e-3
    assert _rel(got, _expected(kernel, "bf16r", W, H, o)[0]) <= 1e-4


# --------------------------------------------- against the JAX fp32 kernels
JAX_F32 = {
    "hloss_terms_packed": lambda W, H, o: ps.hloss_terms_packed(
        W, H, o["words"], o["words2_h"], eps=EPS, block_m=BM, interpret=True)[:2],
    "w_terms_packed": lambda W, H, o: ps.w_terms_packed(
        W, H, o["words"], o["words2_w"], n_real=N_REAL, eps=EPS, block_m=BM, interpret=True),
    **JAX_BF16,
}


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("precision, tol", [("high", 2e-3), ("default", 1e-2)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_tiers_stay_near_the_jax_float32_kernels(kernel, precision, tol):
    W, H = _factors("random", 10)
    o = _operands("binary", "parity", 11)
    jo = {name: None if t is None else jnp.asarray(t.numpy()) for name, t in o.items()}
    ref = _as_tuple(JAX_F32[kernel](_jnp(W), _jnp(H), jo))
    got = _as_tuple(KERNELS[kernel][2](W, H, o, precision))[:len(ref)]
    if kernel == "loglik_sum":  # the JAX dense loss counts the pad as the port does not
        ref = (_expected(kernel, "f32", W, H, o)[0],)
    assert _worst(got, ref) <= tol


@pytest.mark.parametrize("kernel", KERNELS)
def test_error_against_the_float64_truth_is_ordered_by_tier(kernel):
    W, H = _factors("random", 12)
    o = _operands("binary", "corrected", 13)
    wide = {name: None if t is None or t.dtype == torch.int32 else t.double()
            for name, t in o.items()}
    wide.update({name: o[name] for name in ("words", "words2_h", "words2_w")})
    truth = _as_tuple(KERNELS[kernel][2](W.double(), H.double(), wide, None))
    err = {pr: _worst(KERNELS[kernel][2](W, H, o, pr), truth)
           for pr in ("highest", "high", "default")}
    assert err["highest"] < err["high"] < err["default"], err


# ----------------------------------------------- None and "highest" unchanged
@pytest.mark.parametrize("kernel", KERNELS)
def test_none_and_highest_are_the_untiered_kernels_bitwise(kernel):
    W, H = _factors("random", 14)
    o = _operands("binary", "corrected", 15)
    call = KERNELS[kernel][2]
    base = _as_tuple(call(W, H, o, None))
    for precision in ("highest", "HIGHEST"):
        assert all(map(torch.equal, base, _as_tuple(call(W, H, o, precision))))


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_solve_none_and_highest_are_bitwise_the_default_call(backend):
    Y = _binary(64, 48)
    kw = dict(max_iter=8, random_state=0, backend=backend, device="cpu")
    base = port.solve(Y, 4, **kw)
    for precision in (None, "highest", "Highest"):
        res = port.solve(Y, 4, precision=precision, **kw)
        assert res.losses == base.losses and np.array_equal(res.W, base.W)
        assert "precision" not in res.extras


@pytest.mark.parametrize("bad", ["fastest", "bf16", 3])
def test_unknown_precision_raises(bad):
    with pytest.raises(ValueError, match="precision"):
        port.solve(_binary(), 2, max_iter=2, precision=bad, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        port.FoldInServer(np.full((2, 16), 0.5), precision=bad, device="cpu")


# ------------------------------------------------------------- solve level
def _binary(m=24, n=16, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < 0.4).astype(np.float32)


def _descends(losses, rel_rise):
    losses = np.asarray(losses, np.float64)
    return bool(np.isfinite(losses).all()
                and np.all(np.diff(losses) <= rel_rise * np.abs(losses[:-1])))


@pytest.mark.parametrize("backend", ["fused", "plain"])
@pytest.mark.parametrize("precision, rise", [(None, 1e-4), ("highest", 1e-4), ("high", 2e-3),
                                             ("default", 2e-3)])
def test_losses_descend_per_tier(precision, rise, backend):
    P = np.random.default_rng(16).random((96, 80)).astype(np.float32)
    res = port.solve(P, 5, max_iter=60, tol=0.0, random_state=1, precision=precision,
                     dtype="float32", backend=backend, device="cpu")
    assert res.n_iter == 60 and _descends(res.losses, rise)
    assert res.extras.get("precision", "highest") == (precision or "highest")


@pytest.mark.parametrize("mask_mode", MODES)
@pytest.mark.parametrize("precision", ["high", "default"])
def test_packed_equals_dense_bitwise_per_tier(precision, mask_mode):
    Y = _binary(70, 50, seed=2)
    kw = dict(max_iter=12, random_state=0, precision=precision, backend="fused", device="cpu")
    if mask_mode != "unmasked":
        kw.update(mask=_binary(70, 50, seed=3) * 0 + (np.random.default_rng(4).random(
            (70, 50)) < 0.8), mask_mode=mask_mode)
    packed = port.solve(Y, 4, packed=True, **kw)
    dense = port.solve(Y, 4, packed=False, **kw)
    assert packed.extras["packed"] and not dense.extras["packed"]
    assert packed.losses == dense.losses
    assert np.array_equal(packed.W, dense.W) and np.array_equal(packed.H, dense.H)


# ---------------------------------------------------------- entry points
@pytest.fixture
def tiers_seen(monkeypatch):
    """The ``precision`` every kernel wrapper is called with."""
    seen = []
    for module, name in ((cs, "hloss_terms_packed"), (cs, "w_terms_packed"),
                         (ds, "hloss_terms"), (ds, "w_terms"), (ds, "loglik_sum")):
        real = getattr(module, name)

        def record(*a, _real=real, **kw):
            seen.append(kw.get("precision"))
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, record)
    return seen


@pytest.mark.parametrize("precision", ["high", "default"])
def test_grid_cells_run_the_tier_as_lanes_of_standalone_solves(precision, tiers_seen):
    X = _binary(30, 24, seed=5)
    kw = dict(max_iter=30, tol=1e-7, precision=precision, backend="fused", device="cpu")
    g = port.grid_solve(X, 3, [1.0, 2.0], [1.5, 1.0], pair_mode="zip", **kw)
    assert set(tiers_seen) == {precision}
    for c, (a, b) in enumerate(zip(g["alpha"], g["beta"])):
        one = port.solve(X, 3, alpha=float(a), beta=float(b), random_state=0, **kw)
        assert one.n_iter == g["n_iter"][c]
        np.testing.assert_allclose(one.W, g["W"][c], rtol=0, atol=1e-6)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_fold_in_server_runs_its_tier(precision, tiers_seen):
    H = np.random.default_rng(6).uniform(0.1, 0.9, (4, 50))
    X = _binary(40, 50, seed=7)
    mask = np.where(np.random.default_rng(8).random(X.shape) < 0.2, 0.5, 1.0)
    kw = dict(buckets=(32, 64), precision=precision, device="cpu")
    server = port.FoldInServer(H, backend="fused", **kw)
    plain = port.FoldInServer(H, backend="plain", **kw)
    assert server.precision == plain.precision == precision
    for m in (None, mask):
        W, scores = server.transform(X, mask=m)
        W_plain, _ = plain.transform(X, mask=m)
        assert np.isfinite(scores).all()
        np.testing.assert_allclose(W, W_plain, rtol=0, atol=1e-4)
    assert set(tiers_seen) == {precision} and len(tiers_seen) > 0
    W_hi, _ = port.FoldInServer(H, backend="fused", buckets=(32, 64), device="cpu").transform(X)
    assert not np.array_equal(W_hi, server.transform(X)[0])


@pytest.mark.parametrize("precision", ["high", "default"])
def test_fold_in_fused_rows_batched_equal_rows_alone(precision, tiers_seen):
    H = np.random.default_rng(9).uniform(0.1, 0.9, (4, 50))
    X = _binary(20, 50, seed=10)
    W0t = np.random.default_rng(11).uniform(0.1, 0.9, (4, 20))
    kw = dict(n_iter=20, mxu_precision=precision, device="cpu")
    W, _ = port.fold_in_fused(H, X, W0t=W0t, **kw)
    for rows in (slice(0, 7), slice(7, 20)):
        part, _ = port.fold_in_fused(H, X[rows], W0t=W0t[:, rows], **kw)
        np.testing.assert_allclose(part, W[rows], rtol=0, atol=1e-6)
    assert set(tiers_seen) == {precision}
    W_eps, _ = port.fold_in_fused(H, X, W0t=W0t, eps=1e-3, **kw)
    assert np.abs(W_eps - W).max() > 1e-6


@pytest.mark.parametrize("backend", ["fused", "plain"])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_estimator_transform_runs_its_tier(precision, backend, tiers_seen, monkeypatch):
    X = _binary(60, 40, seed=12)
    plain_tiers = []
    real = port_estimator.fold_in_w_update
    monkeypatch.setattr(port_estimator, "fold_in_w_update", lambda *a, **kw: (
        plain_tiers.append(kw.get("precision")), real(*a, **kw))[1])
    kw = dict(n_components=3, max_iter=15, random_state=0, backend=backend, device="cpu")
    est = port.NBMF(precision=precision, **kw).fit(X)
    assert est.solver_result_.extras["precision"] == precision
    del tiers_seen[:]
    W = est.transform(X[:12])
    assert W.shape == (12, 3) and np.allclose(W.sum(axis=1), 1.0, atol=1e-5)
    assert set(tiers_seen if backend == "fused" else plain_tiers) == {precision}
    ref = port.NBMF(**kw).fit(X)
    assert not np.array_equal(W, ref.transform(X[:12]))


@pytest.mark.parametrize("bf16", [False, True], ids=["default-tier", "bf16-data"])
def test_vmapped_solve_runs_a_tier_core_lane_by_lane(bf16, tiers_seen):
    """``vmapped_solve`` over the fused core of a tier (or over bf16 data):
    each lane equals that core on the lane's inits alone."""
    from functools import partial

    from nbmf_mm_tpu_torch.parallel.restarts import vmapped_solve
    from nbmf_mm_tpu_torch.solver import driver as pd

    m, n, k, R = 70, 50, 3, 3
    bm, Mp, Np = cs.plan_packing(m, n)
    Y = torch.zeros((Mp, Np))
    Y[:m, :n] = torch.from_numpy(np.random.default_rng(13).random((m, n)).astype(np.float32))
    Y = Y.to(torch.bfloat16) if bf16 else Y
    rng = np.random.default_rng(14)
    W0 = torch.zeros((R, k, Mp))
    W0[:, :, :m] = torch.from_numpy(rng.uniform(0.1, 0.9, (R, k, m)).astype(np.float32))
    W0[:, :, :m] /= W0[:, :, :m].sum(dim=1, keepdim=True)
    H0 = torch.zeros((R, k, Np))
    H0[:, :, :n] = torch.from_numpy(rng.uniform(0.1, 0.9, (R, k, n)).astype(np.float32))
    core = partial(pd._solve_core_fused, packed=False, eps=EPS, m_real=m, n_real=n, bm=bm,
                   max_iter=10, projection="normalize", verbose=0, mxu_precision="default")
    hypers = (1.2, 1.2, 0.0, float(m * n))
    best, index, finals, lanes = vmapped_solve(core, (Y, None, None), (W0, H0), hypers,
                                               keep_all=True)
    assert set(tiers_seen) == {"default"}
    for r in range(R):
        one = core(Y, None, None, W0[r], H0[r], *hypers)
        np.testing.assert_allclose(lanes[0][r].numpy(), one[0].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(finals[r]), float(one[4]), rtol=1e-6)
