"""Restarts on the port: ``n_init`` lanes through one batched solve, held
against the JAX package's ``vmap``-ed solve on the CPU.

torch generators cannot reproduce JAX ``PRNGKey`` draws, so every comparison
feeds both packages the same numpy inits: the cores take them directly
(through ``utils.interop.restart_inits_from_reference``), and for ``solve``
and ``NBMF`` both packages' ``_random_uniform_inits`` are replaced (each
package reads the function from its module at call time).

Bars, all in float64 unless a case says float32: the plain cores against the
JAX ``_solve_core`` under ``vmapped_solve``: ``n_iter``, ``done`` and the best
lane equal, factors and losses within 1e-10; the fused cores against
``_solve_core_pallas`` in interpret mode: the same within 1e-8 (its kernels
add in another order); a lane against its own standalone solve in the port:
bitwise on the plain route (the batched plain functions run lane by lane),
1e-12 on the fused route (``torch`` reduces the priors over a lane axis);
packed, sparse and dense input give bitwise the same restarts.
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.ops import pallas_sweep as ps
from nbmf_mm_tpu.parallel.restarts import vmapped_solve as jax_vmapped_solve
from nbmf_mm_tpu.solver import driver as jd
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops.updates import map_objective, mm_sweep, precompute_masked_terms
from nbmf_mm_tpu_torch.parallel.restarts import vmapped_solve
from nbmf_mm_tpu_torch.solver import driver as pd
from nbmf_mm_tpu_torch.utils.interop import restart_inits_from_reference

torch.set_num_threads(1)

EPS = 1e-8
TOL_PLAIN = 1e-10  # the same formulas in float64, matmuls in another order
TOL_PALLAS = 1e-8  # interpret-mode kernels add tile by tile
TOL_LANE = 1e-12  # one lane of a fused batch against its own solve


def _toy(m=40, n=30, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


@functools.lru_cache(maxsize=None)
def _structured(m=128, n=128, k=3, seed=11):
    """Binary data with cluster structure, so that lanes stop at different
    sweeps, and an 80% mask."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, k, size=m)
    protos = rng.random((k, n)) < np.array([0.7, 0.2, 0.5])[:k, None]
    P = np.clip(protos[z] * rng.uniform(0.6, 0.95, (m, 1)), 0.03, 0.97)
    Y = (rng.random((m, n)) < P).astype(np.float64)
    mask = (rng.random((m, n)) < 0.8).astype(np.float64)
    return Y, mask


def _np_inits(R, m, n, k, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.9, (R, m, k)), rng.uniform(0.1, 0.9, (R, k, n))


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


# ------------------------------------------- the batched plain functions
@pytest.mark.parametrize("projection", ["normalize", "duchi"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_batched_mm_sweep_and_objective_equal_the_lane_calls_bitwise(masked, projection):
    Y, mask = _structured(40, 30)
    Ym, Ym2, Yc = precompute_masked_terms(torch.tensor(Y), torch.tensor(mask) if masked
                                          else None)
    W0, H0 = restart_inits_from_reference(*_np_inits(4, 40, 30, 3), dtype="float64",
                                          device="cpu")
    alphas, betas = np.array([0.5, 1.2, 2.0, 3.0]), [1.0, 1.2, 2.5, 0.7]
    kw = dict(n_real=30, eps=EPS, projection=projection)
    W, H = mm_sweep(W0, H0, Ym, Ym2, Yc, alpha=alphas, beta=betas, **kw)
    loss = map_objective(W, H, Ym, Yc, alpha=alphas, beta=betas, n_obs=1200.0, eps=EPS)
    assert W.shape == W0.shape and H.shape == H0.shape and loss.shape == (4,)
    for r in range(4):
        Wr, Hr = mm_sweep(W0[r], H0[r], Ym, Ym2, Yc, alpha=float(alphas[r]), beta=betas[r], **kw)
        assert torch.equal(W[r], Wr) and torch.equal(H[r], Hr)
        assert torch.equal(loss[r], map_objective(Wr, Hr, Ym, Yc, alpha=float(alphas[r]),
                                                  beta=betas[r], n_obs=1200.0, eps=EPS))
    # one float for every lane
    W1, _ = mm_sweep(W0, H0, Ym, Ym2, Yc, alpha=1.2, beta=1.2, **kw)
    assert torch.equal(W1[2], mm_sweep(W0[2], H0[2], Ym, Ym2, Yc, alpha=1.2, beta=1.2, **kw)[0])


# ------------------------------------------------ the cores against JAX's
def _plain_cores(Y, mask, mask_mode, W0e, H0e, *, tol, max_iter, projection="normalize",
                 alpha=1.2, beta=1.2):
    """``(port, jax)`` results of the plain cores through each package's
    ``vmapped_solve`` (``keep_all``), float64."""
    m, n = Y.shape
    n_obs = float(m * n if mask is None else np.count_nonzero(mask))
    t = lambda A: None if A is None else torch.tensor(A)
    data = precompute_masked_terms(t(Y), t(mask), mask_mode)
    inits = restart_inits_from_reference(W0e, H0e, dtype="float64", device="cpu")
    core = partial(pd._solve_core, max_iter=max_iter, projection=projection, verbose=0)
    got = vmapped_solve(core, data, inits, (alpha, beta, tol, EPS, n_obs, n), keep_all=True)

    from nbmf_mm_tpu.ops.updates import precompute_masked_terms as jax_terms

    jdata = jax_terms(jnp.asarray(Y), None if mask is None else jnp.asarray(mask), mask_mode)
    W0 = jnp.swapaxes(jnp.asarray(W0e), 1, 2)
    W0 = W0 / W0.sum(axis=1, keepdims=True)
    jcore = partial(jd._solve_core, max_iter=max_iter, projection=projection,
                    precision=jax.lax.Precision.HIGHEST, verbose=0)
    f = lambda x: jnp.array(x, dtype=jnp.float64)
    want = jax_vmapped_solve(jcore, jdata, (W0, jnp.asarray(H0e)),
                             (f(alpha), f(beta), f(tol), f(EPS), f(n_obs), f(n)), keep_all=True)
    return got, want


def _assert_restarts_match(got, want, tol, *, cols=None):
    (_, best, finals, results), (_, jbest, jfinals, jresults) = got, want
    W, H, losses, n_iter, final_loss, done = (x.numpy() for x in results)
    jW, jH, jlosses, jn_iter, jfinal, jdone = (np.asarray(x) for x in jresults)
    if cols is not None:  # the JAX package pads the columns further
        jH, jW = jH[:, :, :cols[1]], jW[:, :, :cols[0]]
        W, H = W[:, :, :cols[0]], H[:, :, :cols[1]]
    np.testing.assert_array_equal(n_iter, jn_iter)
    np.testing.assert_array_equal(done, jdone)
    assert best == jbest
    _close(W, jW, tol)
    _close(H, jH, tol)
    _close(final_loss, jfinal, tol)
    _close(finals.numpy(), jfinals, tol)
    for r, it in enumerate(n_iter):  # JAX leaves entries past n_iter undefined
        _close(losses[r, :it], jlosses[r, :it], tol)
        assert not losses[r, it:].any()
    return n_iter, done


@pytest.mark.parametrize("mask_mode", [None, "parity", "corrected"])
def test_plain_core_matches_the_jax_vmapped_core(mask_mode):
    Y, mask = _structured()
    got, want = _plain_cores(Y, None if mask_mode is None else mask, mask_mode or "parity",
                             *_np_inits(4, 128, 128, 3), tol=1e-4, max_iter=120)
    n_iter, done = _assert_restarts_match(got, want, TOL_PLAIN)
    assert done.all() and len(set(n_iter.tolist())) > 1  # lanes froze at different sweeps


def test_plain_core_out_of_sweeps_and_duchi():
    Y, _ = _structured()
    got, want = _plain_cores(Y, None, "parity", *_np_inits(3, 128, 128, 3, seed=6), tol=1e-9,
                             max_iter=7, projection="duchi", alpha=2.0, beta=0.8)
    n_iter, done = _assert_restarts_match(got, want, TOL_PLAIN)
    assert (n_iter == 7).all() and not done.any()


def test_frozen_plain_lane_equals_its_standalone_solve_bitwise():
    Y, mask = _structured()
    data = precompute_masked_terms(torch.tensor(Y), torch.tensor(mask), "parity")
    W0, H0 = restart_inits_from_reference(*_np_inits(4, 128, 128, 3), dtype="float64",
                                          device="cpu")
    core = partial(pd._solve_core, max_iter=120, projection="normalize", verbose=0)
    hypers = (1.2, 1.2, 1e-4, EPS, float(np.count_nonzero(mask)), 128)
    W, H, losses, n_iter, final_loss, done = core(*data, W0, H0, *hypers)
    assert n_iter.min() < n_iter.max() < 120
    for r in range(4):
        Wr, Hr, lr, it, fr, dr = core(*data, W0[r], H0[r], *hypers)
        assert isinstance(it, int) and isinstance(dr, bool)
        assert it == int(n_iter[r]) and dr == bool(done[r])
        assert torch.equal(W[r], Wr) and torch.equal(H[r], Hr)
        assert torch.equal(losses[r], lr) and torch.equal(final_loss[r], fr)


def _fused_cores(Y, mask, mask_mode, W0e, H0e, *, packed, tol, max_iter, projection="normalize"):
    """``(port, jax)`` results of the fused core and ``_solve_core_pallas``
    (interpret mode) at a shape that needs no padding (a multiple of 128)."""
    m, n = Y.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    assert (Mp, Np) == (m, n) and m % 128 == 0 and n % 128 == 0
    n_obs = float(m * n if mask is None else np.count_nonzero(mask))
    Ym = Y if mask is None else Y * mask
    Ym2 = None if mask is None else (1.0 - Y) * mask
    stage = (lambda A: None if A is None else torch.tensor(cs.pack_bits_host(A, bm))) if packed \
        else (lambda A: None if A is None else torch.tensor(A))
    Y1, Y2 = stage(Ym), stage(Ym2)
    inits = restart_inits_from_reference(W0e, H0e, dtype="float64", device="cpu")
    core = partial(pd._solve_core_fused, packed=packed, eps=EPS, m_real=m, n_real=n, bm=bm,
                   max_iter=max_iter, projection=projection, verbose=0)
    got = vmapped_solve(core, (Y1, Y2 if mask_mode == "corrected" else None, Y2), inits,
                        (1.2, 1.2, tol, n_obs), keep_all=True)

    _, stripe_bm = ps.select_stripe(W0e.shape[2], m, n, 1 + (Ym2 is not None), packed=packed)
    jstage = (lambda A: None if A is None else jnp.asarray(ps.pack_bits_host(A, stripe_bm))) \
        if packed else (lambda A: None if A is None else jnp.asarray(A))
    jY1, jY2 = jstage(Ym), jstage(Ym2)
    W0 = jnp.swapaxes(jnp.asarray(W0e), 1, 2)
    W0 = W0 / W0.sum(axis=1, keepdims=True)
    jcore = partial(jd._solve_core_pallas, max_iter=max_iter, projection=projection, verbose=0,
                    eps=EPS, m_real=m, n_real=n, block_m=128, block_n=128, interpret=True,
                    packed=packed)
    f = lambda x: jnp.array(x, dtype=jnp.float64)
    want = jax_vmapped_solve(jcore, (jY1, jY2, jY2 if mask_mode == "corrected" else None),
                             (W0, jnp.asarray(H0e)), (f(1.2), f(1.2), f(tol), f(n_obs)),
                             keep_all=True)
    return got, want


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("mask_mode", [None, "corrected"])
def test_fused_core_matches_the_jax_pallas_core_with_lanes_freezing(mask_mode, packed):
    Y, mask = _structured()
    got, want = _fused_cores(Y, None if mask_mode is None else mask, mask_mode or "parity",
                             *_np_inits(3, 128, 128, 3), packed=packed, tol=1e-4, max_iter=120)
    n_iter, done = _assert_restarts_match(got, want, TOL_PALLAS)
    assert done.all() and len(set(n_iter.tolist())) > 1


def test_fused_core_out_of_sweeps_fills_every_live_lane():
    Y, mask = _structured()
    got, want = _fused_cores(Y, mask, "parity", *_np_inits(3, 128, 128, 3, seed=8), packed=True,
                             tol=1e-9, max_iter=6, projection="duchi")
    n_iter, done = _assert_restarts_match(got, want, TOL_PALLAS)
    assert (n_iter == 6).all() and not done.any()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_frozen_fused_lane_equals_its_standalone_solve(packed):
    Y, mask = _structured()
    bm, Mp, Np = cs.plan_packing(*Y.shape)
    stage = (lambda A: torch.tensor(cs.pack_bits_host(A, bm))) if packed else torch.tensor
    Y1, Y2 = stage(Y * mask), stage((1.0 - Y) * mask)
    W0, H0 = restart_inits_from_reference(*_np_inits(4, 128, 128, 3), dtype="float64",
                                          device="cpu")
    core = partial(pd._solve_core_fused, packed=packed, eps=EPS, m_real=128, n_real=128, bm=bm,
                   max_iter=120, projection="normalize", verbose=0)
    hypers = (1.2, 1.2, 1e-4, float(np.count_nonzero(mask)))
    W, H, losses, n_iter, final_loss, done = core(Y1, None, Y2, W0, H0, *hypers)
    assert n_iter.min() < n_iter.max() < 120 and bool(done.all())
    for r in range(4):
        Wr, Hr, lr, it, fr, dr = core(Y1, None, Y2, W0[r], H0[r], *hypers)
        assert it == int(n_iter[r]) and dr is True
        _close(W[r], Wr, TOL_LANE)
        _close(H[r], Hr, TOL_LANE)
        _close(losses[r], lr, TOL_LANE)
        _close(final_loss[r], fr, TOL_LANE)


def test_vmapped_solve_picks_the_first_lowest_and_counts_nan_as_lowest():
    """``argmin`` as ``jnp.argmin`` has it: the first of equals, and a NaN
    lane before any number."""
    def core(finals):
        R = finals.shape[0]
        return (torch.zeros(R, 1, 1), torch.zeros(R, 1, 1), torch.zeros(R, 2),
                torch.zeros(R, dtype=torch.int64), finals, torch.zeros(R, dtype=torch.bool))

    for finals in ([3.0, 1.0, 1.0, 2.0], [3.0, float("nan"), 1.0, float("nan")]):
        _, best, all_final, results = vmapped_solve(core, (), (torch.tensor(finals),), ())
        assert best == 1 == int(jnp.argmin(jnp.asarray(finals))) and results is None
        assert all_final.shape == (4,)


# -------------------------------------- solve and NBMF against the JAX solve
@pytest.fixture
def same_inits(monkeypatch):
    """Both packages draw the restarts' inits from one numpy generator."""
    def draws(n_init, m, n, k):
        return _np_inits(n_init, m, n, k, seed=21)

    monkeypatch.setattr(jd, "_random_uniform_inits", lambda key, n_init, m, n, k, dtype: tuple(
        jnp.asarray(a, dtype=dtype) for a in draws(n_init, m, n, k)))
    monkeypatch.setattr(pd, "_random_uniform_inits", lambda seed, n_init, m, n, k, dtype: tuple(
        torch.tensor(a, dtype=dtype) for a in draws(n_init, m, n, k)))


RESTART_CASES = [
    ("beta-dir", None, "plain"), ("beta-dir", "parity", "plain"), ("dir-beta", "corrected", "plain"),
    ("beta-dir", "parity", "fused"), ("dir-beta", None, "fused"), ("dir-beta", "parity", "fused"),
]


@pytest.mark.usefixtures("same_inits")
@pytest.mark.parametrize("orientation, mask_mode, backend", RESTART_CASES)
def test_solve_n_init_matches_the_jax_solve(orientation, mask_mode, backend):
    Y, mask = _structured(48, 36)
    kw = dict(n_components=3, max_iter=150, tol=1e-4, n_init=4, return_all=True,
              orientation=orientation, mask=None if mask_mode is None else mask,
              mask_mode=mask_mode or "parity", random_state=0, dtype="float64")
    ref = jref.solve(Y, backend="jnp", **kw)
    res = port.solve(Y, backend=backend, device="cpu", **kw)
    assert res.best_restart == ref.best_restart and res.n_iter == ref.n_iter
    assert res.converged == ref.converged and len(res.losses) == res.n_iter
    _close(res.all_final_losses, ref.all_final_losses, TOL_PLAIN)
    _close(res.losses, ref.losses, TOL_PLAIN)
    _close(res.W, ref.W, 1e-9)
    _close(res.H, ref.H, 1e-9)
    ex, jex = res.extras, ref.extras
    np.testing.assert_array_equal(ex["all_n_iter"], jex["all_n_iter"])
    np.testing.assert_array_equal(ex["all_converged"], jex["all_converged"])
    assert len(set(ex["all_n_iter"].tolist())) > 1  # the freeze was exercised
    _close(ex["all_W"], jex["all_W"], 1e-9)
    _close(ex["all_H"], jex["all_H"], 1e-9)
    for r, it in enumerate(ex["all_n_iter"]):
        _close(ex["all_losses"][r, :it], jex["all_losses"][r, :it], TOL_PLAIN)
    assert all(isinstance(ex[name], np.ndarray) for name in
               ("all_W", "all_H", "all_n_iter", "all_losses", "all_converged"))
    assert res.extras["backend"] == backend


@pytest.mark.usefixtures("same_inits")
def test_solve_n_init_matches_the_jax_pallas_solve():
    """The fused loop over packed words against ``backend="pallas"`` in
    interpret mode, at a shape both planners take (256 x 200)."""
    rng = np.random.default_rng(3)
    Y = (rng.random((256, 200)) < 0.3).astype(np.float64)
    kw = dict(n_components=3, max_iter=8, tol=0.0, n_init=3, random_state=0, dtype="float32")
    ref = jref.solve(Y, backend="pallas", pallas_interpret=True, precision="highest", **kw)
    res = port.solve(Y, backend="fused", device="cpu", **kw)
    assert res.extras["packed"] is True and res.best_restart == ref.best_restart
    assert res.n_iter == ref.n_iter == 8
    np.testing.assert_allclose(res.all_final_losses, ref.all_final_losses, rtol=1e-5)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-5)
    np.testing.assert_allclose(res.W, ref.W, atol=1e-4)


@pytest.mark.usefixtures("same_inits")
def test_estimator_n_init_matches_the_jax_estimator():
    Y, mask = _structured(48, 36)
    kw = dict(n_components=3, max_iter=150, tol=1e-4, n_init=4, random_state=0, dtype="float64")
    ref = jref.NBMF(backend="jnp", **kw).fit(Y, mask=mask)
    est = port.NBMF(backend="plain", device="cpu", **kw).fit(Y, mask=mask)
    assert est.n_iter_ == ref.n_iter_
    assert est.solver_result_.best_restart == ref.solver_result_.best_restart
    _close(est.solver_result_.all_final_losses, ref.solver_result_.all_final_losses, TOL_PLAIN)
    _close(est.W_, ref.W_, 1e-9)
    _close(est.components_, ref.components_, 1e-9)
    _close(est.loss_curve_, ref.loss_curve_, TOL_PLAIN)


@pytest.mark.parametrize("n_init", [1, 3])
def test_max_iter_zero_returns_the_first_restarts_inits_as_jax_does(n_init, same_inits):
    Y = _toy()
    kw = dict(n_components=3, max_iter=0, n_init=n_init, random_state=0, dtype="float64")
    ref = jref.solve(Y, backend="jnp", **kw)
    res = port.solve(Y, device="cpu", **kw)
    assert res.n_iter == ref.n_iter == 0 and res.losses == ref.losses == []
    assert res.best_restart == ref.best_restart == 0
    assert res.all_final_losses is None and ref.all_final_losses is None
    _close(res.W, ref.W, 1e-15)
    _close(res.H, ref.H, 1e-15)


def test_random_uniform_inits_are_the_single_fit_draws():
    W1, H1 = pd._random_uniform_inits(7, 1, 6, 5, 2, torch.float32)
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(W1[0], torch.rand((6, 2), generator=gen, dtype=torch.float32) * 0.8 + 0.1)
    assert torch.equal(H1[0], torch.rand((2, 5), generator=gen, dtype=torch.float32) * 0.8 + 0.1)
    W3, H3 = pd._random_uniform_inits(7, 3, 6, 5, 2, torch.float64)
    assert W3.shape == (3, 6, 2) and H3.shape == (3, 2, 5) and W3.dtype == torch.float64
    assert 0.1 <= float(W3.min()) and float(W3.max()) <= 0.9


def test_restart_lane_equals_the_standalone_solve_from_its_inits():
    """Restart ``r`` of ``solve(n_init=R)`` is the solve from
    ``_random_uniform_inits(seed, R, ...)[r]``: bitwise on the plain route."""
    Y = _toy(seed=3)
    kw = dict(max_iter=60, tol=1e-4, dtype="float64", device="cpu", backend="plain")
    res = port.solve(Y, 3, n_init=4, random_state=9, return_all=True, **kw)
    W0, H0 = pd._random_uniform_inits(9, 4, 40, 30, 3, torch.float64)
    for r in range(4):
        one = port.solve(Y, 3, W_init=W0[r].numpy(), H_init=H0[r].numpy(), **kw)
        assert one.n_iter == res.extras["all_n_iter"][r]
        np.testing.assert_array_equal(one.H, res.extras["all_H"][r])
        assert one.losses[-1] == res.all_final_losses[r]
    np.testing.assert_array_equal(res.extras["all_H"][res.best_restart], res.H)


# ------------------------- twins of the JAX package's tests/test_restarts.py
CPU = dict(device="cpu", dtype="float64")


def test_n_init_picks_best_restart():
    res = port.solve(_toy(), 4, max_iter=80, random_state=0, n_init=8, **CPU)
    assert res.all_final_losses is not None and res.all_final_losses.shape == (8,)
    assert np.isclose(res.losses[-1], res.all_final_losses.min())
    assert res.best_restart == int(np.argmin(res.all_final_losses))


def test_n_init_never_worse_than_single():
    X = _toy(seed=3)
    single = port.solve(X, 4, max_iter=120, random_state=0, n_init=1, **CPU)
    multi = port.solve(X, 4, max_iter=120, random_state=0, n_init=6, **CPU)
    assert multi.losses[-1] <= single.losses[-1] + 1e-9


def test_n_init_estimator_and_reproducible():
    X = _toy(seed=1)
    kw = dict(n_components=4, max_iter=60, random_state=5, n_init=4, **CPU)
    m1, m2 = port.NBMF(**kw).fit(X), port.NBMF(**kw).fit(X)
    np.testing.assert_array_equal(m1.W_, m2.W_)
    assert len(m1.loss_curve_) == m1.n_iter_
    assert np.all(np.diff(np.asarray(m1.loss_curve_)) <= 1e-12)
    np.testing.assert_allclose(m1.W_.sum(axis=1), 1.0, atol=1e-9)


def test_n_init_with_custom_init_rejected():
    with pytest.raises(ValueError, match="n_init"):
        port.solve(_toy(), 3, n_init=4, W_init=np.full((40, 3), 0.5), **CPU)


def test_n_init_with_mask_monotone():
    X = _toy(seed=2)
    mask = (np.random.default_rng(4).random(X.shape) < 0.9).astype(float)
    res = port.solve(X, 3, max_iter=60, random_state=0, n_init=4, mask=mask, **CPU)
    assert np.all(np.diff(res.losses) <= 1e-12)


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_return_all_restarts(backend):
    X = _toy()
    res = port.solve(X, 3, max_iter=60, random_state=0, n_init=4, return_all=True,
                     backend=backend, **CPU)
    ex = res.extras
    assert ex["all_W"].shape == (4, 40, 3) and ex["all_H"].shape == (4, 3, 30)
    assert ex["all_n_iter"].shape == (4,) and ex["all_losses"].shape == (4, 60)
    assert ex["all_converged"].shape == (4,) and ex["all_converged"].dtype == bool
    np.testing.assert_allclose(ex["all_W"][res.best_restart], res.W, atol=1e-9)
    for i in range(4):
        np.testing.assert_allclose(ex["all_W"][i].sum(axis=1), 1.0, atol=1e-8)
    with pytest.raises(ValueError, match="return_all"):
        port.solve(X, 3, n_init=1, return_all=True, **CPU)


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_return_all_dir_beta_orientation(backend):
    X = _toy(seed=7)
    res = port.solve(X, 3, max_iter=40, random_state=1, n_init=3, return_all=True,
                     orientation="dir-beta", backend=backend, **CPU)
    ex = res.extras
    assert ex["all_W"].shape == (3, 40, 3) and ex["all_H"].shape == (3, 3, 30)
    for i in range(3):
        np.testing.assert_allclose(ex["all_H"][i].sum(axis=0), 1.0, atol=1e-8)


def test_return_all_stays_host_numpy_under_device_results():
    res = port.solve(_toy(), 3, max_iter=10, random_state=0, n_init=3, return_all=True,
                     device_results=True, **CPU)
    assert all(isinstance(t, torch.Tensor) for t in (res.W, res.H, res.losses))
    assert isinstance(res.extras["all_W"], np.ndarray)
    assert isinstance(res.all_final_losses, np.ndarray) and res.all_final_losses.shape == (3,)
    np.testing.assert_array_equal(res.extras["all_W"][res.best_restart], res.W.numpy())


def test_restarts_print_no_sweep_losses(capsys):
    port.solve(_toy(), 3, max_iter=12, random_state=0, n_init=2, verbose=1, tol=0.0, **CPU)
    assert "Iter" not in capsys.readouterr().out
    port.solve(_toy(), 3, max_iter=12, random_state=0, n_init=1, verbose=1, tol=0.0, **CPU)
    assert "Iter 0: Loss" in capsys.readouterr().out


# ---------------------------- restarts over packed, sparse and dense input
@pytest.mark.parametrize("m, n", [(256, 200), (300, 70)], ids=["256x200", "m300-jax-rejects"])
@pytest.mark.parametrize("mask_mode", [None, "parity", "corrected"])
def test_restarts_on_packed_and_sparse_input_equal_dense_input_bitwise(m, n, mask_mode):
    rng = np.random.default_rng(m)
    Y = (rng.random((m, n)) < 0.3).astype(np.float32)
    mask = (rng.random((m, n)) < 0.8).astype(np.float32)
    kw = dict(n_components=4, max_iter=6, tol=0.0, n_init=3, random_state=2, return_all=True,
              backend="fused", dtype="float32", device="cpu", mask_mode=mask_mode or "parity")
    if mask_mode is None:
        dense = port.solve(Y, **kw)
        others = {"csr": port.solve(sp.csr_matrix(Y), **kw),
                  "packed": port.solve(port.pack_matrix(Y, 4, device="cpu"), **kw),
                  "packed=False": port.solve(Y, packed=False, **kw)}
    else:
        dense = port.solve(Y, mask=mask, **kw)
        others = {"csr under csr": port.solve(sp.csr_matrix(Y), mask=sp.csr_matrix(mask), **kw),
                  "packed=False": port.solve(Y, mask=mask, packed=False, **kw)}
    assert dense.extras["packed"] is True and dense.all_final_losses.shape == (3,)
    for name, res in others.items():
        assert res.extras["packed"] is (name != "packed=False"), name
        assert res.best_restart == dense.best_restart and res.losses == dense.losses, name
        np.testing.assert_array_equal(res.W, dense.W, err_msg=name)
        np.testing.assert_array_equal(res.all_final_losses, dense.all_final_losses, err_msg=name)
        for key in ("all_W", "all_H", "all_losses", "all_n_iter"):
            np.testing.assert_array_equal(res.extras[key], dense.extras[key], err_msg=name)


# ----------------------------------- the quickstart's restart lines, ported
def test_quickstart_restart_lines():
    """``examples/quickstart.py``: a fit with ``n_init=8`` that reads
    ``solver_result_.best_restart``."""
    from nbmf_mm_tpu_torch.utils.synth import generate_synthetic_binary_data

    X, _, _ = generate_synthetic_binary_data(60, 40, 4, random_state=0)
    single = port.NBMF(n_components=4, max_iter=60, random_state=0, device="cpu").fit(X)
    multi = port.NBMF(n_components=4, max_iter=60, random_state=0, n_init=8,
                      device="cpu").fit(X)
    best = multi.solver_result_.best_restart
    assert 0 <= best < 8 and multi.solver_result_.all_final_losses.shape == (8,)
    assert multi.loss_ == multi.solver_result_.all_final_losses.min()
    assert multi.loss_ <= single.loss_ + 1e-6
