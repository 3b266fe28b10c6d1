"""The port's solver loops against the JAX package's ``solve`` in float64 on
the CPU, with explicit inits (torch generators cannot reproduce JAX
``PRNGKey`` draws).

Both port loops are checked: ``backend="fused"`` (the shifted-loss loop over
packed words; CPU tensors take the kernels' plain versions) and
``backend="plain"`` (dense ``mm_sweep``).  Bar: identical ``n_iter`` and
``converged``, losses within 1e-10 relative, W and H within 1e-9.
"""

import functools

import numpy as np
import pytest
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port

torch.set_num_threads(1)

M, N, K = 48, 36, 3
BACKENDS = ["fused", "plain"]


@functools.lru_cache(maxsize=None)
def _data(seed=11, m=M, n=N, k=K):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, k, size=m)
    protos = rng.random((k, n)) < np.array([0.7, 0.2, 0.5][:k] + [0.4] * max(0, k - 3))[:, None]
    P = np.clip(protos[z] * rng.uniform(0.6, 0.95, (m, 1)), 0.03, 0.97)
    Y = (rng.random((m, n)) < P).astype(np.float64)
    mask = (rng.random((m, n)) < 0.8).astype(np.float64)
    return Y, mask


def _inits(orientation, seed=5, m=M, n=N, k=K):
    rng = np.random.default_rng(seed)
    W0 = rng.uniform(0.1, 0.9, (m, k))
    H0 = rng.uniform(0.1, 0.9, (k, n))
    return W0, H0


# (orientation, mask_mode or None, max_iter, projection); max_iter=300 runs
# converge, max_iter=6 runs exhaust the budget.
CASES = [
    ("beta-dir", None, 300, "normalize"),
    ("beta-dir", "parity", 300, "normalize"),
    ("beta-dir", "corrected", 300, "normalize"),
    ("dir-beta", None, 300, "normalize"),
    ("dir-beta", "parity", 300, "normalize"),
    ("dir-beta", "corrected", 300, "normalize"),
    ("beta-dir", None, 6, "normalize"),
    ("dir-beta", "corrected", 6, "normalize"),
    ("beta-dir", "parity", 300, "duchi"),
]


def _kwargs(case):
    orientation, mask_mode, max_iter, projection = case
    Y, mask = _data()
    W0, H0 = _inits(orientation)
    return Y, dict(
        n_components=K, max_iter=max_iter, tol=1e-5, W_init=W0, H_init=H0,
        mask=None if mask_mode is None else mask, orientation=orientation,
        mask_mode=mask_mode or "parity", projection=projection, dtype="float64",
    )


@functools.lru_cache(maxsize=None)
def _reference(case):
    Y, kw = _kwargs(case)
    return jref.solve(Y, backend="jnp", **kw)


def _assert_matches(res, ref):
    assert res.n_iter == ref.n_iter
    assert res.converged == ref.converged
    assert len(res.losses) == res.n_iter
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-10, atol=0)
    np.testing.assert_allclose(res.W, ref.W, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.H, ref.H, rtol=0, atol=1e-9)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_solve_matches_jax(case, backend):
    Y, kw = _kwargs(case)
    res = port.solve(Y, backend=backend, device="cpu", **kw)
    assert res.extras["backend"] == backend
    ref = _reference(case)
    if case[2] == 300:
        assert ref.converged and ref.n_iter < 300
    else:
        assert not ref.converged and ref.n_iter == case[2]
    _assert_matches(res, ref)


def test_fused_matches_jax_pallas_packed():
    """Against the JAX bit-packed Pallas loop (interpret mode) at a shape the
    reference accepts, where it has no pad entries."""
    m, n, k = 512, 384, 4
    Y, _ = _data(seed=2, m=m, n=n, k=k)
    W0, H0 = _inits("beta-dir", m=m, n=n, k=k)
    kw = dict(n_components=k, max_iter=8, tol=1e-5, W_init=W0, H_init=H0, dtype="float64")
    ref = jref.solve(Y, backend="pallas", pallas_interpret=True, packed=True, **kw)
    res = port.solve(Y, backend="fused", device="cpu", **kw)
    _assert_matches(res, ref)


def test_auto_on_cpu_takes_the_plain_loop():
    Y, kw = _kwargs(CASES[0])
    res = port.solve(Y, device="cpu", **kw)
    assert res.extras["backend"] == "plain"
    _assert_matches(res, _reference(CASES[0]))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("orientation", ["beta-dir", "dir-beta"])
def test_max_iter_zero_returns_inits(backend, orientation):
    Y, _ = _data()
    W0, H0 = _inits(orientation)
    kw = dict(n_components=K, max_iter=0, W_init=W0, H_init=H0, orientation=orientation,
              dtype="float64")
    res = port.solve(Y, backend=backend, device="cpu", **kw)
    ref = jref.solve(Y, backend="jnp", **kw)
    assert res.n_iter == 0 and res.losses == [] and not res.converged
    np.testing.assert_allclose(res.W, ref.W, rtol=0, atol=1e-15)
    np.testing.assert_allclose(res.H, ref.H, rtol=0, atol=1e-15)


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_mask_raises(backend):
    Y, _ = _data()
    with pytest.raises(ValueError, match="no observed entries"):
        port.solve(Y, K, mask=np.zeros_like(Y), backend=backend, device="cpu")


def test_dir_beta_lone_init_raises():
    Y, _ = _data()
    W0, _ = _inits("dir-beta")
    with pytest.raises(ValueError, match="BOTH"):
        port.solve(Y, K, W_init=W0, orientation="dir-beta", device="cpu")


def test_argument_validation():
    Y, _ = _data()
    for kw in (dict(orientation="x"), dict(projection="x"), dict(mask_mode="x"),
               dict(n_init=0), dict(dtype="int32"), dict(W_init=np.ones((2, 2)))):
        with pytest.raises(ValueError):
            port.solve(Y, K, device="cpu", **kw)


def test_seeded_inits_are_reproducible_and_zero_columns_stay_zero():
    Y, _ = _data()
    a = port.solve(Y, K, max_iter=4, random_state=3, device="cpu", dtype="float64")
    b = port.solve(Y, K, max_iter=4, random_state=3, device="cpu", dtype="float64")
    np.testing.assert_array_equal(a.W, b.W)
    assert a.losses == b.losses and a.seed == 3
    W0 = a.W.copy()
    W0[0] = 0.0  # a fully-unobserved sample's simplex vector
    res = port.solve(Y, K, max_iter=3, W_init=W0, H_init=a.H, device="cpu", dtype="float64",
                     backend="plain")
    assert np.isfinite(res.W).all() and np.isfinite(res.losses).all()


def test_nbmf_mm_solver_tuple():
    Y, kw = _kwargs(CASES[6])
    W, H, losses, t, n_iter = port.nbmf_mm_solver(Y, device="cpu", **kw)
    ref = _reference(CASES[6])
    assert n_iter == ref.n_iter and t >= 0.0
    np.testing.assert_allclose(losses, ref.losses, rtol=1e-10, atol=0)
    np.testing.assert_allclose(W, ref.W, rtol=0, atol=1e-9)
