"""The port's estimator against ``nbmf_mm_tpu``'s, float64 on the CPU, and the
state carried across with ``from_reference``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.models.estimator import _transform_core as j_transform_core
from nbmf_mm_tpu_torch.models.estimator import _ORIENTATION_ALIASES
from nbmf_mm_tpu_torch.models.estimator import _transform_core as t_transform_core
from nbmf_mm_tpu_torch.utils.interop import from_reference

torch.set_num_threads(1)

M, N, K = 40, 24, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    z = rng.integers(0, K, size=M)
    protos = rng.random((K, N)) < np.array([[0.7], [0.2], [0.5]])
    P = np.clip(protos[z] * rng.uniform(0.6, 0.95, size=(M, 1)), 0.02, 0.98)
    X = (rng.random((M, N)) < P).astype(float)
    W0 = rng.uniform(0.1, 0.9, (M, K))
    H0 = rng.uniform(0.1, 0.9, (K, N))
    X_new = (rng.random((9, N)) < 0.4).astype(float)
    W0t = rng.uniform(0.1, 0.9, (K, 9))
    return X, W0, H0, X_new, W0t


def _params(W0, H0, **extra):
    return dict(n_components=K, max_iter=200, tol=1e-6, W_init=W0, H_init=H0,
                random_state=0, dtype="float64", **extra)


@pytest.fixture(scope="module")
def fitted(data):
    X, W0, H0, _, _ = data
    ref = jref.NBMF(backend="jnp", **_params(W0, H0)).fit(X)
    return ref


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_fit_matches_reference(data, fitted, backend):
    X, W0, H0, _, _ = data
    est = port.NBMF(backend=backend, device="cpu", **_params(W0, H0)).fit(X)
    assert est.n_iter_ == fitted.n_iter_ and est.converged_ == fitted.converged_
    np.testing.assert_allclose(est.loss_curve_, fitted.loss_curve_, rtol=1e-10, atol=0)
    np.testing.assert_allclose(est.W_, fitted.W_, rtol=0, atol=1e-9)
    np.testing.assert_allclose(est.components_, fitted.components_, rtol=0, atol=1e-9)
    assert est.loss_ == est.loss_curve_[-1] == est.reconstruction_err_
    assert est.objective_history_ is est.loss_curve_


def test_fit_transform_is_fit_W(data):
    X, W0, H0, _, _ = data
    a = port.NBMF(device="cpu", **_params(W0, H0)).fit_transform(X)
    b = port.NBMF(device="cpu", **_params(W0, H0)).fit(X).W_
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_transform_core_matches_reference(data, fitted, masked):
    _, _, _, X_new, W0t = data
    mask = (np.random.default_rng(1).random(X_new.shape) < 0.7).astype(float)
    Ym = X_new * mask if masked else X_new
    Ym2 = (1 - X_new) * mask if masked else 1 - X_new
    H = fitted.components_
    ref = j_transform_core(jnp.asarray(H), jnp.asarray(Ym), jnp.asarray(Ym2), jnp.asarray(W0t),
                           jnp.asarray(1e-8), n_iter=50, precision=None)
    got = t_transform_core(torch.tensor(H), torch.tensor(Ym), torch.tensor(Ym2),
                           torch.tensor(W0t), 1e-8, n_iter=50)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_inverse_transform_and_score_through_fold_in(data, fitted, monkeypatch):
    _, _, _, X_new, W0t = data
    est = from_reference(fitted, device="cpu")
    W_test = np.random.default_rng(2).dirichlet(np.ones(K), size=5)
    np.testing.assert_allclose(est.inverse_transform(W_test), fitted.inverse_transform(W_test),
                               rtol=0, atol=1e-15)

    # score refits W with the seeded fold-in; pin its start to W0t on both.
    monkeypatch.setattr(port.NBMF, "_fold_in_init",
                        lambda self, m, dtype: torch.tensor(W0t, dtype=dtype))
    W_ref = np.asarray(j_transform_core(
        jnp.asarray(fitted.components_), jnp.asarray(X_new), jnp.asarray(1 - X_new),
        jnp.asarray(W0t), jnp.asarray(1e-8), n_iter=50, precision=None))
    np.testing.assert_allclose(est.transform(X_new), W_ref, rtol=0, atol=1e-12)
    R = fitted.inverse_transform(W_ref)
    ref_score = np.mean(X_new * np.log(R + 1e-8) + (1 - X_new) * np.log(1 - R + 1e-8))
    assert est.score(X_new) == pytest.approx(ref_score, rel=1e-12)
    assert est.perplexity(X_new) == pytest.approx(np.exp(-ref_score), rel=1e-12)
    mask = np.ones_like(X_new)
    mask[0, :3] = 0
    assert np.isfinite(est.score(X_new, mask=mask))


def test_transform_is_seeded_and_on_the_simplex(data, fitted):
    _, _, _, X_new, _ = data
    est = from_reference(fitted, device="cpu")
    a, b = est.transform(X_new), est.transform(X_new)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a.sum(axis=1), 1.0, atol=1e-12)


def test_binary_contract(data):
    X = data[0].copy()
    X[0, 0] = 1.5
    with pytest.raises(ValueError, match="X must be binary"):
        port.NBMF(device="cpu").fit(X)


@pytest.mark.parametrize("alias, canonical", sorted(_ORIENTATION_ALIASES.items()))
def test_orientation_aliases(data, alias, canonical):
    X = data[0]
    est = port.NBMF(n_components=2, max_iter=3, orientation=alias, random_state=0,
                    device="cpu").fit(X)
    assert est.orientation == canonical
    assert est.W_.shape == (M, 2) and est.components_.shape == (2, N)


def test_unknown_orientation_raises(data):
    with pytest.raises(ValueError, match="Unknown orientation"):
        port.NBMF(orientation="sideways", device="cpu").fit(data[0])


def test_transform_before_fit_raises(data):
    est = port.NBMF(device="cpu")
    for call in (est.transform, est.score, est.perplexity, est.inverse_transform):
        with pytest.raises(ValueError, match="not fitted"):
            call(data[0])


def test_from_reference_estimator_round_trip(fitted):
    est = from_reference(fitted, device="cpu")
    for name in ("W_", "components_"):
        np.testing.assert_array_equal(getattr(est, name), getattr(fitted, name))
    assert est.loss_curve_ == list(fitted.loss_curve_)
    assert est.n_iter_ == fitted.n_iter_ and est.converged_ == fitted.converged_
    for name in ("n_components", "alpha", "beta", "tol", "orientation", "random_state"):
        assert getattr(est, name) == getattr(fitted, name)
    assert est.dtype == "float64" and est.device == "cpu"


def test_from_reference_solver_result_and_warm_start(data):
    X, W0, H0, _, _ = data
    kw = dict(n_components=K, max_iter=30, W_init=W0, H_init=H0, dtype="float64")
    res = jref.solve(X, backend="jnp", **kw)
    est = from_reference(res, device="cpu")
    np.testing.assert_array_equal(est.W_, res.W)
    assert est.n_iter_ == res.n_iter and est.n_components == K
    # A warm start from the carried state computes the same in both packages.
    warm = dict(n_components=K, max_iter=20, tol=1e-9, W_init=est.W_, H_init=est.components_,
                dtype="float64")
    a = port.solve(X, device="cpu", backend="fused", **warm)
    b = jref.solve(X, backend="jnp", **warm)
    assert a.n_iter == b.n_iter
    np.testing.assert_allclose(a.losses, b.losses, rtol=1e-10, atol=0)
    np.testing.assert_allclose(a.W, b.W, rtol=0, atol=1e-9)


def test_from_reference_dict():
    H = np.full((2, 5), 0.5)
    est = from_reference({"W": np.full((4, 2), 0.5), "H": H, "losses": [1.0, 0.9],
                          "n_iter": 2}, device="cpu", orientation="dir-beta")
    assert est.orientation == "dir-beta" and est.loss_ == 0.9
    with pytest.raises(ValueError):
        from_reference({}, device="cpu")
