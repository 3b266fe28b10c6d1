"""Every check of ``tests/test_api_contract.py`` and ``tests/test_public_api.py``
run on the PyTorch port, on the CPU, plus the import surface of its compat
shim ``nbmf_mm_compat_torch``.

The JAX suite runs with x64 on (the root ``conftest.py``), so its ``dtype=None``
is float64; the port's ``None`` is float32.  The estimator here therefore
defaults to ``dtype="float64"`` (and ``device="cpu"``), so that every bar
stays the JAX check's own.
"""

import warnings

import numpy as np
import pytest
import torch

import nbmf_mm_compat
import nbmf_mm_compat._utils
import nbmf_mm_compat_torch
import nbmf_mm_compat_torch._utils
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu_torch.utils import validation

torch.set_num_threads(1)


def NBMF(**kw):
    """The port's estimator in the JAX suite's regime: float64 on the CPU."""
    kw.setdefault("device", "cpu")
    kw.setdefault("dtype", "float64")
    return port.NBMF(**kw)


NBMFMM = NBMF


def solve(*args, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("dtype", "float64")
    return port.solve(*args, **kw)


def _toy(m=60, n=80, p=0.25, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def _rand01(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


# ------------------------------------------------ tests/test_api_contract.py
def test_attribute_contract():
    X = _toy()
    model = NBMF(n_components=8, max_iter=100, tol=1e-6, random_state=0).fit(X)
    assert model.W_.shape == (60, 8)
    assert model.components_.shape == (8, 80)
    assert isinstance(model.loss_curve_, list)
    assert model.objective_history_ is model.loss_curve_
    assert len(model.objective_history_) == model.n_iter_
    assert np.isfinite(model.objective_history_[-1])
    assert model.reconstruction_err_ == model.loss_curve_[-1]
    assert model.loss_ == model.loss_curve_[-1]


def test_orientation_aliases_roundtrip():
    X = _toy(20, 10, 0.3)
    for alias, canon in [
        ("Dir-Beta", "dir-beta"),
        ("Aspect Bernoulli", "dir-beta"),
        ("Dir Beta", "dir-beta"),
        ("Beta-Dir", "beta-dir"),
        ("Binary ICA", "beta-dir"),
        ("bICA", "beta-dir"),
    ]:
        m = NBMF(n_components=3, orientation=alias, max_iter=5, random_state=0).fit(X)
        assert m.orientation == canon
    with pytest.raises(ValueError):
        NBMF(n_components=3, orientation="Dir-Dir").fit(X)


def test_binary_validation():
    X = np.random.default_rng(0).random((20, 10)) + 1.5
    with pytest.raises(ValueError, match="must be binary"):
        NBMF(n_components=3).fit(X)
    with pytest.raises(ValueError, match="must be binary"):
        NBMF(n_components=3).fit(-np.ones((5, 5)))


def test_custom_init_accepted():
    X = _toy(30, 20, 0.3)
    rng = np.random.default_rng(1)
    W0 = rng.uniform(0.1, 0.9, (30, 4))
    H0 = rng.uniform(0.1, 0.9, (4, 20))
    m = NBMF(n_components=4, W_init=W0, H_init=H0, max_iter=60, random_state=0).fit(X)
    assert m.W_.shape == (30, 4)
    assert np.isfinite(m.loss_)
    hist = np.asarray(m.loss_curve_)
    assert np.all(hist[1:] <= hist[:-1] + 1e-8)


def test_custom_init_wrong_shape_raises():
    X = _toy(30, 20, 0.3)
    with pytest.raises(ValueError, match="W_init"):
        NBMF(n_components=4, W_init=np.ones((3, 4)) * 0.5, max_iter=5).fit(X)


def test_convergence_speed_ordering():
    X = _toy(50, 40, 0.3, seed=3)
    loose = NBMF(n_components=4, tol=1e-2, max_iter=500, random_state=0).fit(X)
    tight = NBMF(n_components=4, tol=1e-9, max_iter=500, random_state=0).fit(X)
    assert loose.n_iter_ < 50
    assert tight.n_iter_ > loose.n_iter_


def test_not_fitted_errors():
    model = NBMF(n_components=3)
    with pytest.raises(ValueError, match="not fitted"):
        model.transform(np.zeros((4, 5)))
    with pytest.raises(ValueError, match="not fitted"):
        model.inverse_transform(np.zeros((4, 3)))
    with pytest.raises(ValueError, match="not fitted"):
        model.score(np.zeros((4, 5)))


def test_get_set_params_sklearn_compat():
    pytest.importorskip("sklearn")
    from sklearn.base import clone

    m = port.NBMF(n_components=7, alpha=1.5, orientation="dir-beta", device="cpu")
    params = m.get_params()
    assert params["n_components"] == 7 and params["alpha"] == 1.5
    m2 = clone(m)
    assert m2.get_params()["orientation"] == "dir-beta"
    assert m2.get_params()["device"] == "cpu"


def test_legacy_accel_flags_accepted():
    X = _toy(20, 10, 0.3)
    m = NBMF(n_components=3, max_iter=5, use_numexpr=True, use_numba=False,
             projection_backend="numpy").fit(X)
    assert hasattr(m, "W_")


def test_reconstruction_quality(tiny_clusters):
    X = tiny_clusters
    m = NBMF(n_components=3, max_iter=300, tol=1e-7, random_state=0).fit(X)
    Xr = m.inverse_transform(m.W_)
    err = np.mean((Xr > 0.5).astype(float) != X)
    assert err < 0.4


def test_invalid_mask_mode_rejected_every_backend():
    X = _toy(12, 9, 0.3)
    mask = np.ones_like(X)
    for backend in ("jnp", "pallas", "auto", "plain", "fused"):
        with pytest.raises(ValueError, match="mask_mode"):
            solve(X, 2, max_iter=3, mask=mask, mask_mode="correctd", backend=backend,
                  pallas_interpret=True)
    with pytest.raises(ValueError, match="mask_mode"):
        NBMF(n_components=2, max_iter=3, mask_mode="bogus").fit(X, mask=mask)


def test_estimator_backend_param():
    X = _toy(20, 15, 0.3)
    m_jnp = NBMF(n_components=3, max_iter=20, random_state=0, backend="jnp").fit(X)
    m_auto = NBMF(n_components=3, max_iter=20, random_state=0).fit(X)
    assert m_auto.backend == "auto"
    np.testing.assert_allclose(m_jnp.W_, m_auto.W_)  # auto == jnp (plain) on the CPU
    with pytest.raises(ValueError, match="backend"):
        solve(X, 2, max_iter=3, backend="cuda")


def test_estimator_pickled_before_mesh_axes():
    X = (np.random.default_rng(0).random((30, 20)) < 0.4).astype(float)
    m = NBMF(n_components=3, max_iter=30, random_state=0).fit(X)
    del m.mesh_axes  # an estimator pickled before mesh_axes existed
    m.fit(X)
    W = m.transform(X)
    assert W.shape == (30, 3)


def test_dir_beta_single_sided_init_rejected():
    X = (np.random.default_rng(1).random((20, 20)) < 0.4).astype(float)
    H = np.random.default_rng(2).uniform(0.1, 0.9, (3, 20))
    with pytest.raises(ValueError, match="BOTH"):
        NBMF(n_components=3, orientation="dir-beta", H_init=H).fit(X)


# -------------------------------------------------- tests/test_public_api.py
class TestPublicAPI:
    def test_basic_fit(self):
        model = NBMF(n_components=10, max_iter=60).fit(_rand01((100, 50)))
        assert model.W_.shape == (100, 10)
        assert model.components_.shape == (10, 50)

    def test_transform(self):
        model = NBMF(n_components=10, max_iter=60).fit(_rand01((100, 50)))
        W_test = model.transform(_rand01((20, 50), seed=1))
        assert W_test.shape == (20, 10)
        np.testing.assert_allclose(W_test.sum(axis=1), 1.0, rtol=1e-6)

    def test_fit_transform_equals_fit_W(self):
        X = _rand01((80, 40))
        model = NBMF(n_components=6, max_iter=60, random_state=0)
        W = model.fit_transform(X)
        assert W.shape == (80, 6)
        np.testing.assert_allclose(W, model.W_)

    def test_inverse_transform_bounds(self):
        X = _rand01((60, 30))
        model = NBMF(n_components=5, max_iter=60).fit(X)
        Xr = model.inverse_transform(model.W_)
        assert Xr.shape == X.shape
        assert np.all((Xr >= 0) & (Xr <= 1))

    def test_score_and_perplexity(self):
        X = _rand01((60, 30))
        model = NBMF(n_components=5, max_iter=60, random_state=0).fit(X)
        s = model.score(X)
        p = model.perplexity(X)
        assert isinstance(s, float) and np.isfinite(s)
        assert isinstance(p, float) and p >= 1.0

    def test_nbmfmm_alias(self):
        assert port.NBMFMM is port.NBMF
        model = NBMFMM(n_components=4, max_iter=30).fit(_rand01((40, 20)))
        assert hasattr(model, "W_") and hasattr(model, "components_")

    def test_orientations_constraints(self):
        X = _rand01((100, 50))
        m1 = NBMF(n_components=10, orientation="beta-dir", max_iter=80, random_state=0).fit(X)
        H1, W1 = m1.components_, m1.W_
        assert np.all((H1 >= 0) & (H1 <= 1))
        assert len(np.unique(H1)) > 10
        np.testing.assert_allclose(W1.sum(axis=1), 1.0, rtol=1e-5)
        m2 = NBMF(n_components=10, orientation="dir-beta", max_iter=80, random_state=0).fit(X)
        H2, W2 = m2.components_, m2.W_
        np.testing.assert_allclose(H2.sum(axis=0), 1.0, rtol=1e-5)
        assert np.all((W2 >= 0) & (W2 <= 1))
        assert len(np.unique(W2)) > 10

    def test_simplex_tight(self, tiny_clusters):
        m = NBMF(n_components=3, max_iter=50, random_state=0).fit(tiny_clusters)
        np.testing.assert_allclose(m.W_.sum(axis=1), 1.0, atol=1e-10)

    def test_sparse_input(self):
        sparse = pytest.importorskip("scipy.sparse")
        model = NBMF(n_components=5, max_iter=40).fit(sparse.csr_matrix(_rand01((60, 30))))
        assert model.W_.shape == (60, 5)

    def test_sparse_mask(self):
        sparse = pytest.importorskip("scipy.sparse")
        X = _rand01((60, 30))
        mask = (_rand01((60, 30), seed=3) < 0.8).astype(float)
        model = NBMF(n_components=5, max_iter=40, random_state=0).fit(
            sparse.csr_matrix(X), mask=sparse.csr_matrix(mask))
        assert model.W_.shape == (60, 5)

    def test_large_sparse_transform_warns(self, monkeypatch):
        sparse = pytest.importorskip("scipy.sparse")
        model = NBMF(n_components=5, max_iter=40, random_state=0).fit(_rand01((60, 30)))
        Xs = sparse.csr_matrix((_rand01((20, 30), seed=5) < 0.3).astype(float))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            model.transform(Xs)
        monkeypatch.setattr(validation, "SPARSE_DENSIFY_WARN_ENTRIES", 100)
        with pytest.warns(UserWarning, match="FoldInServer"):
            W = model.transform(Xs)
        assert W.shape == (20, 5)
        with pytest.warns(UserWarning, match="densifies sparse input whole"):
            s = model.score(Xs)
        assert np.isfinite(s)

    def test_masked_training_and_score(self):
        X = _rand01((80, 40))
        mask = _rand01((80, 40), seed=2) > 0.1
        model = NBMF(n_components=6, max_iter=60, random_state=0).fit(X, mask=mask)
        assert np.isfinite(model.score(X, mask=mask))
        assert model.perplexity(X, mask=mask) >= 1.0

    def test_reproducibility_same_seed(self):
        X = _rand01((60, 30))
        m1 = NBMF(n_components=5, max_iter=50, random_state=42).fit(X)
        m2 = NBMF(n_components=5, max_iter=50, random_state=42).fit(X)
        np.testing.assert_allclose(m1.W_, m2.W_)
        np.testing.assert_array_equal(m1.components_, m2.components_)

    def test_different_seeds_differ(self):
        X = _rand01((60, 30))
        m1 = NBMF(n_components=5, max_iter=50, random_state=1).fit(X)
        m2 = NBMF(n_components=5, max_iter=50, random_state=2).fit(X)
        assert not np.allclose(m1.W_, m2.W_)

    def test_paper_default_orientation(self):
        model = NBMF(n_components=5, max_iter=60).fit(_rand01((50, 30)))
        H, W = model.components_, model.W_
        assert np.all((H >= 0) & (H <= 1))
        assert len(np.unique(H)) > 10
        np.testing.assert_allclose(W.sum(axis=1), 1.0, rtol=1e-5)


# ------------------------------------------------------------ the compat shim
def test_compat_shim_surface_is_the_jax_shims():
    assert nbmf_mm_compat_torch.__all__ == nbmf_mm_compat.__all__
    assert nbmf_mm_compat_torch._utils.__all__ == nbmf_mm_compat._utils.__all__


def test_compat_shim_reexports_the_port():
    assert nbmf_mm_compat_torch.NBMF is port.NBMF
    assert nbmf_mm_compat_torch.NBMFMM is port.NBMFMM
    assert nbmf_mm_compat_torch.nbmf_mm_solver is port.nbmf_mm_solver
    assert nbmf_mm_compat_torch.__version__ == port.__version__
    assert nbmf_mm_compat_torch._utils.check_is_fitted is validation.check_is_fitted


def test_compat_shim_fits_and_solves():
    from nbmf_mm_compat_torch._utils import check_is_fitted, generate_synthetic_binary_data

    out = generate_synthetic_binary_data(30, 20, 3, random_state=0)
    X = out[0] if isinstance(out, tuple) else out
    model = nbmf_mm_compat_torch.NBMF(n_components=3, max_iter=20, random_state=0,
                                      device="cpu").fit(X)
    check_is_fitted(model, ["components_"])
    W, H, losses, elapsed, n_iter = nbmf_mm_compat_torch.nbmf_mm_solver(
        X, 3, max_iter=10, random_state=0, device="cpu")
    assert W.shape == (30, 3) and H.shape == (3, 20) and len(losses) == n_iter
