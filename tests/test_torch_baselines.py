"""The paper's baselines in the PyTorch port, NBMF-EM and logPCA, against the
JAX package's on the CPU.

- The cores (``_em_core``, ``_lsvd_core``) on the same numpy inits in
  float64: the same ``n_iter`` and ``converged``, losses within 1e-12 and
  the reconstructions (``P = W Hᵀ``; ``mu + A Bᵀ``, whose factors' signs
  the SVD leaves free) within 1e-10.
- The cases of ``tests/test_baselines.py``, in float64 (the JAX suite's x64
  regime) from the JAX estimators' inits, and the paper's 10-init protocol
  on the committed animals split from the port's own: EM within 3% of the
  stored test NLL in at most 5 iterations, logPCA within 2%.
- ``precision`` and ``dtype``: the tier rounds the operands as
  ``ops/tiers.py`` says (the JAX package computes every tier in fp32 on the
  CPU, so it is held to the JAX run at 1e-2 relative, its bf16-grade
  rounding), and bf16 runs EM in bf16 and is refused by logPCA, as in the
  JAX package.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbmf_mm_tpu.models import LogisticPCA as JaxLogisticPCA
from nbmf_mm_tpu.models import NBMFEM as JaxNBMFEM
from nbmf_mm_tpu.models import baselines as jref
from nbmf_mm_tpu.solver.driver import _resolve_precision as jax_precision
from nbmf_mm_tpu_torch.models import baselines as port
from nbmf_mm_tpu_torch.ops import tiers

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
REF_DIR = os.path.join(DATA, "magron2022")
F64 = dict(dtype="float64", device="cpu")


def NBMFEM(**kw):
    return port.NBMFEM(**{**F64, **kw})


def LogisticPCA(**kw):
    return port.LogisticPCA(**{**F64, **kw})


def _toy(m=60, n=40, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def _obs_nll(Y, P, mask):
    P = np.clip(P, 1e-12, 1 - 1e-12)
    ll = Y * np.log(P) + (1 - Y) * np.log(1 - P)
    return -np.sum(mask * ll) / mask.sum()


def _masked(X, seed):
    return (np.random.default_rng(seed).random(X.shape) < 0.85).astype(float)


t64 = lambda A: torch.as_tensor(np.asarray(A, dtype=np.float64))
j64 = lambda A: jnp.asarray(np.asarray(A, dtype=np.float64))


# ---------------------------------------------------- the cores against JAX
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("tol", [1e-5, 1e-9, -1.0], ids=["tol1e-5", "tol1e-9", "no-stop"])
def test_em_core_matches_jax(masked, tol):
    X = _toy(seed=1)
    mask = _masked(X, 2) if masked else np.ones_like(X)
    Ym, Cm = X * mask, (1 - X) * mask
    rng = np.random.default_rng(3)
    W0, H0 = rng.random((60, 4)) / 4, rng.random((40, 4))
    n_obs = float(mask.sum())
    W_j, H_j, l_j, n_j, d_j = jref._em_core(
        j64(Ym), j64(Cm), j64(W0), j64(H0), j64(tol), j64(1e-8), j64(n_obs), max_iter=60,
        precision=jax_precision(None))
    W_p, H_p, l_p, n_p, d_p = port._em_core(t64(Ym), t64(Cm), t64(W0), t64(H0), tol, 1e-8,
                                            n_obs, max_iter=60)
    assert n_p == int(n_j) and d_p == bool(d_j)
    np.testing.assert_allclose(l_p[:n_p].numpy(), np.asarray(l_j)[:n_p], rtol=0, atol=1e-12)
    P_j = np.asarray(W_j) @ np.asarray(H_j).T
    np.testing.assert_allclose((W_p @ H_p.T).numpy(), P_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("tol", [1e-5, 1e-3], ids=["tol1e-5", "tol1e-3"])
def test_lsvd_core_matches_jax(masked, tol):
    X = _toy(40, 30, seed=4)
    mask = _masked(X, 5)
    k = 3
    rng = np.random.default_rng(6)
    A0, B0 = 0.1 * rng.standard_normal((40, k)), 0.1 * rng.standard_normal((30, k))
    Ym = X * mask if masked else X
    Mask = mask if masked else np.ones((1, 1))
    mu_j, A_j, B_j, l_j, n_j, d_j = jref._lsvd_core(
        j64(Ym), j64(Mask), j64(A0), j64(B0), j64(tol), k=k, max_iter=300, masked=masked)
    mu_p, A_p, B_p, l_p, n_p, d_p = port._lsvd_core(
        t64(Ym), t64(mask) if masked else None, t64(A0), t64(B0), tol, k=k, max_iter=300,
        masked=masked)
    assert n_p == int(n_j) and d_p == bool(d_j)
    np.testing.assert_allclose(l_p[:n_p].numpy(), np.asarray(l_j)[:n_p], rtol=0, atol=1e-12)
    theta_j = np.asarray(mu_j)[None] + np.asarray(A_j) @ np.asarray(B_j).T
    theta_p = (mu_p[None] + A_p @ B_p.T).numpy()
    np.testing.assert_allclose(theta_p, theta_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose((B_p.T @ B_p).numpy(), np.eye(k), rtol=0, atol=1e-12)


def test_signed_stop_fires_on_a_rise():
    losses = iter([3.0, 2.0, 2.5, 1.0])
    carry, recorded, n_iter, done = port._signed_stop_loop(
        lambda c: c + 1, lambda c: torch.tensor(next(losses), dtype=torch.float64), 0, 0.0, 10)
    assert (n_iter, done, carry) == (3, True, 3)
    assert recorded[:3].tolist() == [3.0, 2.0, 2.5] and recorded[3:].abs().sum() == 0


def test_logpca_loss_uses_the_unlinearized_softplus():
    """Logits far above torch's softplus threshold (20) keep log(1 + e^x)
    exactly as the JAX package's ``jax.nn.softplus`` does."""
    Ym = torch.ones((2, 2), dtype=torch.float64)
    A0 = torch.full((2, 1), 6.0, dtype=torch.float64)
    B0 = torch.full((2, 1), 4.0, dtype=torch.float64)  # Theta = 24 at the start
    *_, losses, n_iter, _ = port._lsvd_core(Ym, None, A0, B0, -1.0, k=1, max_iter=1,
                                            masked=False)
    # One MM step moves Theta little from 24, where softplus(x) - x = log1p(e^-x)
    # is about 4e-11 > 0; the linearized softplus would give exactly 0.
    assert n_iter == 1 and 0.0 < losses[0].item() < 1e-3


# ---------------------------------------------- tests/test_baselines.py cases
def _jax_inits(scale_w, normal):
    """The JAX estimators' init draw (``PRNGKey(seed)``, split, uniform or
    normal), for the port's init seams: the JAX cases then start where
    their JAX runs start (whether EM's stop fires before ``max_iter`` depends
    on the start)."""
    import jax

    def inits(random_state, m, n, k, dtype):
        key = jax.random.PRNGKey(0 if random_state is None else int(random_state))
        kw_, kh_ = jax.random.split(key)
        draw = jax.random.normal if normal else jax.random.uniform
        A = np.array(draw(kw_, (m, k), dtype=jnp.float64))
        B = np.array(draw(kh_, (n, k), dtype=jnp.float64))
        A, B = (0.1 * A, 0.1 * B) if normal else (A / k if scale_w else A, B)
        return torch.as_tensor(A).to(dtype), torch.as_tensor(B).to(dtype)

    return inits


@pytest.fixture
def jax_inits(monkeypatch):
    monkeypatch.setattr(port, "_em_inits", _jax_inits(True, False))
    monkeypatch.setattr(port, "_lsvd_inits", _jax_inits(False, True))


@pytest.mark.usefixtures("jax_inits")
class TestNBMFEM:
    def test_shapes_and_ranges(self):
        X = _toy()
        m = NBMFEM(n_components=4, max_iter=150, tol=1e-7, random_state=0).fit(X)
        assert m.W_.shape == (60, 4) and m.components_.shape == (4, 40)
        assert np.all(m.W_ >= 0)
        assert np.all((m.components_ >= 0) & (m.components_ <= 1))
        hist = np.asarray(m.loss_curve_)
        assert len(hist) == m.n_iter_ and np.all(np.isfinite(hist))
        P = m.W_ @ m.components_
        np.testing.assert_allclose(hist[-1], _obs_nll(X, P, np.ones_like(X)), rtol=1e-6)

    def test_masked_stops_gracefully(self):
        X = _toy(seed=2)
        m = NBMFEM(n_components=3, max_iter=100, random_state=0).fit(X, mask=_masked(X, 3))
        assert m.n_iter_ <= 100 and np.all(np.isfinite(m.loss_curve_))

    def test_reconstruction_beats_constant(self):
        X = _toy(seed=4)
        m = NBMFEM(n_components=5, max_iter=300, tol=1e-8, random_state=0).fit(X)
        R = m.reconstruction()
        nll = -(X * np.log(R + 1e-8) + (1 - X) * np.log(1 - R + 1e-8)).mean()
        p = X.mean()
        assert nll < -(p * np.log(p) + (1 - p) * np.log(1 - p))

    def test_validation(self):
        with pytest.raises(ValueError, match="must be binary"):
            NBMFEM(n_components=3).fit(np.full((5, 5), 2.0))


@pytest.mark.usefixtures("jax_inits")
class TestLogisticPCA:
    def test_fit_monotone_mm(self):
        m = LogisticPCA(n_components=4, max_iter=300, random_state=0).fit(_toy())
        hist = np.asarray(m.loss_curve_)
        assert np.all(np.diff(hist[:-1]) <= 1e-10)
        assert hist[-1] < hist[0]

    def test_reconstruction_quality(self):
        X = _toy(seed=5)
        R = LogisticPCA(n_components=5, max_iter=500, random_state=0).fit(X).reconstruction()
        assert np.all((R >= 0) & (R <= 1))
        assert np.mean((R > 0.5).astype(float) != X) < 0.25

    def test_masked_fit(self):
        X = _toy(seed=6)
        m = LogisticPCA(n_components=3, max_iter=200, random_state=0).fit(X, mask=_masked(X, 7))
        assert np.isfinite(m.loss_)

    def test_loadings_orthonormal(self):
        m = LogisticPCA(n_components=3, max_iter=50, random_state=0).fit(_toy(seed=8))
        B = m.components_.T
        np.testing.assert_allclose(B.T @ B, np.eye(3), atol=1e-8)


class TestArtifactQuality:
    """The paper's 10-init test protocol on the committed animals split
    against the stored artifact means, from the port's own seeded inits."""

    @pytest.fixture(scope="class")
    def animals(self):
        Y = np.load(os.path.join(DATA, "animals.npz"))["Y"].astype(float)
        s = np.load(os.path.join(REF_DIR, "animals_split.npz"))
        return Y, s["train_mask"].astype(float), s["test_mask"].astype(float)

    def test_logpca_matches_artifact(self, animals):
        Y, tm, testm = animals
        ref_mean = float(np.load(os.path.join(REF_DIR, "animals", "logPCA_test_init.npz"))
                         ["test_pplx"].mean())
        tests = [_obs_nll(Y, LogisticPCA(n_components=2, max_iter=1000, tol=1e-5,
                                         random_state=seed).fit(Y, mask=tm).reconstruction(),
                          testm) for seed in range(10)]
        ours = float(np.mean(tests))
        assert abs(ours - ref_mean) / ref_mean < 0.02, (ours, ref_mean)

    def test_em_matches_artifact(self, animals):
        Y, tm, testm = animals
        ref_mean = float(np.load(os.path.join(REF_DIR, "animals", "NBMF-EM_test_init.npz"))
                         ["test_pplx"].mean())
        tests, iters = [], []
        for seed in range(10):
            m = NBMFEM(n_components=16, max_iter=500, tol=1e-5, random_state=seed).fit(Y, mask=tm)
            tests.append(_obs_nll(Y, np.clip(m.W_ @ m.components_, 0, 1), testm))
            iters.append(m.n_iter_)
        ours = float(np.mean(tests))
        assert abs(ours - ref_mean) / ref_mean < 0.03, (ours, ref_mean)
        assert max(iters) <= 5, iters


# ------------------------------------------------------ precision and dtype
def test_em_highest_tier_matches_jax_fit_from_the_same_init(monkeypatch):
    """``precision=None``/``"highest"`` is the plain product: the port's
    ``_em_core`` from the estimator's own inits equals the JAX core's."""
    X = _toy(seed=9)
    seen = {}
    real = port._em_core

    def spy(Ym, Cm, W0, H0, *args, **kwargs):
        seen.update(W0=W0.numpy(), H0=H0.numpy(), precision=kwargs["precision"])
        return real(Ym, Cm, W0, H0, *args, **kwargs)

    monkeypatch.setattr(port, "_em_core", spy)
    for precision in (None, "highest", "HIGHEST"):
        m = NBMFEM(n_components=3, max_iter=80, tol=1e-9, random_state=1,
                   precision=precision).fit(X)
        *_, l_j, n_j, _ = jref._em_core(
            j64(X), j64(1 - X), j64(seen["W0"]), j64(seen["H0"]), j64(1e-9), j64(1e-8),
            j64(float(X.size)), max_iter=80, precision=jax_precision(precision))
        assert m.n_iter_ == int(n_j)
        np.testing.assert_allclose(m.loss_curve_, np.asarray(l_j)[:m.n_iter_], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("precision, form", [("high", "tf32r"), ("default", "bf16r")])
def test_em_tier_rounds_the_operands(monkeypatch, precision, form):
    """A reduced tier multiplies operands rounded as ``tiers.mxu_round``
    says; the losses stay within 1e-2 relative of the JAX package's fp32
    computation of the same tier on the CPU."""
    X = _toy(seed=10)
    calls = []
    real = tiers.mxu_round

    def spy(x, f):
        calls.append(f)
        return real(x, f)

    monkeypatch.setattr(tiers, "mxu_round", spy)
    m = NBMFEM(n_components=3, max_iter=20, tol=-1.0, random_state=2, precision=precision).fit(X)
    assert set(calls) == {form}
    plain = NBMFEM(n_components=3, max_iter=20, tol=-1.0, random_state=2).fit(X)
    assert m.loss_curve_ != plain.loss_curve_
    np.testing.assert_allclose(m.loss_curve_, plain.loss_curve_, rtol=1e-2)
    ref = JaxNBMFEM(n_components=3, max_iter=20, tol=-1.0, random_state=2,
                    precision=precision).fit(X)
    assert m.n_iter_ == ref.n_iter_ == 20
    np.testing.assert_allclose(m.loss_curve_, ref.loss_curve_, rtol=1e-2)


def test_em_precision_rejects_an_unknown_tier():
    with pytest.raises(ValueError, match="precision"):
        NBMFEM(n_components=2, precision="bogus").fit(_toy())


@pytest.mark.parametrize("dtype", ["float32", "float64", None])
def test_baselines_compute_in_their_dtype(dtype):
    X = _toy(seed=11)
    expected = np.float64 if dtype == "float64" else np.float32
    em = port.NBMFEM(n_components=3, max_iter=30, random_state=0, dtype=dtype, device="cpu").fit(X)
    lp = port.LogisticPCA(n_components=3, max_iter=30, random_state=0, dtype=dtype,
                          device="cpu").fit(X)
    assert em.W_.dtype == expected and lp.W_.dtype == expected and lp.mu_.dtype == expected
    ref_em = JaxNBMFEM(n_components=3, max_iter=30, random_state=0, dtype=dtype or "float32").fit(X)
    assert abs(em.loss_ - ref_em.loss_) / ref_em.loss_ < 0.05


def test_em_runs_in_bfloat16_and_logpca_refuses_it():
    X = _toy(seed=12)
    m = port.NBMFEM(n_components=3, max_iter=20, random_state=0, dtype="bfloat16",
                    device="cpu").fit(X)
    W = torch.as_tensor(m.W_)
    assert torch.equal(W.to(torch.bfloat16).float(), W)  # bf16 values
    assert np.all(np.isfinite(m.loss_curve_)) and 1 <= m.n_iter_ <= 20
    ref = JaxNBMFEM(n_components=3, max_iter=20, random_state=0, dtype="bfloat16").fit(X)
    assert abs(m.loss_curve_[0] - float(ref.loss_curve_[0])) < 0.05
    with pytest.raises(TypeError):
        JaxLogisticPCA(n_components=2, max_iter=5, dtype="bfloat16").fit(X)
    with pytest.raises(TypeError, match="bfloat16"):
        port.LogisticPCA(n_components=2, max_iter=5, dtype="bfloat16", device="cpu").fit(X)


def test_inits_are_seeded_on_the_cpu():
    X = _toy(seed=13)
    a = NBMFEM(n_components=3, max_iter=5, random_state=7).fit(X)
    b = NBMFEM(n_components=3, max_iter=5, random_state=7).fit(X)
    c = NBMFEM(n_components=3, max_iter=5, random_state=None).fit(X)
    d = NBMFEM(n_components=3, max_iter=5, random_state=0).fit(X)
    np.testing.assert_array_equal(a.W_, b.W_)
    np.testing.assert_array_equal(c.W_, d.W_)
    assert not np.array_equal(a.W_, d.W_)
