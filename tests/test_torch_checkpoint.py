"""Checkpoint and resume in the PyTorch port: the cases of
``tests/test_checkpoint.py`` on the port (CPU, float64 where the JAX suite's
x64 mode sets its bars), checkpoint files crossing between the two packages
in both directions, ``resume_fit``/``fit_checkpointed`` against the JAX
package's under explicit inits, and ``device_results=True`` models.

Bars: the factors, losses, ``n_iter_`` and hyperparameters of a file read by
the other package are bitwise; trajectories of the two packages agree to
1e-10 (relative losses, absolute factors) in float64.  A segmented fit
deviates from the uninterrupted one only by the rounding of the
re-normalization at segment starts: 1e-15 in float64 and under 1e-6 in
float32 (``SEGMENT_BARS``, which ``chip_smoke.py`` phase 11 holds the card
to at the headline).
"""

import json

import numpy as np
import pytest
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.models import estimator as jref_estimator
from nbmf_mm_tpu.solver.driver import _resolve_precision as jref_precision
from nbmf_mm_tpu.utils import checkpoint as jref_ckpt
from nbmf_mm_tpu_torch.models import estimator as port_estimator
from nbmf_mm_tpu_torch.utils import checkpoint as port_ckpt
from nbmf_mm_tpu_torch.utils import (
    load_checkpoint,
    load_model,
    resume_fit,
    save_checkpoint,
    save_model,
)

torch.set_num_threads(1)

F64 = dict(dtype="float64", device="cpu")
# Segmented against uninterrupted fits in float32: max |dW|, max |dH| and the
# largest relative loss deviation.
SEGMENT_BARS = dict(W=1e-5, H=1e-5, loss=1e-6)
HYPERPARAMS = ("n_components", "alpha", "beta", "orientation", "tol", "max_iter",
               "projection", "mask_mode")


def _toy(m=40, n=30, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def NBMF(**kw):
    return port.NBMF(**{**F64, **kw})


# ------------------------------------------------- tests/test_checkpoint.py
def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "ckpt.npz"
    W = np.random.default_rng(0).random((10, 3))
    H = np.random.default_rng(1).random((3, 8))
    save_checkpoint(path, W, H, [1.0, 0.5], 2, seed=42, hyperparams={"alpha": 1.2})
    ckpt = load_checkpoint(path)
    np.testing.assert_array_equal(ckpt["W"], W)
    np.testing.assert_array_equal(ckpt["H"], H)
    assert ckpt["losses"] == [1.0, 0.5]
    assert ckpt["n_iter"] == 2
    assert ckpt["seed"] == 42
    assert ckpt["hyperparams"]["alpha"] == 1.2


def test_model_save_load_scores_identically(tmp_path):
    X = _toy()
    m = NBMF(n_components=3, max_iter=60, random_state=0).fit(X)
    path = tmp_path / "model.npz"
    save_model(path, m)
    m2 = load_model(path, device="cpu")
    np.testing.assert_array_equal(m2.W_, m.W_)
    np.testing.assert_array_equal(m2.components_, m.components_)
    assert m2.n_iter_ == m.n_iter_
    assert np.isclose(m2.score(X), m.score(X))


def test_resume_continues_descent(tmp_path):
    X = _toy(seed=2)
    partial_model = NBMF(n_components=3, max_iter=5, tol=1e-12, random_state=0).fit(X)
    path = tmp_path / "partial.npz"
    save_model(path, partial_model)
    resumed = resume_fit(path, X, max_iter=60, **F64)
    hist = np.asarray(resumed.loss_curve_)
    assert len(hist) == resumed.n_iter_
    assert len(hist) > 5
    assert np.all(np.diff(hist) <= 1e-12)
    assert hist[-1] <= hist[4]


def test_resume_with_fully_unobserved_sample(tmp_path):
    rng = np.random.default_rng(5)
    X = (rng.random((4, 33)) < 0.5).astype(float)
    mask = (rng.random((4, 33)) < 0.7).astype(float)
    mask[:, 25] = 0.0  # one fully-unobserved column
    model = NBMF(n_components=3, max_iter=26, tol=1e-4, alpha=3.46, beta=3.43,
                 orientation="dir-beta", mask_mode="corrected", random_state=0).fit(X, mask=mask)
    assert np.asarray(model.components_)[:, 25].sum() == 0.0
    path = tmp_path / "unobserved.npz"
    save_model(path, model)
    resumed = resume_fit(path, X, mask=mask, **F64)
    hist = np.asarray(resumed.loss_curve_)
    assert np.all(np.isfinite(hist))
    assert np.all(np.isfinite(resumed.W_)) and np.all(np.isfinite(resumed.components_))
    assert np.all(np.diff(hist[model.n_iter_ - 1:]) <= 1e-10)
    assert np.asarray(resumed.components_)[:, 25].sum() == 0.0


def test_warm_start_zero_simplex_row_direct_solve():
    rng = np.random.default_rng(7)
    X = (rng.random((20, 12)) < 0.4).astype(float)
    mask = (rng.random((20, 12)) < 0.8).astype(float)
    mask[3, :] = 0.0  # one fully-unobserved row (beta-dir simplex side)
    first = port.solve(X, 3, mask=mask, mask_mode="corrected", max_iter=20, tol=0.0,
                       random_state=1, **F64)
    assert np.asarray(first.W)[3].sum() == 0.0
    second = port.solve(X, 3, W_init=first.W, H_init=first.H, mask=mask, mask_mode="corrected",
                        max_iter=10, tol=0.0, **F64)
    assert np.all(np.isfinite(np.asarray(second.losses)))
    assert np.all(np.isfinite(second.W)) and np.all(np.isfinite(second.H))
    assert np.asarray(second.W)[3].sum() == 0.0
    assert np.asarray(second.losses)[0] <= np.asarray(first.losses)[-1] + 1e-10


def test_fit_checkpointed_segments(tmp_path):
    X = _toy(seed=9)
    path = tmp_path / "segmented.npz"
    model = NBMF(n_components=3, max_iter=60, tol=1e-12, random_state=0)
    fitted = port_ckpt.fit_checkpointed(model, X, path, every=20)
    assert fitted.n_iter_ == 60
    assert len(fitted.loss_curve_) == 60
    hist = np.asarray(fitted.loss_curve_)
    assert np.all(np.diff(hist) <= 1e-10)
    assert load_checkpoint(path)["n_iter"] == 60
    ref = NBMF(n_components=3, max_iter=60, tol=1e-12, random_state=0).fit(X)
    np.testing.assert_allclose(hist, ref.loss_curve_, rtol=1e-8)


def test_fit_checkpointed_early_convergence(tmp_path):
    X = _toy(seed=10)
    model = NBMF(n_components=3, max_iter=500, tol=1e-3, random_state=0)
    fitted = port_ckpt.fit_checkpointed(model, X, tmp_path / "c.npz", every=50)
    assert fitted.n_iter_ < 500
    assert len(fitted.loss_curve_) == fitted.n_iter_


def test_fit_checkpointed_with_restarts(tmp_path):
    X = _toy(seed=11)
    model = NBMF(n_components=3, max_iter=60, tol=1e-12, random_state=0, n_init=3)
    fitted = port_ckpt.fit_checkpointed(model, X, tmp_path / "r.npz", every=20)
    assert fitted.n_iter_ == 60
    assert np.all(np.diff(np.asarray(fitted.loss_curve_)) <= 1e-10)


# -------------------------------------------- the segments' only deviation
@pytest.mark.parametrize("dtype, backend", [("float64", "plain"), ("float32", "fused")])
def test_segmented_fit_deviates_only_by_renormalization(tmp_path, monkeypatch, dtype, backend):
    """Four segments of 25 sweeps against one 100-sweep fit, tol=0, on the
    loop each dtype takes on the card.  float64 shows the only source of
    deviation (rounding at segment starts); float32 sets the bars."""
    X = _toy(200, 300, seed=12)
    kw = dict(n_components=16, max_iter=100, tol=0.0, random_state=0, dtype=dtype,
              backend=backend, device="cpu")
    writes = []
    real_save = port_ckpt.save_checkpoint

    def counting_save(*args, **kwargs):
        writes.append(args[4])
        return real_save(*args, **kwargs)

    monkeypatch.setattr(port_ckpt, "save_checkpoint", counting_save)
    seg = port_ckpt.fit_checkpointed(port.NBMF(**kw), X, tmp_path / "s.npz", every=25)
    ref = port.NBMF(**kw).fit(X)
    assert writes == [25, 50, 75, 100]
    assert seg.n_iter_ == 100 and len(seg.loss_curve_) == 100
    l_seg, l_ref = np.asarray(seg.loss_curve_), np.asarray(ref.loss_curve_)
    dev = dict(W=np.abs(seg.W_ - ref.W_).max(), H=np.abs(seg.components_ - ref.components_).max(),
               loss=(np.abs(l_seg - l_ref) / np.abs(l_ref)).max())
    bars = SEGMENT_BARS if dtype == "float32" else dict(W=1e-13, H=1e-13, loss=1e-13)
    assert all(dev[key] <= bars[key] for key in bars), dev


# ------------------------------------------------- files across the packages
def _jax_model(X, **kw):
    return jref.NBMF(n_components=3, max_iter=40, tol=1e-12, random_state=3, **kw).fit(X)


def _same_fitted(a, b):
    np.testing.assert_array_equal(np.asarray(a.W_), np.asarray(b.W_))
    np.testing.assert_array_equal(np.asarray(a.components_), np.asarray(b.components_))
    assert list(a.loss_curve_) == list(b.loss_curve_)
    assert a.n_iter_ == b.n_iter_
    for name in HYPERPARAMS + ("random_state",):
        assert getattr(a, name) == getattr(b, name), name


def _fold_in_both(H, X, W0t):
    """The fold-in of both packages' ``_transform_core`` from one start."""
    Ym, Ym2 = X, 1.0 - X
    W_jax = np.asarray(jref_estimator._transform_core(
        H, Ym, Ym2, W0t, 1e-8, n_iter=50, precision=jref_precision(None)))
    t = lambda A: torch.as_tensor(np.asarray(A, dtype=np.float64))
    W_port = port_estimator._transform_core(t(H), t(Ym), t(Ym2), t(W0t), 1e-8, n_iter=50)
    return W_jax, W_port.numpy()


@pytest.mark.parametrize("orientation", ["beta-dir", "dir-beta"])
def test_jax_file_loads_in_the_port(tmp_path, orientation):
    X = _toy(seed=13)
    ref = _jax_model(X, orientation=orientation, alpha=1.5, mask_mode="corrected")
    path = tmp_path / "jax.npz"
    jref_ckpt.save_model(path, ref)
    model = load_model(path, device="cpu")
    _same_fitted(model, jref_ckpt.load_model(path))
    assert model.device == "cpu"
    W = np.random.default_rng(0).uniform(0, 1, (5, 3))
    np.testing.assert_array_equal(model.inverse_transform(W), ref.inverse_transform(W))
    W0t = np.random.default_rng(1).uniform(0.1, 0.9, (3, 40))
    W_jax, W_port = _fold_in_both(model.components_, X, W0t)
    np.testing.assert_allclose(W_port, W_jax, rtol=0, atol=1e-10)


@pytest.mark.parametrize("orientation", ["beta-dir", "dir-beta"])
def test_port_file_loads_in_jax(tmp_path, orientation):
    X = _toy(seed=14)
    model = NBMF(n_components=3, max_iter=40, tol=1e-12, random_state=4, orientation=orientation,
                 beta=1.7, projection="duchi").fit(X)
    path = tmp_path / "port.npz"
    save_model(path, model)
    ref = jref_ckpt.load_model(path)
    _same_fitted(ref, model)
    with np.load(path, allow_pickle=False) as data:
        assert sorted(data.files) == ["H", "W", "losses", "meta", "n_iter"]
        assert data["losses"].dtype == np.float64
        meta = json.loads(str(data["meta"]))
    assert meta["format_version"] == 1 and sorted(meta["hyperparams"]) == sorted(HYPERPARAMS)
    W = np.random.default_rng(2).uniform(0, 1, (5, 3))
    np.testing.assert_array_equal(ref.inverse_transform(W), model.inverse_transform(W))
    W0t = np.random.default_rng(3).uniform(0.1, 0.9, (3, 40))
    W_jax, W_port = _fold_in_both(ref.components_, X, W0t)
    np.testing.assert_allclose(W_port, W_jax, rtol=0, atol=1e-10)


def _trajectories_agree(a, b):
    la, lb = np.asarray(a.loss_curve_), np.asarray(b.loss_curve_)
    assert a.n_iter_ == b.n_iter_ and la.shape == lb.shape
    np.testing.assert_allclose(la, lb, rtol=1e-10, atol=0)
    np.testing.assert_allclose(np.asarray(a.W_), np.asarray(b.W_), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(a.components_), np.asarray(b.components_), rtol=0,
                               atol=1e-10)


def test_resume_fit_agrees_with_jax(tmp_path):
    X = _toy(seed=15)
    mask = (np.random.default_rng(15).random(X.shape) < 0.8).astype(float)
    path = tmp_path / "start.npz"
    jref_ckpt.save_model(path, _jax_model(X))
    ref = jref_ckpt.resume_fit(path, X, mask=mask, max_iter=30, tol=1e-12)
    ours = resume_fit(path, X, mask=mask, max_iter=30, tol=1e-12, **F64)
    _trajectories_agree(ours, ref)
    assert ours.n_iter_ == 40 + 30


def test_fit_checkpointed_agrees_with_jax(tmp_path):
    X = _toy(seed=16)
    rng = np.random.default_rng(16)
    inits = dict(W_init=rng.uniform(0.1, 0.9, (40, 3)), H_init=rng.uniform(0.1, 0.9, (3, 30)))
    kw = dict(n_components=3, max_iter=45, tol=1e-12, random_state=0, **inits)
    ref = jref_ckpt.fit_checkpointed(jref.NBMF(**kw), X, tmp_path / "j.npz", every=20)
    ours = port_ckpt.fit_checkpointed(NBMF(**kw), X, tmp_path / "p.npz", every=20)
    _trajectories_agree(ours, ref)
    a, b = jref_ckpt.load_checkpoint(tmp_path / "j.npz"), load_checkpoint(tmp_path / "p.npz")
    assert a["n_iter"] == b["n_iter"] == 45 and a["hyperparams"] == b["hyperparams"]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-10, atol=0)


# ------------------------------------------------------ device_results models
def _device_results_model(**kw):
    return NBMF(n_components=3, max_iter=30, tol=1e-12, random_state=0,
                solver_options={"device_results": True}, **kw).fit(_toy(seed=17))


def test_device_results_model_saves_its_tensors(tmp_path):
    model = _device_results_model()
    assert isinstance(model.W_, torch.Tensor) and isinstance(model.loss_curve_, torch.Tensor)
    path = tmp_path / "dev.npz"
    save_model(path, model)
    ckpt = load_checkpoint(path)
    np.testing.assert_array_equal(ckpt["W"], model.W_.cpu().numpy())
    np.testing.assert_array_equal(ckpt["H"], model.components_.cpu().numpy())
    assert ckpt["losses"] == [float(x) for x in model.loss_curve_.cpu().numpy()]
    loaded = load_model(path, device="cpu")
    assert loaded.transform(_toy(seed=18)).shape == (40, 3)
    jref_ckpt.load_model(path)  # the JAX package reads it too


def test_device_results_resume_and_segments(tmp_path):
    model = _device_results_model()
    path = tmp_path / "dev.npz"
    save_model(path, model)
    resumed = resume_fit(path, _toy(seed=17), max_iter=10, **F64,
                         solver_options={"device_results": True})
    assert isinstance(resumed.loss_curve_, list) and len(resumed.loss_curve_) == 40
    seg = port_ckpt.fit_checkpointed(
        NBMF(n_components=3, max_iter=30, tol=0.0, random_state=0,
             solver_options={"device_results": True}),
        _toy(seed=17), tmp_path / "seg.npz", every=10)
    assert seg.n_iter_ == 30 and isinstance(seg.loss_curve_, list)
    assert load_checkpoint(tmp_path / "seg.npz")["n_iter"] == 30


def test_resume_fit_rejects_unknown_parameters(tmp_path):
    path = tmp_path / "m.npz"
    save_model(path, NBMF(n_components=2, max_iter=3, random_state=0).fit(_toy()))
    with pytest.raises(TypeError, match="bogus"):
        resume_fit(path, _toy(), bogus=1, **F64)
