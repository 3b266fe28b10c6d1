"""The port's serving path: ``fold_in_fused`` against the JAX package's (Pallas
in interpret mode) in float64 with the same start, the ``FoldInServer``
contracts of ``tests/test_serving.py``, and the estimator's fused
``transform`` against its plain one.

On the CPU the kernel wrappers run their plain versions, so
``backend="fused"`` drives the kernel route here.  Tolerances: 1e-10 on W
and scores between implementations in float64; bitwise where the contract
says so (packed against dense, sparse against dense).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nbmf_mm_tpu.models.serving import fold_in_fused as jax_fold_in_fused
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu_torch import FoldInServer, fold_in_fused
from nbmf_mm_tpu_torch.models import estimator as est_mod
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs

torch.set_num_threads(1)

N_FEATURES = 40


@pytest.fixture(scope="module")
def model():
    X = (np.random.default_rng(0).random((80, N_FEATURES)) < 0.3).astype(float)
    return port.NBMF(n_components=4, max_iter=100, random_state=0, device="cpu").fit(X)


def _binary(rows, seed, n=N_FEATURES):
    return (np.random.default_rng(seed).random((rows, n)) < 0.3).astype(float)


def _server(model, **kw):
    kw.setdefault("backend", "fused")
    return FoldInServer(model, device="cpu", **kw)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("data", ["binary", "continuous"])
def test_fold_in_fused_matches_jax(data, masked):
    rng = np.random.default_rng(12)
    k, n, rows = 4, 150, 90
    H = rng.uniform(0.1, 0.9, (k, n))
    W0t = rng.uniform(0.1, 0.9, (k, rows))
    X = (rng.random((rows, n)) < 0.35).astype(float) if data == "binary" else rng.random((rows, n))
    mask = (rng.random((rows, n)) < 0.8).astype(float) if masked else None
    W_j, s_j = jax_fold_in_fused(H, X, mask, W0t, dtype="float64", interpret=True)
    W_t, s_t = fold_in_fused(H, X, mask, W0t, dtype="float64", device="cpu")
    assert W_t.shape == (rows, k) and s_t.shape == (rows,)
    np.testing.assert_allclose(W_t, np.asarray(W_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=1e-10)


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_fold_in_shapes_and_simplex(model, backend):
    W, scores = _server(model, buckets=(8, 32), backend=backend).transform(_binary(5, 1))
    assert W.shape == (5, 4) and scores.shape == (5,)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)
    assert np.all(np.isfinite(scores)) and np.all(scores <= 0)


def test_padding_does_not_change_real_rows(model):
    srv = _server(model, buckets=(16,))
    X10 = _binary(10, 2)
    W10, s10 = srv.transform(X10)
    W3, s3 = srv.transform(X10[:3])
    np.testing.assert_allclose(W3, W10[:3], atol=1e-6)
    np.testing.assert_allclose(s3, s10[:3], atol=1e-6)


def test_chunking_beyond_top_bucket(model):
    srv = _server(model, buckets=(4, 8))
    X = _binary(21, 3)
    W, s = srv.transform(X)
    assert W.shape == (21, 4) and s.shape == (21,)
    W8, s8 = srv.transform(X[8:16])  # the second chunk, served alone
    np.testing.assert_array_equal(W[8:16], W8)
    np.testing.assert_array_equal(s[8:16], s8)


def test_masked_serving(model):
    rng = np.random.default_rng(4)
    mask = (rng.random((6, N_FEATURES)) < 0.8).astype(float)
    W, s = _server(model, buckets=(8,)).transform(_binary(6, 4), mask=mask)
    assert np.all(np.isfinite(s))
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)


def test_accepts_raw_H_tensor_and_solver_result_and_warmup(model):
    X = _binary(2, 5)
    W_ref, _ = _server(model, buckets=(8,)).transform(X)
    for source in (model.components_, torch.tensor(model.components_),
                   model.solver_result_):
        srv = _server(source, buckets=(8,)).warmup()
        W, _ = srv.transform(X)
        assert W.shape == (2, 4)
        np.testing.assert_array_equal(W, W_ref)


def test_unfitted_estimator_rejected():
    with pytest.raises(ValueError, match="not fitted"):
        FoldInServer(port.NBMF(n_components=3, device="cpu"), device="cpu")


def test_mesh_not_ported(model):
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        FoldInServer(model, mesh=object(), device="cpu")


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_packed_serving_bitwise_matches_dense(model, masked):
    rng = np.random.default_rng(7)
    X = _binary(200, 7)
    mask = (rng.random(X.shape) < 0.8).astype(float) if masked else None
    Wd, sd = _server(model, buckets=(256,), packed=False).transform(X, mask=mask)
    Wp, sp_ = _server(model, buckets=(256,), packed=None).transform(X, mask=mask)
    np.testing.assert_array_equal(Wp, Wd)
    np.testing.assert_array_equal(sp_, sd)


def test_packed_serving_continuous_fallback(model, monkeypatch):
    """A weighted mask makes the chunk ineligible for packing: the auto rule
    serves it dense (the packed kernel is never called), same results."""
    rng = np.random.default_rng(8)
    X = _binary(50, 8)
    w = rng.random(X.shape)
    Wd, _ = _server(model, buckets=(64,), packed=False).transform(X, mask=w)

    def refuse(*args, **kwargs):
        raise AssertionError("a weighted-mask chunk reached the packed kernel")

    monkeypatch.setattr(cs, "w_terms_packed", refuse)
    Wa, _ = _server(model, buckets=(64,), packed=None).transform(X, mask=w)
    np.testing.assert_array_equal(Wa, Wd)


def test_packed_true_rejects_nonbinary(model):
    srv = _server(model, buckets=(128,), packed=True)
    with pytest.raises(ValueError, match="exactly binary"):
        srv.transform(np.random.default_rng(0).random((64, N_FEATURES)))
    with pytest.raises(ValueError, match="requires the fused loop"):
        _server(model, backend="plain", packed=True)


def test_empty_batch(model):
    W, s = _server(model, buckets=(8,)).transform(np.zeros((0, N_FEATURES)))
    assert W.shape == (0, 4) and s.shape == (0,)


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_sparse_request_batches_match_dense(model, backend):
    rng = np.random.default_rng(11)
    X = (rng.random((21, N_FEATURES)) < 0.15).astype(float)
    mask = (rng.random((21, N_FEATURES)) < 0.8).astype(float)
    srv = _server(model, buckets=(4, 8), backend=backend)
    for mk, mk_sparse in ((None, None), (mask, sp.csr_matrix(mask))):
        Wd, sd = srv.transform(X, mask=mk)
        Ws, ss = srv.transform(sp.csr_matrix(X), mask=mk_sparse)
        np.testing.assert_array_equal(Wd, Ws)
        np.testing.assert_array_equal(sd, ss)
    W0, s0 = srv.transform(sp.csr_matrix((0, N_FEATURES)))
    assert W0.shape == (0, 4) and s0.shape == (0,)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("data", ["binary", "continuous"])
def test_fused_transform_matches_plain_transform(data, masked):
    rng = np.random.default_rng(5)
    X = (rng.random((150, 170)) < 0.35).astype(float)
    Xnew = (rng.random((90, 170)) < 0.35).astype(float) if data == "binary" else rng.random(
        (90, 170))
    mask = (rng.random(Xnew.shape) < 0.8).astype(float) if masked else None
    plain = port.NBMF(n_components=4, max_iter=40, random_state=3, dtype="float64",
                      backend="plain", device="cpu").fit(X)
    fused = port.NBMF(n_components=4, max_iter=40, random_state=3, dtype="float64",
                      backend="fused", device="cpu").fit(X)
    np.testing.assert_allclose(fused.components_, plain.components_, rtol=0, atol=1e-10)
    fused.components_ = plain.components_  # compare the two fold-ins alone
    W_plain = plain.transform(Xnew, mask=mask)
    W_fused = fused.transform(Xnew, mask=mask)
    np.testing.assert_allclose(W_fused, W_plain, rtol=0, atol=1e-10)
    np.testing.assert_allclose(W_fused.sum(axis=1), 1.0, atol=1e-12)


def test_fused_transform_routing():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    big = est_mod._FUSED_TRANSFORM_MIN_ENTRIES
    route = lambda backend, n, dtype, device: port.NBMF(backend=backend)._use_fused_transform(
        n, dtype, device)
    assert route("fused", 1, torch.float64, cpu)
    assert route("auto", big, torch.float32, cuda)
    assert not route("auto", big - 1, torch.float32, cuda)
    assert not route("auto", big, torch.float64, cuda)
    assert not route("auto", big, torch.float32, cpu)
    assert not route("plain", big, torch.float32, cuda)
