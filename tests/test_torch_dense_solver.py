"""The port's fused loop on dense operands (``[0, 1]``-valued data and
weighted masks) against the JAX package's ``solve`` in float64 on the CPU,
with explicit inits; and the ``packed`` contract.

Bar: identical ``n_iter`` and ``converged``; losses within 1e-10 relative;
W and H within 1e-10.  ``packed=False`` and ``packed=None`` give bitwise the
same results on binary data.
"""

import functools

import numpy as np
import pytest
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port

torch.set_num_threads(1)

M, N, K = 48, 36, 3


@functools.lru_cache(maxsize=None)
def _data(seed=21, m=M, n=N, k=K):
    """Soft data from a planted mean model, a weighted mask, and binary
    data with a binary mask."""
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(k), size=m)
    H = rng.uniform(0.05, 0.95, (k, n))
    P = W @ H
    weighted = (rng.random((m, n)) < 0.8) * np.where(rng.random((m, n)) < 0.3, 0.5, 1.0)
    Yb = (rng.random((m, n)) < P).astype(np.float64)
    mask_b = (rng.random((m, n)) < 0.8).astype(np.float64)
    return P, weighted, Yb, mask_b


def _inits(seed=5, m=M, n=N, k=K):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.9, (m, k)), rng.uniform(0.1, 0.9, (k, n))


# (orientation, mask_mode or None, max_iter, projection); max_iter=300 runs
# converge, max_iter=6 runs exhaust the budget (the loglik_sum fill).
CASES = [
    ("beta-dir", None, 300, "normalize"),
    ("beta-dir", "parity", 300, "normalize"),
    ("beta-dir", "corrected", 300, "normalize"),
    ("dir-beta", None, 300, "normalize"),
    ("dir-beta", "corrected", 300, "normalize"),
    ("beta-dir", "parity", 300, "duchi"),
    ("beta-dir", None, 6, "normalize"),
    ("beta-dir", "parity", 6, "normalize"),
    ("dir-beta", "corrected", 6, "duchi"),
]


def _kwargs(case):
    orientation, mask_mode, max_iter, projection = case
    P, weighted, _, _ = _data()
    W0, H0 = _inits()
    return P, dict(
        n_components=K, max_iter=max_iter, tol=1e-5, W_init=W0, H_init=H0,
        mask=None if mask_mode is None else weighted, orientation=orientation,
        mask_mode=mask_mode or "parity", projection=projection, dtype="float64",
    )


def _assert_matches(res, ref):
    assert res.n_iter == ref.n_iter
    assert res.converged == ref.converged
    assert len(res.losses) == res.n_iter
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-10, atol=0)
    np.testing.assert_allclose(res.W, ref.W, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.H, ref.H, rtol=0, atol=1e-10)


def _assert_bitwise(a, b):
    assert a.n_iter == b.n_iter and a.converged == b.converged
    assert a.losses == b.losses
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_dense_fused_matches_jax(case):
    Y, kw = _kwargs(case)
    res = port.solve(Y, backend="fused", device="cpu", **kw)
    assert res.extras == {"backend": "fused", "packed": False}
    ref = jref.solve(Y, backend="jnp", **kw)
    if case[2] == 300:
        assert ref.converged and ref.n_iter < 300
    else:
        assert not ref.converged and ref.n_iter == case[2]
    _assert_matches(res, ref)


def test_dense_fused_matches_jax_pallas_dense():
    """Against the JAX dense Pallas loop (interpret mode) at a shape without
    pad entries."""
    m, n, k = 512, 384, 4
    P, _, _, _ = _data(seed=2, m=m, n=n, k=k)
    W0, H0 = _inits(m=m, n=n, k=k)
    kw = dict(n_components=k, max_iter=8, tol=1e-5, W_init=W0, H_init=H0, dtype="float64")
    ref = jref.solve(P, backend="pallas", pallas_interpret=True, packed=False, **kw)
    res = port.solve(P, backend="fused", device="cpu", packed=False, **kw)
    _assert_matches(res, ref)


@pytest.mark.parametrize("mask_mode", [None, "parity", "corrected"])
def test_packed_false_equals_packed_none_on_binary_data(mask_mode):
    _, _, Yb, mask_b = _data()
    W0, H0 = _inits()
    kw = dict(n_components=K, max_iter=40, tol=1e-6, W_init=W0, H_init=H0, dtype="float64",
              mask=None if mask_mode is None else mask_b, mask_mode=mask_mode or "parity",
              backend="fused", device="cpu")
    dense = port.solve(Yb, packed=False, **kw)
    auto = port.solve(Yb, packed=None, **kw)
    assert dense.extras["packed"] is False and auto.extras["packed"] is True
    _assert_bitwise(dense, auto)
    _assert_bitwise(port.solve(Yb, packed=True, **kw), auto)


@pytest.mark.parametrize(
    "data, kwargs, match",
    [
        ("soft", dict(backend="fused"), "exactly binary"),
        ("binary-weighted-mask", dict(backend="fused"), "exactly binary"),
        ("binary", dict(backend="plain"), "requires the fused loop"),
        ("binary", dict(backend="auto"), "requires the fused loop"),
    ],
    ids=["soft-data", "weighted-mask", "plain", "auto-on-cpu"],
)
def test_packed_true_errors(data, kwargs, match):
    P, weighted, Yb, _ = _data()
    Y = P if data == "soft" else Yb
    mask = weighted if data == "binary-weighted-mask" else None
    with pytest.raises(ValueError, match=match):
        port.solve(Y, K, max_iter=3, mask=mask, packed=True, device="cpu", **kwargs)


def test_packed_argument_validated():
    with pytest.raises(ValueError, match="packed"):
        port.solve(_data()[2], K, max_iter=3, packed="yes", device="cpu", backend="fused")


def test_estimator_fit_on_soft_data_streams_dense():
    P, _, Yb, _ = _data()
    W0, H0 = _inits()
    params = dict(n_components=K, max_iter=30, W_init=W0, H_init=H0, dtype="float64",
                  backend="fused", device="cpu")
    est = port.NBMF(**params).fit(P)
    assert est.solver_result_.extras["packed"] is False
    ref = jref.NBMF(backend="jnp", **{k: v for k, v in params.items()
                                      if k not in ("backend", "device")}).fit(P)
    np.testing.assert_allclose(est.loss_curve_, ref.loss_curve_, rtol=1e-10, atol=0)
    assert port.NBMF(**params).fit(Yb).solver_result_.extras["packed"] is True
    forced = port.NBMF(packed=False, **params).fit(Yb)
    assert forced.solver_result_.extras["packed"] is False


def test_plain_backend_reports_unpacked():
    res = port.solve(_data()[2], K, max_iter=3, random_state=0, device="cpu", backend="plain")
    assert res.extras == {"backend": "plain", "packed": False}
