"""The port's sweep math (ops/updates.py, ops/projection.py) against the JAX
package's jnp functions, float64 on the CPU, to 1e-12 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbmf_mm_tpu.ops import projection as jproj
from nbmf_mm_tpu.ops import updates as jup
from nbmf_mm_tpu_torch.ops import projection as tproj
from nbmf_mm_tpu_torch.ops import updates as tup

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST
RTOL = 1e-12
M, N, K = 30, 20, 4


def _close(port, ref, rtol=RTOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(port - ref).max() <= rtol * scale


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    Y = (rng.random((M, N)) < 0.4).astype(np.float64)
    mask = (rng.random((M, N)) < 0.7).astype(np.float64)
    W = rng.uniform(0.1, 0.9, (K, M))
    W /= W.sum(axis=0, keepdims=True)
    H = rng.uniform(0.1, 0.9, (K, N))
    return Y, mask, W, H


def _terms(Y, mask, mode):
    t = tup.precompute_masked_terms(torch.tensor(Y), None if mask is None else torch.tensor(mask),
                                    mode)
    j = jup.precompute_masked_terms(jnp.asarray(Y), None if mask is None else jnp.asarray(mask),
                                    mode)
    return t, j


@pytest.mark.parametrize("masked, mode", [(False, "parity"), (True, "parity"), (True, "corrected")])
def test_precompute_masked_terms(case, masked, mode):
    Y, mask, _, _ = case
    t, j = _terms(Y, mask if masked else None, mode)
    for a, b in zip(t, j):
        _close(a, b)


def test_precompute_rejects_unknown_mode(case):
    with pytest.raises(ValueError):
        tup.precompute_masked_terms(torch.tensor(case[0]), None, "bogus")


def test_clip_upper_interior():
    assert tup.clip_upper_interior(1e-8, torch.float64) == float(
        jup.clip_upper_interior(1e-8, jnp.float64)
    )
    f32 = tup.clip_upper_interior(1e-8, torch.float32)
    assert f32 == float(np.float32(0.99999994)) == float(jup.clip_upper_interior(1e-8, jnp.float32))
    assert torch.tensor(f32, dtype=torch.float32).item() < 1.0


@pytest.mark.parametrize("mode", ["parity", "corrected"])
def test_h_update(case, mode):
    Y, mask, W, H = case
    (Ym, _, Yc), (jYm, _, jYc) = _terms(Y, mask, mode)
    port = tup._h_update(torch.tensor(W), torch.tensor(H), Ym, Yc, 1.2, 1.3, 1e-8)
    ref = jup._h_update(jnp.asarray(W), jnp.asarray(H), jYm, jYc, 1.2, 1.3, 1e-8, HIGHEST)
    _close(port, ref)


@pytest.mark.parametrize("projection", ["normalize", "duchi"])
def test_w_update(case, projection):
    Y, mask, W, H = case
    (Ym, Ym2, _), (jYm, jYm2, _) = _terms(Y, mask, "parity")
    port = tup._w_update(torch.tensor(W), torch.tensor(H), Ym, Ym2, N, 1e-8, projection)
    ref = jup._w_update(jnp.asarray(W), jnp.asarray(H), jYm, jYm2, N, 1e-8, projection, HIGHEST)
    _close(port, ref)


@pytest.mark.parametrize("projection", ["normalize", "duchi"])
@pytest.mark.parametrize("masked", [False, True])
def test_mm_sweep(case, projection, masked):
    Y, mask, W, H = case
    (Ym, Ym2, Yc), (jYm, jYm2, jYc) = _terms(Y, mask if masked else None, "parity")
    kw = dict(alpha=1.2, beta=1.2, n_real=N, eps=1e-8, projection=projection)
    Wt, Ht = tup.mm_sweep(torch.tensor(W), torch.tensor(H), Ym, Ym2, Yc, **kw)
    Wj, Hj = jup.mm_sweep(jnp.asarray(W), jnp.asarray(H), jYm, jYm2, jYc, precision=HIGHEST, **kw)
    _close(Wt, Wj)
    _close(Ht, Hj)


@pytest.mark.parametrize("mode", ["parity", "corrected"])
def test_map_objective(case, mode):
    Y, mask, W, H = case
    (Ym, _, Yc), (jYm, _, jYc) = _terms(Y, mask, mode)
    kw = dict(alpha=1.5, beta=0.8, n_obs=float(mask.sum()), eps=1e-8)
    port = tup.map_objective(torch.tensor(W), torch.tensor(H), Ym, Yc, **kw)
    ref = jup.map_objective(jnp.asarray(W), jnp.asarray(H), jYm, jYc, precision=HIGHEST, **kw)
    _close(port, ref)


def test_fold_in_w_update(case):
    Y, mask, W, H = case
    (Ym, Ym2, _), (jYm, jYm2, _) = _terms(Y, mask, "parity")
    port = tup.fold_in_w_update(torch.tensor(W), torch.tensor(H), Ym, Ym2, n_features=N)
    ref = jup.fold_in_w_update(jnp.asarray(W), jnp.asarray(H), jYm, jYm2, n_features=N,
                               precision=HIGHEST)
    _close(port, ref)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_duchi_projection(k):
    X = np.random.default_rng(k).normal(size=(k, 17))
    port = tproj.project_columns_simplex_duchi(torch.tensor(X))
    _close(port, jproj.project_columns_simplex_duchi(jnp.asarray(X)))
    np.testing.assert_allclose(port.sum(dim=0).numpy(), 1.0, atol=1e-12)
    _close(tproj.project_simplex_duchi(torch.tensor(X.T), dim=-1),
           jproj.project_simplex_duchi(jnp.asarray(X.T), axis=-1))
