"""``grid_solve`` on the port: every (alpha, beta) cell as a lane of one
batched solve, held against the JAX package's ``grid_solve`` on the CPU and
against the port's own standalone ``solve``.

Both packages' ``_random_uniform_inits`` are replaced by the same numpy
draws (each reads the function from its driver module at call time), since
torch generators cannot reproduce JAX ``PRNGKey`` draws.

Bars in float64: against the JAX grid (its ``jnp`` route): ``n_iter`` and
``converged`` equal, factors within 1e-9, losses within 1e-10; a cell against
the port's standalone ``solve`` with the same seed: bitwise on the plain
route (the batched plain functions run lane by lane), 1e-12 on the fused
route (``torch`` reduces the priors over a lane axis); ``packed=True``
against ``packed=False`` inside the port: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.parallel.grid import grid_solve as jax_grid_solve
from nbmf_mm_tpu.solver import driver as jd
from nbmf_mm_tpu_torch.parallel import grid_solve
from nbmf_mm_tpu_torch.solver import driver as pd

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="float64")
KEYS = ("alpha", "beta", "W", "H", "losses", "n_iter", "final_loss", "converged")


def _toy(m=30, n=24, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.fixture
def same_inits(monkeypatch):
    """Both packages draw the shared init from one numpy generator."""
    def draws(n_init, m, n, k):
        rng = np.random.default_rng(33)
        return rng.uniform(0.1, 0.9, (n_init, m, k)), rng.uniform(0.1, 0.9, (n_init, k, n))

    monkeypatch.setattr(jd, "_random_uniform_inits", lambda key, n_init, m, n, k, dtype: tuple(
        jnp.asarray(a, dtype=dtype) for a in draws(n_init, m, n, k)))
    monkeypatch.setattr(pd, "_random_uniform_inits", lambda seed, n_init, m, n, k, dtype: tuple(
        torch.tensor(a, dtype=dtype) for a in draws(n_init, m, n, k)))


def _assert_grids_match(res, ref):
    assert set(res) == set(ref) == set(KEYS)
    np.testing.assert_array_equal(res["alpha"], ref["alpha"])
    np.testing.assert_array_equal(res["beta"], ref["beta"])
    np.testing.assert_array_equal(res["n_iter"], ref["n_iter"])
    np.testing.assert_array_equal(res["converged"], ref["converged"])
    _close(res["W"], ref["W"], 1e-9)
    _close(res["H"], ref["H"], 1e-9)
    _close(res["final_loss"], ref["final_loss"], 1e-10)
    for g, it in enumerate(res["n_iter"]):  # JAX leaves entries past n_iter undefined
        _close(res["losses"][g, :it], ref["losses"][g, :it], 1e-10)


# --------------------------------------------------- against the JAX grid
@pytest.mark.usefixtures("same_inits")
@pytest.mark.parametrize("backend", ["plain", "fused"])
@pytest.mark.parametrize("projection", ["normalize", "duchi"])
def test_product_grid_matches_the_jax_grid(projection, backend):
    X = _toy()
    kw = dict(max_iter=60, tol=2e-3, random_state=7, projection=projection)
    ref = jax_grid_solve(X, 3, [0.5, 1.2, 2.0], [1.0, 3.0], backend="jnp", dtype="float64", **kw)
    res = grid_solve(X, 3, [0.5, 1.2, 2.0], [1.0, 3.0], backend=backend, **kw, **CPU)
    assert res["W"].shape == (6, 30, 3) and res["H"].shape == (6, 3, 24)
    assert res["losses"].shape == (6, 60)
    _assert_grids_match(res, ref)
    assert len(set(res["n_iter"].tolist())) > 1  # cells froze at different sweeps


@pytest.mark.usefixtures("same_inits")
@pytest.mark.parametrize("backend", ["plain", "fused"])
@pytest.mark.parametrize("mask_mode", ["parity", "corrected"])
def test_zip_grid_under_a_mask_matches_the_jax_grid(mask_mode, backend):
    X = _toy(seed=2)
    mask = (np.random.default_rng(1).random(X.shape) < 0.85).astype(float)
    kw = dict(pair_mode="zip", max_iter=30, mask=mask, mask_mode=mask_mode)
    ref = jax_grid_solve(X, 3, [1.0, 2.0], [1.5, 2.5], backend="jnp", dtype="float64", **kw)
    res = grid_solve(X, 3, [1.0, 2.0], [1.5, 2.5], backend=backend, **kw, **CPU)
    assert res["W"].shape[0] == 2 and np.all(np.isfinite(res["final_loss"]))
    _assert_grids_match(res, ref)


# ------------------------------- each cell against the port's own solve
@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_grid_cells_equal_standalone_solves_with_the_same_seed(backend):
    X = _toy()
    alphas, betas = [0.5, 2.0], [1.0, 3.0]
    res = grid_solve(X, 3, alphas, betas, max_iter=40, random_state=7, backend=backend, **CPU)
    assert res["W"].shape == (4, 30, 3) and res["losses"].shape == (4, 40)
    for g in range(4):
        hist = res["losses"][g][: res["n_iter"][g]]
        assert np.all(np.diff(hist) <= 1e-12)
    for g, (a, b) in enumerate([(a, b) for a in alphas for b in betas]):
        single = port.solve(X, 3, alpha=a, beta=b, max_iter=40, random_state=7, backend=backend,
                            **CPU)
        assert res["n_iter"][g] == single.n_iter
        assert bool(res["converged"][g]) == single.converged
        if backend == "plain":
            np.testing.assert_array_equal(res["H"][g], single.H)
            np.testing.assert_array_equal(res["losses"][g][: single.n_iter], single.losses)
        else:
            _close(res["H"][g], single.H, 1e-12)
            _close(res["losses"][g][: single.n_iter], single.losses, 1e-12)
        # solve's final safeguard may renormalize W by a last bit
        _close(res["W"][g], single.W, 1e-12)
        assert not res["losses"][g][single.n_iter:].any()


def test_float32_fused_grid_cells_follow_the_standalone_solve():
    """float32, where per-lane ``alpha - 1`` must be the number a float
    argument gives: cells within 1e-6 of the standalone fused solves."""
    X = _toy(seed=8).astype(np.float32)
    kw = dict(max_iter=25, tol=0.0, random_state=3, backend="fused", dtype="float32",
              device="cpu")
    res = grid_solve(X, 3, [0.5, 1.2, 3.0], [1.2, 2.5, 0.7], pair_mode="zip", **kw)
    assert res["W"].dtype == res["losses"].dtype == np.float32
    for g, (a, b) in enumerate(zip([0.5, 1.2, 3.0], [1.2, 2.5, 0.7])):
        single = port.solve(X, 3, alpha=a, beta=b, **kw)
        np.testing.assert_allclose(res["losses"][g], single.losses, rtol=1e-6)
        np.testing.assert_allclose(res["H"][g], single.H, atol=1e-6)


# ------------------------------------------------------ the packed contract
def test_grid_solve_packed_contract():
    X = _toy(seed=4).astype(np.float32)
    Xc = X.copy()
    Xc[0, 0] = 0.5  # valid input, not exactly binary
    kw = dict(backend="fused", max_iter=20, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="packed=True requires"):
        grid_solve(Xc, 3, [1.0], [1.0], packed=True, **kw)
    with pytest.raises(ValueError, match="packed=True requires the fused loop"):
        grid_solve(X, 3, [1.0], [1.0], packed=True, backend="plain", max_iter=20, device="cpu")
    a = grid_solve(X, 3, [1.0, 2.0], [1.5], packed=False, **kw)
    b = grid_solve(X, 3, [1.0, 2.0], [1.5], packed=True, **kw)
    c = grid_solve(X, 3, [1.0, 2.0], [1.5], **kw)
    for other in (b, c):
        np.testing.assert_array_equal(a["W"], other["W"])
        np.testing.assert_array_equal(a["losses"], other["losses"])
    dense = grid_solve(Xc, 3, [1.0, 2.0], [1.5], **kw)  # continuous data streams dense
    assert np.isfinite(dense["final_loss"]).all()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_packed_and_dense_grids_are_bitwise_equal_under_a_mask(masked):
    X = _toy(m=300, n=70, seed=5).astype(np.float32)  # a shape the JAX planner rejects
    mask = (np.random.default_rng(2).random(X.shape) < 0.8).astype(np.float32) if masked else None
    kw = dict(mask=mask, mask_mode="corrected", max_iter=8, tol=0.0, backend="fused",
              dtype="float32", device="cpu")
    a = grid_solve(X, 4, [0.8, 1.6], [1.2, 2.4], packed=False, **kw)
    b = grid_solve(X, 4, [0.8, 1.6], [1.2, 2.4], packed=True, **kw)
    for key in KEYS:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_sparse_input_densifies_to_the_dense_grid():
    X = _toy(seed=6)
    mask = (np.random.default_rng(3).random(X.shape) < 0.9).astype(float)
    kw = dict(max_iter=15, backend="plain", **CPU)
    dense = grid_solve(X, 3, [1.0, 2.0], [1.5], mask=mask, **kw)
    sparse = grid_solve(sp.csr_matrix(X), 3, [1.0, 2.0], [1.5], mask=sp.csr_matrix(mask), **kw)
    for key in KEYS:
        np.testing.assert_array_equal(dense[key], sparse[key], err_msg=key)


def test_random_state_none_is_seed_zero_as_in_the_jax_grid():
    X = _toy()
    a = grid_solve(X, 3, [1.0], [1.0], max_iter=5, random_state=None, **CPU)
    b = grid_solve(X, 3, [1.0], [1.0], max_iter=5, random_state=0, **CPU)
    np.testing.assert_array_equal(a["W"], b["W"])


# ------------------------------------------- twins of the JAX error tests
def test_grid_solve_rejects_bad_projection():
    with pytest.raises(ValueError, match="projection"):
        grid_solve(_toy(), 3, [1.0], [1.0], projection="normalise", device="cpu")


def test_grid_solve_rejects_unequal_zip_lengths_and_a_bad_pair_mode():
    with pytest.raises(ValueError, match="zip pair_mode requires len"):
        grid_solve(_toy(), 3, [1.0], [1.0, 2.0], pair_mode="zip", device="cpu")
    with pytest.raises(ValueError, match="unknown pair_mode: 'outer'"):
        grid_solve(_toy(), 3, [1.0], [1.0], pair_mode="outer", device="cpu")
    with pytest.raises(ValueError, match="zip"):
        jax_grid_solve(_toy(), 3, [1.0], [1.0, 2.0], pair_mode="zip")
    with pytest.raises(ValueError, match="unknown pair_mode"):
        jax_grid_solve(_toy(), 3, [1.0], [1.0], pair_mode="outer")


@pytest.mark.parametrize("kwargs, exc, match", [
    # Ported since: the bf16-data mode and the reduced tiers run their grid.
    (dict(dtype="bfloat16"), None, "default"),
    (dict(precision="default"), None, "default"),
    (dict(precision="high"), None, "high"),
    (dict(mask_mode="both"), ValueError, "mask_mode"),
    (dict(max_iter=0), ValueError, "max_iter"),
    (dict(backend="xla"), ValueError, "backend"),  # "pallas" names the fused loop
    (dict(mask=np.zeros((30, 24))), ValueError, "no observed entries"),
], ids=["bfloat16", "precision-default", "precision-high", "mask_mode", "max_iter-0",
        "backend", "empty-mask"])
def test_grid_solve_rejects_what_it_does_not_take(kwargs, exc, match, monkeypatch):
    if exc is None:
        tiers_run = []
        core = pd._solve_core_fused
        monkeypatch.setattr(pd, "_solve_core_fused", lambda *a, **kw: (
            tiers_run.append(kw["mxu_precision"]), core(*a, **kw))[1])
        g = grid_solve(_toy(), 3, [1.0], [1.0], max_iter=5, backend="fused",
                       **{"device": "cpu", **kwargs})
        assert tiers_run == [match] and np.isfinite(g["final_loss"]).all()
        return
    with pytest.raises(exc, match=match):
        grid_solve(_toy(), 3, [1.0], [1.0], **{"device": "cpu", **kwargs})


def test_grid_solve_rejects_an_empty_grid_and_2d_hyperparameters():
    with pytest.raises(ValueError, match="cells"):
        grid_solve(_toy(), 3, [], [1.0], device="cpu")
    with pytest.raises(ValueError, match="cells"):
        grid_solve(_toy(), 3, [[1.0, 2.0]], [[1.0, 2.0]], pair_mode="zip", device="cpu")


def test_grid_solve_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the GPU-less contract")
    with pytest.raises(RuntimeError, match="cuda"):
        grid_solve(_toy(), 3, [1.0], [1.0], max_iter=2)


def test_grid_solve_restores_the_tf32_switches():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        grid_solve(_toy(), 3, [1.0], [1.0], max_iter=2, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
