"""The frozen pieces against the program at tiny sizes on the CPU: the data
recipe against ``GroundTruth``, the init draw against the solver's, and the
plain reference against the port's plain and fused loops."""

import numpy as np
import pytest
import torch

from portbench import compare, data, reference

CONFIG = {"m": 300, "n": 200, "k": 6, "alpha": 1.2, "beta": 1.2, "eps": 1e-8,
          "data": {"kind": "ground_truth", "k_true": 3, "clip": 1e-6}}
SEED = 2**31 + 11  # past 32 signed bits, as the check's seeds are


def test_ground_truth_is_the_programs():
    from nbmf_mm_tpu_torch.experiments.flagship_scale import GroundTruth

    truth = GroundTruth(SEED, 300, 200, 3, "cpu")
    recipe = data.Recipe(CONFIG, SEED, "cpu")
    torch.testing.assert_close(recipe.W, truth.W, rtol=0, atol=0)
    torch.testing.assert_close(recipe.H, truth.H, rtol=0, atol=0)
    for a, b in ((0, 300), (5, 261), (256, 300)):
        Y, _ = truth.rows(a, b)
        assert torch.equal(recipe.binary_rows(a, b), Y)


def test_draw_does_not_depend_on_the_chunking():
    recipe = data.Recipe(CONFIG, SEED, "cpu")
    whole = recipe.binary()
    assert whole.dtype == torch.uint8 and whole.shape == (300, 200)
    assert torch.equal(whole[100:290].float(), recipe.binary_rows(100, 290))
    soft = recipe.soft()
    assert float(soft.min()) >= 1e-6 and float(soft.max()) <= 1 - 1e-6
    bern = data.Recipe(dict(CONFIG, data={"kind": "bernoulli", "density": 0.3}), 5, "cpu")
    assert abs(float(bern.binary().float().mean()) - 0.3) < 0.02


@pytest.mark.parametrize("n_init", [1, 3])
def test_init_draw_is_the_solvers(n_init):
    from nbmf_mm_tpu_torch.solver import driver

    W0, H0 = reference.initial_factors(SEED, n_init, 30, 20, 4)
    W1, H1 = driver._random_uniform_inits(SEED, n_init, 30, 20, 4, torch.float32)
    assert torch.equal(W0, W1) and torch.equal(H0, H1)


def _reference(Y, n_init, seed, sweeps=25):
    W0, H0 = reference.initial_factors(seed, n_init, *Y.shape, CONFIG["k"])
    fit = reference.Fit(lambda a, b: Y[a:b], *Y.shape, alpha=1.2, beta=1.2, eps=1e-8,
                        device="cpu")
    return fit.run(W0, H0, sweeps)


@pytest.mark.parametrize("backend", ["plain", "fused"])
@pytest.mark.parametrize("soft", [False, True])
def test_reference_follows_the_ports_loops(backend, soft):
    from nbmf_mm_tpu_torch import solve

    recipe = data.Recipe(CONFIG, SEED, "cpu")
    Y = recipe.soft() if soft else recipe.binary().float()
    res = solve(Y, 6, max_iter=25, tol=0.0, random_state=SEED, backend=backend,
                device_results=True, device="cpu")
    W, H, L = _reference(Y, 1, SEED)
    fit = {"W": res.W, "H": res.H, "losses": res.losses, "best": 0, "all_final": None}
    gaps = compare.gaps(fit, (W, H, L), {"fit_gap": 1e-5})
    assert gaps["fit_gap"] < 2e-6 and gaps["h_gap"] < 2e-6, gaps


def test_reference_lanes_follow_the_ports_restarts():
    from nbmf_mm_tpu_torch import solve

    Y = data.Recipe(CONFIG, SEED, "cpu").binary().float()
    res = solve(Y, 6, max_iter=25, tol=0.0, random_state=7, n_init=3, return_all=True,
                backend="fused", device_results=True, device="cpu")
    W, H, L = _reference(Y, 3, 7)
    np.testing.assert_allclose(res.extras["all_losses"], L.numpy(), rtol=2e-6)
    np.testing.assert_allclose(res.extras["all_W"], W.numpy(), atol=2e-6 * float(W.max()))
    fit = {"W": res.W, "H": res.H, "losses": res.losses, "best": res.best_restart,
           "all_final": res.all_final_losses}
    gaps = compare.gaps(fit, (W, H, L), {"fit_gap": 1e-5})
    assert max(gaps.values()) < 2e-6, gaps


def test_selection_takes_a_tie_either_way():
    final = np.array([1.0, 0.5, 0.5 + 1e-9, 0.7])
    assert compare.reference_lane(2, final, 1e-6) == 2
    assert compare.reference_lane(3, final, 1e-6) == 1
    assert compare.verdict({"a": float("nan")}, {"a": 1.0})[0] is False


def test_model_gap_is_blockwise_frobenius():
    g = torch.Generator().manual_seed(3)
    W, H = torch.rand((9000, 3), generator=g), torch.rand((3, 40), generator=g)
    W2 = W * (1 + 1e-3 * torch.rand((9000, 3), generator=g))
    want = float(torch.linalg.norm(W2.double() @ H.double() - W.double() @ H.double())
                 / torch.linalg.norm(W.double() @ H.double()))
    assert compare.model_gap(W2, H, W, H) == pytest.approx(want, rel=1e-9)
