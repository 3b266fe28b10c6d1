"""The frozen pieces against the program at tiny sizes on the CPU: the data
recipe against ``GroundTruth``, the mask draw, the init draw against the
solver's, and the plain reference, masked or not, against the port's plain
and fused loops."""

import hashlib

import numpy as np
import pytest
import torch

from portbench import compare, data, harness, reference
from portbench.tests.cells import tiny_cell

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


OBSERVED = 0.7


def test_mask_draw_does_not_depend_on_the_chunking():
    recipe = data.Recipe(CONFIG, SEED, "cpu")
    whole = recipe.mask(OBSERVED)
    assert whole.dtype == torch.uint8 and whole.shape == (300, 200)
    for a, b in ((0, 300), (5, 261), (100, 290), (256, 300)):
        assert torch.equal(whole[a:b].float(), recipe.mask_rows(a, b, OBSERVED))
    sigma = (OBSERVED * (1 - OBSERVED) / whole.numel()) ** 0.5
    assert abs(float(whole.float().mean()) - OBSERVED) < 4 * sigma


def test_mask_stream_is_apart_from_the_datas():
    recipe = data.Recipe(CONFIG, SEED, "cpu")
    blocks = range(-(-100_000 // data.RNG_ROWS))  # the flagship's rows
    seeds = {recipe.block_seed(b) for b in blocks}
    assert not seeds & {recipe.block_seed(b, data.MASK_STREAM) for b in blocks}
    assert 2 * data.MASK_STREAM < 1_000_003  # nor any other seed's blocks
    Y, M = recipe.binary().float(), recipe.mask(OBSERVED).float()
    assert torch.equal(recipe.binary(), data.Recipe(CONFIG, SEED, "cpu").binary())
    joint = float((Y * M).mean())  # independent draws: P(y = 1, observed) = P(y = 1) P(observed)
    assert abs(joint - float(Y.mean()) * float(M.mean())) < 0.02


@pytest.mark.parametrize("n_init", [1, 3])
def test_init_draw_is_the_solvers(n_init):
    from nbmf_mm_tpu_torch.solver import driver

    W0, H0 = reference.initial_factors(SEED, n_init, 30, 20, 4)
    W1, H1 = driver._random_uniform_inits(SEED, n_init, 30, 20, 4, torch.float32)
    assert torch.equal(W0, W1) and torch.equal(H0, H1)


def _reference(Y, n_init, seed, sweeps=25, mask=None, mask_mode=None):
    W0, H0 = reference.initial_factors(seed, n_init, *Y.shape, CONFIG["k"])
    rows = (lambda a, b: Y[a:b]) if mask is None else (lambda a, b: (Y[a:b], mask[a:b]))
    fit = reference.Fit(rows, *Y.shape, alpha=1.2, beta=1.2, eps=1e-8, device="cpu",
                        mask_mode=mask_mode)
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


@pytest.mark.parametrize("backend", ["plain", "fused"])
@pytest.mark.parametrize("mask_mode", ["corrected", "parity"])
def test_masked_reference_follows_the_ports_loops(backend, mask_mode):
    from nbmf_mm_tpu_torch import solve

    recipe = data.Recipe(CONFIG, SEED, "cpu")
    Y, M = recipe.binary(), recipe.mask(OBSERVED)  # uint8, as the harness hands them over
    res = solve(Y, 6, mask=M, mask_mode=mask_mode, max_iter=25, tol=0.0, random_state=SEED,
                backend=backend, device_results=True, device="cpu")
    W, H, L = _reference(Y.float(), 1, SEED, mask=M.float(), mask_mode=mask_mode)
    fit = {"W": res.W, "H": res.H, "losses": res.losses, "best": 0, "all_final": None}
    gaps = compare.gaps(fit, (W, H, L), {"fit_gap": 1e-5})
    assert gaps["fit_gap"] < 2e-6 and gaps["h_gap"] < 2e-6, gaps
    unmasked = _reference(Y.float(), 1, SEED)  # the mask moves the fit
    assert compare.gaps(fit, unmasked, {"fit_gap": 1e-5})["h_gap"] > 1e-2


@pytest.mark.parametrize("mask_mode", ["corrected", "parity"])
def test_all_ones_mask_is_the_unmasked_reference(mask_mode):
    Y = data.Recipe(CONFIG, SEED, "cpu").binary().float()
    masked = _reference(Y, 2, SEED, sweeps=10, mask=torch.ones_like(Y), mask_mode=mask_mode)
    for a, b in zip(masked, _reference(Y, 2, SEED, sweeps=10)):
        assert torch.equal(a, b)


# sha256 of the reference's (W, H, losses) bytes on each tiny cell, seed
# 2**31 + 101, fit 2**31 + 104, as the reference gave them before it took a
# mask: the unmasked reference still runs every operation in its old order.
PINNED = {
    "flagship_fit": "d9443a9b73a2c2091c653ed22926436b29e45dbcaf6a3b52138214eeeefa33cd",
    "headline_restarts16": "03056b6817a1bfa95b5acbe4e12ed514e6d12cb879aba5725c07dcd169ed3d34",
    "flagship_soft": "7e0bc7d0ce16546bfbef0614aab8e484317c99a11bbb4a79cdabf817e672bcfb",
}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_unmasked_reference_is_bitwise_as_pinned(workload):
    seed = 2**31 + 101
    out = harness.reference_fit(tiny_cell(workload), seed, seed + 3, torch.device("cpu"))
    digest = hashlib.sha256()
    for t in out:
        digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == PINNED[workload]


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
