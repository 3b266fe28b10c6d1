"""Rank above 128 (the kernels' ``TK = 16`` instances, up to ``MAX_RANK =
256``) with restart lanes, and the per-pass spans, on the CPU.

- A 4-lane rank-256 fit of a seeded Bernoulli(0.3) matrix through the fused
  loop, from dense input and from its packed words, against the plain
  reference of the benchmark (``portbench.reference``) from the same inits,
  under the bars of the benchmark's restarts test.
- k = 129, 200 and 256 through the fused loop against the plain loop.
- The spans: one ``nbmf_mm.hpass`` a pass over all lanes and one
  ``nbmf_mm.wpass``, with the packed fill's H pass one more.

The ``cuda`` cases run the 16-lane rank-256 fit on the card's kernels, and
16-lane fits at ranks 128 and 256 with the warp-specialised H pass's launch
counter read, and skip here; on a machine with a card:

    python3 -m pytest tests/test_torch_rank256.py -m cuda --confcutdir=tests -p no:cacheprovider
"""

import json

import numpy as np
import pytest
import torch

from nbmf_mm_tpu_torch import pack_matrix, solve
from nbmf_mm_tpu_torch.utils import profiling
from portbench import compare, data, manifest, reference

SEED = 2**31 + 256
CONFIG = {"m": 320, "n": 288, "k": 256, "data": {"kind": "bernoulli", "density": 0.3}}
LIMITS = {"fit_gap": 1e-5}  # the tie margin of the lane selection
BAR = 2e-6  # portbench's test_reference_lanes_follow_the_ports_restarts


def _binary(m: int, n: int, seed: int = SEED) -> torch.Tensor:
    return data.Recipe(dict(CONFIG, m=m, n=n), seed, "cpu").binary().to(torch.float32)


def _reference(Y: torch.Tensor, k: int, n_init: int, seed: int, sweeps: int, device="cpu"):
    W0, H0 = reference.initial_factors(seed, n_init, *Y.shape, k)
    fit = reference.Fit(lambda a, b: Y[a:b].to(device), *Y.shape, alpha=1.2, beta=1.2,
                        eps=1e-8, device=device)
    return fit.run(W0, H0, sweeps)


def _gaps(res, ref) -> dict:
    fit = {"W": res.W, "H": res.H, "losses": res.losses, "best": res.best_restart,
           "all_final": res.all_final_losses}
    return compare.gaps(fit, ref, LIMITS)


@pytest.fixture(scope="module")
def rank256():
    Y = _binary(CONFIG["m"], CONFIG["n"])
    return Y, _reference(Y, 256, 4, SEED, 25)


@pytest.mark.parametrize("form", ["dense", "packed"])
def test_rank256_restarts_follow_the_reference(rank256, form):
    Y, ref = rank256
    X = Y if form == "dense" else pack_matrix(Y, 256, device="cpu")
    res = solve(X, 256, n_init=4, backend="fused", device="cpu", max_iter=25, tol=0.0,
                random_state=SEED, return_all=True, device_results=True)
    assert res.W.shape == (320, 256) and res.H.shape == (256, 288)
    np.testing.assert_allclose(res.extras["all_losses"], ref[2].numpy(), rtol=BAR)
    gaps = _gaps(res, ref)
    assert max(gaps.values()) < BAR, gaps


@pytest.mark.parametrize("k", [129, 200, 256])
def test_fused_loop_follows_the_plain_loop_above_rank_128(k):
    Y = _binary(96, 72, SEED + k)
    kw = dict(n_init=2, max_iter=10, tol=0.0, random_state=k, device="cpu")
    fused = solve(Y, k, backend="fused", **kw)
    plain = solve(Y, k, backend="plain", **kw)
    assert fused.n_iter == plain.n_iter == 10
    np.testing.assert_allclose(fused.losses, plain.losses, rtol=1e-5)
    np.testing.assert_allclose(fused.all_final_losses, plain.all_final_losses, rtol=1e-5)
    np.testing.assert_allclose(fused.H, plain.H, atol=1e-4)
    np.testing.assert_allclose(fused.W, plain.W, atol=1e-4 * float(np.abs(plain.W).max()))


SWEEPS = 100
# (backend, packed input): the H-pass and W-pass spans of one fit.
PASSES = {("fused", True): (SWEEPS + 1, SWEEPS),  # the packed fill is an H pass
          ("fused", False): (SWEEPS, SWEEPS),  # the dense fill is loglik_sum
          ("plain", False): (SWEEPS, SWEEPS)}


@pytest.mark.parametrize("backend, packed", sorted(PASSES))
def test_one_span_a_pass_over_all_lanes(tmp_path, backend, packed):
    Y = _binary(40, 24)
    if packed:
        X = pack_matrix(Y, 3, device="cpu")
    else:  # [0, 1] data takes the fused loop's dense kernels
        X = Y if backend == "plain" else Y * 0.5 + 0.25
    with profiling.trace(str(tmp_path)):
        res = solve(X, 3, n_init=3, backend=backend, device="cpu", max_iter=SWEEPS, tol=0.0,
                    random_state=1)
    assert res.n_iter == SWEEPS
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert (names.count("nbmf_mm.hpass"), names.count("nbmf_mm.wpass")) == PASSES[backend, packed]
    assert names.count("nbmf_mm.sweep") == SWEEPS


def test_pass_spans_are_the_shared_no_op_untraced():
    assert profiling.span("nbmf_mm.hpass") is profiling.span("nbmf_mm.wpass") is profiling._OFF


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TK = 16 kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sixteen_lanes_at_rank_256_on_the_card_follow_the_reference(card):
    Y = _binary(2048, 1536)
    with data.ieee_fp32():
        res = solve(pack_matrix(Y.to(card), 256, device=card), 256, n_init=16, backend="fused", device=card,
                    max_iter=25, tol=0.0, random_state=SEED, return_all=True,
                    device_results=True)
        ref = _reference(Y, 256, 16, SEED, 25, device=card)
    limits = manifest.load_cell("headline_k256_restarts16").limits  # the cell's own
    correct, checks = compare.verdict(_gaps(res, ref), limits)
    assert correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("k, engaged", [(128, False), (256, True)])
def test_warp_specialised_h_pass_runs_above_rank_128_on_the_card(card, k, engaged):
    """A 16-lane fit at rank 256 launches the warp-specialised H pass (its
    counter rises by a launch a sweep and one for the fill); one at rank 128
    never does."""
    from nbmf_mm_tpu_torch.ops import cuda_sweep as cs

    Y = _binary(512, 384)
    before = cs.H_WS_LAUNCHES["hloss_terms_packed"]
    solve(pack_matrix(Y.to(card), 256, device=card), k, n_init=16, backend="fused", device=card,
          max_iter=5, tol=0.0, random_state=SEED, device_results=True)
    launched = cs.H_WS_LAUNCHES["hloss_terms_packed"] - before
    assert (launched > 0) is engaged, launched
