"""The TF32 tensor-core (wgmma) form of the port's passes, checked without a
card.

``precision="high"`` (``_tf32r``) runs the H and W passes on Hopper's tensor
cores (``nbmf_mm_tpu_torch/ops/csrc/sweep_wgmma_tf32.cuh``).  wgmma reads a
TF32 operand from shared memory only K-major, so each call stages the
factors in both orders, and the phase-B copies store each group of 8
contracted indices in the order of the TF32 A fragment.  The kernels run
only on the card (``chip_smoke.py`` phase 10 holds them to their plain
versions); here:

- the plain version of the five TF32 copies (W^T in bit-plane order, W's
  phase-B copy, H^T, H's and 1 - H's phase-B copies) against
  ``tiers.round_tf32``/``tiers.complement`` and the bit-plane rows, bitwise,
  including a draw where ``round(1 - h)`` and ``round(1 - round(h))`` part;
- the fragment algebra of phase B in float64: phase A's accumulator entries,
  gathered by the m64nN accumulator map and placed by the m64nNk8.tf32
  A-fragment map, times the slot8-ordered copy equal ``P B^T`` exactly,
  and the same entries in accumulator order do not;
- the planned geometry (``wgmma_shape``): steps, stages and the shared
  memory of each pass at every rank, two blocks to an SM up to k = 128;
- the wrappers' dispatch through the stub library of
  ``test_torch_wgmma_staging.py``: lane-batched calls pass ``(R, ...)`` TF32
  copies, ``stage_tf32`` and ``tf32_occupancy`` reach their entry points
  with the arguments the C side reads.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_wgmma_staging import RANKS, _cuda, stub  # noqa: F401 (stub: the fixture)

from nbmf_mm_tpu_torch.ops import _build
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds
from nbmf_mm_tpu_torch.ops import tiers

SMEM_BLOCK_MAX = 232_448  # bytes one block may ask for on an H100
SMEM_SM = 233_472  # bytes of shared memory an SM holds; each block also reserves 1024
SHAPES = [(1000, 1234, 17, None), (300, 200, 200, 2), (20, 100, 8, None), (256, 64, 128, 3),
          (70, 130, 33, None)]


def _draw(k, Mp, Np, m, n, lead, seed, near_one=False):
    rng = np.random.default_rng(seed)
    W = np.zeros((*lead, k, Mp), np.float32)
    W[..., :m] = rng.uniform(0.0, 1.0, (*lead, k, m))
    H = np.zeros((*lead, k, Np), np.float32)
    if near_one:  # 1 - h and 1 - round(h) round apart
        H[..., :n] = 1.0 - 2.0 ** -12 * rng.integers(1, 64, (*lead, k, n)) - 2.0 ** -24
    else:
        H[..., :n] = rng.uniform(-0.3, 1.4, (*lead, k, n))
    return torch.tensor(W), torch.tensor(H)


# ----------------------------------------------------------- staging copies
@pytest.mark.parametrize("m,n,k,R", SHAPES)
def test_stage_tf32_plain_copies(m, n, k, R):
    bm, Mp, Np = cs.plan_packing(m, n)
    plan = cs.plan_wgmma(k, Mp, Np)
    lead = () if R is None else (R,)
    W, H = _draw(k, Mp, Np, m, n, lead, seed=m + k)
    wt, wk, ht, hk, hck = cs.stage_tf32_plain(W, H, bm, plan)
    for t, shape in ((wt, (plan.Mps, plan.kstage)), (wk, (plan.kstage, plan.Mps)),
                     (ht, (plan.Nps, plan.kstage)), (hk, (plan.kstage, plan.Nps)),
                     (hck, (plan.kstage, plan.Nps))):
        assert t.shape == (*lead, *shape) and t.dtype == torch.float32 and t.is_contiguous()
    w = tiers.round_tf32(W[..., cs.bitplane_rows(Mp, bm)])
    # phase A's copies: (row, k), zero beyond k and the real rows
    assert torch.equal(wt[..., :Mp, :k], w.transpose(-1, -2))
    assert torch.equal(ht[..., :Np, :k], tiers.round_tf32(H).transpose(-1, -2))
    assert not wt[..., Mp:, :].any() and not wt[..., k:].any()
    assert not ht[..., Np:, :].any() and not ht[..., k:].any()
    # phase B's copies: (k, row), each group of 8 columns in slot8 order
    order = cs.phase_b_order(plan.Mps)
    assert torch.equal(wk[..., :k, :], torch.nn.functional.pad(w, (0, plan.Mps - Mp))[..., order])
    order = cs.phase_b_order(plan.Nps)
    pad = (0, plan.Nps - Np)
    assert torch.equal(hk[..., :k, :],
                       torch.nn.functional.pad(tiers.round_tf32(H), pad)[..., order])
    assert torch.equal(hck[..., :k, :],
                       torch.nn.functional.pad(tiers.complement(H, "tf32r"), pad)[..., order])
    assert not wk[..., k:, :].any() and not hk[..., k:, :].any() and not hck[..., k:, :].any()
    # every staged value is TF32: the 13 low mantissa bits are clear
    for t in (wt, wk, ht, hk, hck):
        assert not (t.view(torch.int32) & 0x1FFF).any()


def test_stage_tf32_complement_rounds_the_f32_difference():
    m, n, k = 40, 64, 8
    bm, Mp, Np = cs.plan_packing(m, n)
    plan = cs.plan_wgmma(k, Mp, Np)
    W, H = _draw(k, Mp, Np, m, n, (), seed=5, near_one=True)
    *_, hck = cs.stage_tf32_plain(W, H, bm, plan)
    logical = hck[:k, cs.phase_b_order(plan.Nps).argsort()][:, :n]
    want = tiers.round_tf32(1.0 - H[:, :n])
    other = tiers.round_tf32(1.0 - tiers.round_tf32(H[:, :n]))
    assert torch.equal(logical, want)
    assert (logical != other).float().mean() > 0.5  # the rules part on this draw


def test_stage_tf32_on_cpu_is_the_plain_version_lane_by_lane():
    m, n, k, R = 100, 90, 40, 3
    bm, Mp, Np = cs.plan_packing(m, n)
    plan = cs.plan_wgmma(k, Mp, Np)
    W, H = _draw(k, Mp, Np, m, n, (R,), seed=2)
    batched = cs.stage_tf32(W, H, bm)
    for r in range(R):
        for got, want in zip(batched, cs.stage_tf32_plain(W[r], H[r], bm, plan)):
            assert torch.equal(got[r], want)


def test_phase_b_order():
    assert sorted(cs.SLOT8) == list(range(8))
    assert cs.SLOT8 == (0, 2, 4, 6, 1, 3, 5, 7)
    order = cs.phase_b_order(64)
    assert sorted(order.tolist()) == list(range(64))
    assert torch.equal(order // 8, torch.arange(64) // 8)  # within each group of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        cs.phase_b_order(12)


# ---------------------------------------------------------- fragment algebra
def _acc_map(t, i):
    """(M, N) of entry i of thread t in an m64nN f32 accumulator."""
    warp, lane = divmod(t, 32)
    return 16 * warp + lane // 4 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * (lane % 4) + (i & 1)


def _tf32_a_map(t, v):
    """(M, K within the k8 chunk) of register v of thread t in the A fragment
    of m64nNk8.tf32: rows r and r + 8, K indices t % 4 and t % 4 + 4."""
    warp, lane = divmod(t, 32)
    return 16 * warp + lane // 4 + 8 * (v & 1), lane % 4 + 4 * (v >> 1)


def _phase_b(D1, B_phys, regs_of_chunk):
    """A_phys B_phys^T with A_phys laid out from D1's accumulator registers,
    four per k8 chunk as ``regs_of_chunk(c)`` picks them (entries of the
    thread's accumulator)."""
    A = np.full((64, 32), np.nan)
    for t in range(128):
        d = [D1[_acc_map(t, i)] for i in range(16)]
        for c in range(4):
            for v, i in enumerate(regs_of_chunk(c)):
                r, kk = _tf32_a_map(t, v)
                assert np.isnan(A[r, 8 * c + kk])  # each position once
                A[r, 8 * c + kk] = d[i]
    assert not np.isnan(A).any()
    return A @ B_phys.T


@pytest.mark.parametrize("kn", [32, 64, 128])
def test_phase_b_fragment_algebra(kn):
    rng = np.random.default_rng(kn)
    D1 = rng.integers(-50, 50, (64, 32)).astype(np.float64)  # exact in float64 in any order
    B = rng.integers(-50, 50, (kn, 32)).astype(np.float64)
    want = D1 @ B.T
    order = cs.phase_b_order(32).numpy()
    got = _phase_b(D1, B[:, order], lambda c: (4 * c, 4 * c + 2, 4 * c + 1, 4 * c + 3))
    assert np.array_equal(got, want)
    # the accumulator order, which is the bf16 A fragment's, is not TF32's
    wrong = _phase_b(D1, B, lambda c: (4 * c, 4 * c + 1, 4 * c + 2, 4 * c + 3))
    assert not np.array_equal(wrong, want)


# ---------------------------------------------------------------- planning
@pytest.mark.parametrize("k", RANKS)
def test_wgmma_shape_tf32(k):
    plan = cs.plan_wgmma(k, 10_240, 10_000)
    shape = cs.wgmma_shape(k, "tf32r")
    assert (shape.step, shape.stages_a, shape.stages_b) == (32, 2, 1)
    phase_a = 4 * (64 + 2 * 32) * plan.kstage  # resident 64-row tile, two 32-row stages
    assert shape.h_smem == phase_a + 4 * plan.kn * 32 + 1024
    assert shape.w_smem == phase_a + 2 * 4 * plan.kn * 32 + 1024
    assert plan.kstage % 32 == 0  # whole 128-byte swizzle atoms of K
    assert shape.h_smem < shape.w_smem <= SMEM_BLOCK_MAX
    blocks = SMEM_SM // (shape.w_smem + 1024)  # the larger pass
    assert blocks >= (2 if k <= 128 else 1)
    # the bf16 launchers' sizes (sweep_wgmma.cuh)
    bf16 = cs.wgmma_shape(k, "bf16r")
    assert (bf16.step, bf16.stages_a, bf16.stages_b) == (64, 2, 0)
    assert (bf16.h_smem, bf16.w_smem) == (3 * plan.kstage * 128 + 1024,
                                          5 * plan.kstage * 128 + 1024)


def test_wgmma_shape_rejects_f32():
    with pytest.raises(ValueError, match="f32"):
        cs.wgmma_shape(64, "f32")


def test_headline_tf32_scratch():
    plan = cs.plan_wgmma(128, 10_240, 10_000)
    # one lane: W^T and W's phase-B copy, H^T and H's and 1 - H's
    assert 4 * plan.kstage * plan.Mps == 5_275_648
    assert 4 * plan.kstage * plan.Nps == 5_144_576
    assert cs.wgmma_shape(128, "tf32r")[3:] == (82_944, 99_328)


# ---------------------------------------------------------------- dispatch
def _operands(R, k, m=300, n=130):
    bm, Mp, Np = cs.plan_packing(m, n)
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.random((R, k, Mp)), dtype=torch.float32)
    H = torch.tensor(rng.random((R, k, Np)), dtype=torch.float32)
    Y = torch.tensor(rng.random((Mp, Np)) < 0.3, dtype=torch.float32)
    return W, H, Y, cs.pack_bits(Y, bm), bm, Mp, Np, m, n


@pytest.mark.parametrize("k", [20, 150])
def test_lanes_reach_the_tf32_entry_points_with_lane_copies(stub, k):
    R = 3
    W, H, Y, words, bm, Mp, Np, m, n = _operands(R, k)
    plan = cs.plan_wgmma(k, Mp, Np)
    W, H, Y, words = map(_cuda, (W, H, Y, words))
    kh = dict(eps=1e-8, m_real=m, n_real=n, bm=bm, precision="high")
    kw = dict(eps=1e-8, n_real=n, bm=bm, precision="high")
    calls = {"nbmf_hloss_terms_packed_tf32r": lambda: cs.hloss_terms_packed(W, H, words, **kh),
             "nbmf_w_terms_packed_tf32r": lambda: cs.w_terms_packed(W, H, words, **kw),
             "nbmf_hloss_terms_dense_tf32r": lambda: ds.hloss_terms(W, H, Y, **kh),
             "nbmf_w_terms_dense_tf32r": lambda: ds.w_terms(W, H, Y, **kw),
             "nbmf_loglik_sum_dense_tf32r": lambda: ds.loglik_sum(W, H, Y, **kh)}
    for entry, call in calls.items():
        stub.calls.clear()
        call()
        (name, args), = stub.calls
        assert name == entry and len(args) == len(_build._SIGNATURES[entry])
        copies = [stub.allocs[a][0] for a in args if isinstance(a, int) and a in stub.allocs
                  and len(stub.allocs[a][0]) == 3 and plan.kstage in stub.allocs[a][0][1:]]
        a_w, a_h = (R, plan.Mps, plan.kstage), (R, plan.Nps, plan.kstage)
        b_w, b_h = (R, plan.kstage, plan.Mps), (R, plan.kstage, plan.Nps)
        assert copies == ([a_w, a_h, b_h, b_h] if "w_terms" in entry else [a_w, b_w, a_h])
        assert args[-4] == R  # lanes, eps, device, stream


def test_stage_tf32_reaches_its_entry_point(stub):
    W, H, _, _, bm, Mp, Np, _, _ = _operands(2, 20)
    plan = cs.plan_wgmma(20, Mp, Np)
    copies = cs.stage_tf32(_cuda(W), _cuda(H), bm)
    (name, args), = stub.calls
    assert name == "nbmf_stage_tf32" and len(args) == len(_build._SIGNATURES[name])
    assert args[2:7] == tuple(t.data_ptr() for t in copies)
    assert args[7:13] == (20, Mp, Np, bm, 2, 0)
    assert [tuple(t.shape) for t in copies] == [
        (2, plan.Mps, plan.kstage), (2, plan.kstage, plan.Mps), (2, plan.Nps, plan.kstage),
        (2, plan.kstage, plan.Nps), (2, plan.kstage, plan.Nps)]


def test_tf32_occupancy_asks_every_instance(stub):
    out = cs.tf32_occupancy(ranks=(32, 256))
    passes = ("hloss_terms_packed", "w_terms_packed", "hloss_terms", "h_terms", "loglik_sum",
              "w_terms")
    assert set(out) == {(p, k, s) for p in passes for k in (32, 256) for s in (False, True)}
    assert len(stub.calls) == len(out)
    for name, args in stub.calls:
        assert len(args) == len(_build._SIGNATURES[name]) == 5
        index, k, second = args[:3]
        table = dict(cs._TF32_OCCUPANCY)[name]
        assert 0 <= index < len(table) and k in (32, 256) and second in (0, 1)
    # the two outputs are int pointers the C side writes
    assert all(isinstance(a, int) for _, args in stub.calls for a in args[3:])
    assert ctypes.sizeof(ctypes.c_int) == 4
