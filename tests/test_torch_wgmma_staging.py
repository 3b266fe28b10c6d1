"""The tensor-core (wgmma) forms of the port's passes, checked without a card.

The bf16 forms of the H and W passes (precision ``"default"``, ``_bf16r``,
and the bf16-data mode, ``_bf16d``) run on Hopper's tensor cores
(``nbmf_mm_tpu_torch/ops/csrc/sweep_wgmma.cuh``).  The kernels themselves run
only on the card (``chip_smoke.py`` phase 10 holds them to their plain
versions); here:

- the plain versions of the bf16 copies the kernels stage (W in bit-plane
  order, H, the W pass's ``1 - h`` under both rules) against
  ``tiers.mxu_round``/``tiers.complement`` and against the JAX package's own
  casts (``astype(bfloat16)`` of the f32 value, and ``1.0 - h`` in bf16
  arithmetic as its W-pass kernel forms it on bf16 data), bitwise, including
  a draw with ``h`` just above ``2^-9`` where the two rules part;
- the launch planning as pure Python: ``plan_wgmma``'s widths and padding for
  every rank, the step walks of both passes over the row and column splits
  (each word row and column is covered once, the ragged last step is masked,
  every tile a step reads lies inside the padded copies), grid and scratch
  sizes at the headline, and at every shape of ``chip_smoke.W_EDGES`` and
  ``H_EDGES``;
- the wrappers' dispatch through a stub library that records each call: each
  of the ten bf16 forms reaches its entry point with the bf16 copies as
  scratch, the TF32 and float32 forms reach theirs with the old arguments;
- a CUDA request without a card raises;
- the plain versions' ``WH`` (``tiers.wh_product``): the fp32 matmul on the
  CPU, one bf16 GEMM with fp32 output on the card for the bf16 forms only.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu_torch.ops import _build
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds
from nbmf_mm_tpu_torch.ops import tiers

RANKS = (1, 8, 16, 17, 32, 33, 64, 65, 100, 128, 129, 200, 256)
N_SM = 132  # an H100's SMs; the planners take any count


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _jax_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


def _draw(k, Mp, Np, m, n, seed, small_h=False):
    rng = np.random.default_rng(seed)
    W = np.zeros((k, Mp), np.float32)
    W[:, :m] = rng.uniform(0.0, 1.0, (k, m))
    H = np.zeros((k, Np), np.float32)
    if small_h:  # just above 2^-9: round(1 - h) and round(1 - round(h)) part
        H[:, :n] = 2.0 ** -9 + 2.0 ** -18 * rng.integers(1, 3, (k, n))
    else:
        H[:, :n] = rng.uniform(-0.2, 1.2, (k, n))
    return W, H


# ----------------------------------------------------------- staging copies
@pytest.mark.parametrize("m,n,k", [(1000, 1234, 17), (300, 200, 200), (20, 100, 8),
                                   (256, 64, 128)])
def test_stage_w_is_rounded_bitplane_w(m, n, k):
    bm, Mp, Np = cs.plan_packing(m, n)
    plan = cs.plan_wgmma(k, Mp, Np)
    W, _ = _draw(k, Mp, Np, m, n, seed=m + k)
    got = cs.stage_w_bf16_plain(torch.tensor(W), bm, plan)
    assert got.shape == (plan.kstage, plan.Mps) and got.dtype == torch.bfloat16
    perm = cs.bitplane_rows(Mp, bm).numpy()
    want = tiers.mxu_round(torch.tensor(W[:, perm]), "bf16r").to(torch.bfloat16)
    assert np.array_equal(_bits(got[:k, :Mp]), _bits(want))
    assert np.array_equal(_bits(got[:k, :Mp]), _jax_bits(jnp.asarray(W[:, perm]).astype(jnp.bfloat16)))
    assert not got[k:].any() and not got[:, Mp:].any()


@pytest.mark.parametrize("draw", ["random", "small-h"])
@pytest.mark.parametrize("form", cs.WGMMA_FORMS)
def test_stage_h_and_complement(form, draw):
    m, n, k = 70, 130, 33
    bm, Mp, Np = cs.plan_packing(m, n)
    plan = cs.plan_wgmma(k, Mp, Np)
    _, H = _draw(k, Mp, Np, m, n, seed=3, small_h=draw == "small-h")
    Ht = torch.tensor(H)
    h = cs.stage_h_bf16_plain(Ht, plan)
    hc = cs.stage_h_bf16_plain(Ht, plan, form)
    for t in (h, hc):
        assert t.shape == (plan.kstage, plan.Nps) and t.dtype == torch.bfloat16
        assert not t[k:].any() and not t[:, Np:].any()
    assert np.array_equal(_bits(h[:k, :Np]), _bits(tiers.mxu_round(Ht, form).to(torch.bfloat16)))
    assert np.array_equal(_bits(h[:k, :Np]), _jax_bits(jnp.asarray(H).astype(jnp.bfloat16)))
    assert np.array_equal(_bits(hc[:k, :Np]), _bits(tiers.complement(Ht, form).to(torch.bfloat16)))
    if form == "bf16d":  # the JAX kernel on bf16 data: 1.0 - h in bf16 arithmetic
        ref = 1.0 - jnp.asarray(H).astype(jnp.bfloat16)
    else:  # DEFAULT over f32 data: the MXU rounds the f32 difference
        ref = (1.0 - jnp.asarray(H)).astype(jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    assert np.array_equal(_bits(hc[:k, :Np]), _jax_bits(ref))
    if draw == "small-h":  # the two rules part on every real entry here
        other = cs.stage_h_bf16_plain(Ht, plan, "bf16r" if form == "bf16d" else "bf16d")
        assert (_bits(hc[:k, :n]) != _bits(other[:k, :n])).all()


def test_stage_bf16_on_cpu_is_the_plain_versions_lane_by_lane():
    m, n, k, R = 100, 90, 40, 3
    bm, Mp, Np = cs.plan_packing(m, n)
    plan = cs.plan_wgmma(k, Mp, Np)
    draws = [_draw(k, Mp, Np, m, n, seed=r) for r in range(R)]
    W = torch.tensor(np.stack([w for w, _ in draws]))
    H = torch.tensor(np.stack([h for _, h in draws]))
    for form in cs.WGMMA_FORMS:
        wst, hst, hcst = cs.stage_bf16(W, H, bm, form)
        assert wst.shape == (R, plan.kstage, plan.Mps) and hst.shape == (R, plan.kstage, plan.Nps)
        for r in range(R):
            assert torch.equal(wst[r], cs.stage_w_bf16_plain(W[r], bm, plan))
            assert torch.equal(hst[r], cs.stage_h_bf16_plain(H[r], plan))
            assert torch.equal(hcst[r], cs.stage_h_bf16_plain(H[r], plan, form))
    with pytest.raises(ValueError, match="form"):
        cs.stage_bf16(W, H, bm, "tf32r")


# ---------------------------------------------------------------- planning
@pytest.mark.parametrize("k", RANKS)
def test_plan_wgmma_widths(k):
    plan = cs.plan_wgmma(k, 10_240, 10_000)
    assert plan.kn in (32, 64, 128) and plan.kstage == plan.kn * plan.nkb >= k
    assert plan.kstage % 16 == 0  # whole k16 steps of phase A
    assert plan.nkb == (1 if k <= 128 else 2)
    # the narrowest width that holds k: no block computes a whole empty width
    assert plan.kn == 32 or plan.kn // 2 < k
    assert (plan.nkb - 1) * plan.kn < k
    # -(-k // 16) k16 steps of phase A read only staged rows
    assert 16 * -(-k // 16) <= plan.kstage


@pytest.mark.parametrize("bad", [0, 257])
def test_plan_wgmma_rejects_ranks(bad):
    with pytest.raises(ValueError, match="k"):
        cs.plan_wgmma(bad, 256, 64)


def _h_steps(w_begin, w_end):
    """The H pass's walk of one chunk of word rows: (word row, second word
    row valid) per step of two word rows, as hpass_wgmma_kernel takes it."""
    return [(w, w + 1 < w_end) for w in range(w_begin, w_end, 2)]


def _w_steps(c_begin, c_end):
    """The W pass's walk of one column chunk: (first column, valid columns)
    per step of 64, as wpass_wgmma_kernel takes it."""
    return [(c, min(64, c_end - c)) for c in range(c_begin, c_end, 64)]


def _shapes():
    edges = [(label, m, n, k) for label, (m, n), k in (*chip_smoke.W_EDGES, *chip_smoke.H_EDGES)]
    h = chip_smoke.HEADLINE
    return [("headline", h["m"], h["n"], h["k"]), ("lastfm", 1226, 285, 8),
            ("one word row", 32, 40, 4), *edges]


@pytest.mark.parametrize("label,m,n,k", _shapes())
def test_step_walks_cover_each_row_and_column_once(label, m, n, k):
    bm, Mp, Np = cs.plan_packing(m, n)
    plan = cs.plan_wgmma(k, Mp, Np)
    Mw = Mp // 32
    # H pass: chunks of word rows, steps of two; the masked second word row
    # of a ragged step is never counted, and every W slice read lies in the
    # copy (columns 32 w .. 32 w + 63 of Mps).
    hs = cs.plan_h_split(Mp, Np, k, N_SM)
    seen = []
    for w_begin, w_end in hs.chunks:
        for w, second in _h_steps(w_begin, w_end):
            assert 32 * w + 64 <= plan.Mps
            seen += [w, w + 1] if second else [w]
    assert seen == list(range(Mw))
    # W pass: column chunks of whole 32-column tiles, steps of 64 columns;
    # every H tile read lies in the copy and every W block in Mps.
    ws = cs.plan_w_split(Mp, Np, k, N_SM)
    cols = []
    for c_begin, c_end in ws.chunks:
        for c, valid in _w_steps(c_begin, c_end):
            assert c % 32 == 0 and 0 < valid <= 64 and c + 64 <= plan.Nps
            cols += range(c, c + valid)
    assert cols == list(range(Np))
    assert 64 * (-(-Mw // 2)) <= plan.Mps
    # the H pass's column blocks read H tiles inside the copy
    assert 64 * (-(-Np // 64)) <= plan.Nps


def test_headline_grids_and_scratch():
    h = chip_smoke.HEADLINE
    bm, Mp, Np = cs.plan_packing(h["m"], h["n"])
    assert (bm, Mp, Np) == (256, 10_240, 10_000)
    plan = cs.plan_wgmma(h["k"], Mp, Np)
    assert plan == cs.WgmmaPlan(kn=128, nkb=1, kstage=128, Mps=10_304, Nps=10_048)
    hs, ws = cs.plan_h_split(Mp, Np, 128, N_SM), cs.plan_w_split(Mp, Np, 128, N_SM)
    # grid x of the H pass: 64-column blocks times the k blocks; of the W
    # pass: two-word-row blocks times the k blocks
    assert -(-Np // 64) * plan.nkb == 157 and (Mp // 32 + 1) // 2 * plan.nkb == 160
    assert hs.blocks == 157 * hs.nsplit and ws.blocks == 160 * ws.nsplit
    # scratch of one lane: the bf16 copies (W, H, and 1 - H for the W pass)
    assert 2 * plan.kstage * plan.Mps == 2_637_824
    assert 2 * plan.kstage * plan.Nps == 2_572_288
    # shared memory a block asks for (sweep_wgmma.cuh's launchers): the
    # resident tile and two stages of the streamed one(s), plus alignment
    assert 3 * plan.kstage * 128 + 1024 <= 227 * 1024
    assert 5 * cs.plan_wgmma(256, Mp, Np).kstage * 128 + 1024 <= 227 * 1024


# ---------------------------------------------------------------- dispatch
class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card, so the wrappers take their
    kernel route into the stub library."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return None if t is None else t.as_subclass(_FakeCuda)


class _StubLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("nbmf_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def stub(monkeypatch):
    """The kernel library replaced by a recorder; allocations on the CPU,
    recorded by their pointers."""
    lib = _StubLibrary()
    allocs = {}
    real_empty = torch.empty

    def empty(*shape, dtype=None, device=None, **kw):
        t = real_empty(*shape, dtype=dtype)
        allocs[t.data_ptr()] = (tuple(t.shape), t.dtype, t)
        return t

    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=N_SM))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    lib.allocs = allocs
    return lib


def _operands(R=None, k=40, m=300, n=130):
    bm, Mp, Np = cs.plan_packing(m, n)
    rng = np.random.default_rng(0)
    lead = () if R is None else (R,)
    W = torch.tensor(rng.random((*lead, k, Mp)), dtype=torch.float32)
    H = torch.tensor(rng.random((*lead, k, Np)), dtype=torch.float32)
    Y = torch.tensor(rng.random((Mp, Np)) < 0.3, dtype=torch.float32)
    return dict(W=W, H=H, Y=Y, words=cs.pack_bits(Y, bm), bm=bm, Mp=Mp, Np=Np, k=k, m=m, n=n)


def _calls(o, form):
    """Each wrapper under ``form`` on fake-CUDA operands: {counter name: call}."""
    prec = chip_smoke.FORM_PRECISION.get(form)
    Ym = o["Y"].to(torch.bfloat16) if form == "bf16d" else o["Y"]
    W, H, Y, words, bm = _cuda(o["W"]), _cuda(o["H"]), _cuda(Ym), _cuda(o["words"]), o["bm"]
    kh = dict(eps=1e-8, m_real=o["m"], n_real=o["n"], bm=bm, precision=prec)
    kw = dict(eps=1e-8, n_real=o["n"], bm=bm, precision=prec)
    end = tiers.suffix(form)
    calls = {f"hloss_terms{end}": lambda: ds.hloss_terms(W, H, Y, **kh),
             f"w_terms{end}": lambda: ds.w_terms(W, H, Y, **kw),
             f"loglik_sum{end}": lambda: ds.loglik_sum(W, H, Y, **kh),
             f"h_terms{end}": lambda: ds.h_terms(W, H, Y, eps=1e-8, bm=bm, precision=prec)}
    if form != "bf16d":
        calls[f"hloss_terms_packed{end}"] = lambda: cs.hloss_terms_packed(W, H, words, **kh)
        calls[f"w_terms_packed{end}"] = lambda: cs.w_terms_packed(W, H, words, **kw)
    return calls


def _entry(name):
    base = name.rsplit("_", 1)
    if name.endswith(("_bf16r", "_bf16d", "_tf32r")):
        stem, form = base
        return f"nbmf_{stem}_{form}" if stem.endswith("_packed") else f"nbmf_{stem}_dense_{form}"
    return f"nbmf_{name}" if name.endswith("_packed") else f"nbmf_{name}_dense"


@pytest.mark.parametrize("form", ["bf16r", "bf16d", "tf32r", "f32"])
def test_wrappers_reach_their_entry_points_with_their_scratch(stub, form):
    o = _operands()
    k, Mp, Np = o["k"], o["Mp"], o["Np"]
    plan = cs.plan_wgmma(k, Mp, Np)
    before = {**cs.LAUNCHES, **ds.LAUNCHES}
    calls = _calls(o, form)
    assert len(calls) == (4 if form == "bf16d" else 6)
    for name, call in calls.items():
        stub.calls.clear()
        call()
        entry = _entry(name)
        assert [c[0] for c in stub.calls] == [entry]
        args = stub.calls[0][1]
        assert len(args) == len(_build._SIGNATURES[entry])
        counters = cs.LAUNCHES if name in cs.LAUNCHES else ds.LAUNCHES
        assert counters[name] == before[name] + 1
        shapes = [stub.allocs[a][:2] for a in args if isinstance(a, int) and a in stub.allocs]
        bf16 = [s for s in shapes if s[1] == torch.bfloat16]
        if form in cs.WGMMA_FORMS:
            want = [((1, plan.kstage, plan.Mps), torch.bfloat16),
                    ((1, plan.kstage, plan.Nps), torch.bfloat16)]
            if name.startswith("w_terms"):
                want.append(((1, plan.kstage, plan.Nps), torch.bfloat16))
            assert bf16 == want
            assert ((1, k, Mp), torch.float32) not in shapes  # no f32 bit-plane copy
        elif form in cs.TF32_FORMS:  # the TF32 copies in both orders, in argument order
            assert not bf16
            a_copy = {"W": (1, plan.Mps, plan.kstage), "H": (1, plan.Nps, plan.kstage)}
            b_copy = {"W": (1, plan.kstage, plan.Mps), "H": (1, plan.kstage, plan.Nps)}
            if name.startswith("w_terms"):  # W^T, H^T, H's and 1 - H's phase-B copies
                want = [a_copy["W"], a_copy["H"], b_copy["H"], b_copy["H"]]
            else:  # W^T, W's phase-B copy, H^T
                want = [a_copy["W"], b_copy["W"], a_copy["H"]]
            assert [s for s, dtype in shapes if len(s) == 3 and dtype == torch.float32] == want
            assert ((1, k, Mp), torch.float32) not in shapes  # no bit-plane copy
        else:
            assert not bf16
            if not name.startswith("w_terms"):
                assert ((1, k, Mp), torch.float32) in shapes  # wperm, as before
        first_int = _build._SIGNATURES[entry].index(_build._I)  # k, Mp, Np, bm follow
        assert args[first_int:first_int + 4] == (k, Mp, Np, o["bm"])


def test_lanes_reach_the_entry_point_with_lane_scratch(stub):
    R = 3
    o = _operands(R=R, k=150)
    plan = cs.plan_wgmma(150, o["Mp"], o["Np"])
    assert plan.nkb == 2
    for name, call in _calls(o, "bf16r").items():
        if name.startswith("h_terms"):  # no lane axis
            continue
        stub.calls.clear()
        call()
        entry, args = stub.calls[0]
        shapes = [stub.allocs[a][0] for a in args if isinstance(a, int) and a in stub.allocs]
        assert (R, plan.kstage, plan.Mps) in shapes and (R, plan.kstage, plan.Nps) in shapes
        assert len(args) == len(_build._SIGNATURES[entry]) and args[-4] == R  # lanes, eps, device, stream


@pytest.mark.parametrize("reported, counted", [((5, 6), 1), ((6, 6), 0)],
                         ids=["reported", "not-reported"])
def test_split_launches_are_counted_as_the_library_reports_them(stub, monkeypatch, reported,
                                                                 counted):
    """The float32 H wrappers count a launch of the warp-specialised body
    when the library's own count rises across it, whatever the rank; the
    other wrappers do not read it, and a stand-in library reports none."""
    assert cs._split_launches(stub) is None
    calls = _calls(_operands(k=256), "f32")
    for name in ("hloss_terms_packed", "hloss_terms", "h_terms"):
        counts = cs.H_WS_LAUNCHES if name in cs.H_WS_LAUNCHES else ds.H_WS_LAUNCHES
        reads = iter(reported)
        monkeypatch.setattr(cs, "_split_launches", lambda lib: next(reads))
        before = counts[name]
        calls[name]()
        assert counts[name] == before + counted, name
        assert next(reads, None) is None  # read once before and once after the launch

    def unread(lib):
        raise AssertionError("read by a wrapper that cannot run the warp-specialised body")

    monkeypatch.setattr(cs, "_split_launches", unread)
    for name in ("loglik_sum", "w_terms", "w_terms_packed"):
        calls[name]()


def test_stage_bf16_reaches_its_entry_point(stub):
    o = _operands(k=20)
    plan = cs.plan_wgmma(20, o["Mp"], o["Np"])
    for form, rule in (("bf16r", 0), ("bf16d", 1)):
        stub.calls.clear()
        wst, hst, hcst = cs.stage_bf16(_cuda(o["W"]), _cuda(o["H"]), o["bm"], form)
        (name, args), = stub.calls
        assert name == "nbmf_stage_bf16" and len(args) == len(_build._SIGNATURES[name])
        assert args[2:5] == (wst.data_ptr(), hst.data_ptr(), hcst.data_ptr())
        assert args[5:12] == (20, o["Mp"], o["Np"], o["bm"], rule, 1, 0)
        assert wst.shape == (plan.kstage, plan.Mps) and hcst.shape == (plan.kstage, plan.Nps)


def test_signatures_of_the_bf16_forms():
    sig = _build._SIGNATURES
    for base in ("hloss_terms_packed", "hloss_terms_dense", "h_terms_dense"):
        for form in ("bf16r", "bf16d"):
            if base.endswith("packed") and form == "bf16d":
                continue
            assert sig[f"nbmf_{base}_{form}"] == (
                sig[f"nbmf_{base}"][:11] + [_build._P] + sig[f"nbmf_{base}"][11:])
            # the TF32 form: wperm (index 10) replaced by wt, wk, ht
            assert sig[f"nbmf_{base}_tf32r"] == (
                sig[f"nbmf_{base}"][:10] + [_build._P] * 3 + sig[f"nbmf_{base}"][11:])
    assert sig["nbmf_w_terms_dense_tf32r"] == sig["nbmf_w_terms_dense"][:6] + [_build._P] * 4 + \
        sig["nbmf_w_terms_dense"][6:]
    assert sig["nbmf_loglik_sum_dense_tf32r"] == sig["nbmf_loglik_sum_dense"][:6] + \
        [_build._P] * 3 + sig["nbmf_loglik_sum_dense"][7:]
    assert sig["nbmf_w_terms_dense_bf16d"] == sig["nbmf_w_terms_dense"][:6] + [_build._P] * 3 + \
        sig["nbmf_w_terms_dense"][6:]
    assert sig["nbmf_loglik_sum_dense_bf16r"] == sig["nbmf_loglik_sum_dense"][:7] + [_build._P] + \
        sig["nbmf_loglik_sum_dense"][7:]
    assert "nbmf_hloss_terms_packed_bf16d" not in sig


@pytest.mark.parametrize("precision,dtype", [("default", "float32"), (None, "bfloat16")])
def test_cuda_without_a_card_raises(precision, dtype):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        cs.resolve_device("cuda")
    Y = (np.random.default_rng(0).random((40, 30)) < 0.4).astype(np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        port.solve(Y, 3, max_iter=2, precision=precision, dtype=dtype, device="cuda")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is a CUDA tensor (``is_cuda``)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("form", ["f32", "tf32r", "bf16r", "bf16d"])
def test_wh_product_is_a_bf16_gemm_on_the_card_for_the_bf16_forms(monkeypatch, form):
    rng = np.random.default_rng(7)
    A = tiers.mxu_round(torch.tensor(rng.random((40, 16)), dtype=torch.float32), form)
    B = tiers.mxu_round(torch.tensor(rng.random((16, 24)), dtype=torch.float32), form)
    assert torch.equal(tiers.wh_product(A, B, form), A @ B)  # the CPU: fp32
    calls = []

    def mm(a, b, *, out_dtype=None):
        calls.append((a.dtype, b.dtype, out_dtype))
        return a.float() @ b.float()

    monkeypatch.setattr(torch, "mm", mm)
    got = tiers.wh_product(A.as_subclass(_OnCard), B.as_subclass(_OnCard), form)
    if form in cs.WGMMA_FORMS:  # the operands are bf16 already: the values are the same
        assert calls == [(torch.bfloat16, torch.bfloat16, torch.float32)]
    else:
        assert calls == []
    assert torch.equal(got.as_subclass(torch.Tensor), A @ B)
