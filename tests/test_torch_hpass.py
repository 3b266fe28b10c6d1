"""The H pass's row split: the planner that sizes the kernel's grid, W's
bit-plane copy, and the split decomposition the kernel relies on, held
against the JAX package.

The CUDA H pass (``csrc/sweep_kernels.cuh`` ``hpass_kernel``) reads W in
bit-plane order (``cuda_sweep.bitplane_rows``), cuts the word rows into ``S``
chunks, writes one partial of Num/Den and of ll per chunk and adds the
partials in chunk order.  Here each chunk's data rows (its word rows in
bit-plane order, the real rows first so that ``m_real`` counts them) go
through the plain version, the partials are summed in order, and the sum is
compared with the JAX kernels run in interpret mode on the CPU.

Tolerances: 1e-12 of max |Num|, |Den| and of |ll| in float64 (the same
formulas, summed in another order); the probe forms 1e-5 of max |JAX| in
float32, as ``tests/test_torch_probes.py`` holds them (JAX with x64 off).
The JAX packed K1 adds log(1 + eps) per pad entry of the unmasked and parity
loss; the port masks exactly, so the test adds that constant back.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nbmf_mm_tpu.ops import pallas_sweep as ps
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds
from nbmf_mm_tpu_torch.ops import probes as pr
from tools import bench_packed2, bench_packed3

torch.set_num_threads(1)

EPS = 1e-8
H100_SMS = 132
TOL_F64 = 1e-12
TOL_PROBE = 1e-5
MODES = ["none", "parity", "corrected"]
SM_COUNTS = [1, 4, H100_SMS]

# (m, n) of the shapes the main paths and the probes give the H pass.
SHAPES = {
    "headline": (10_000, 10_000),
    "lastfm": (1226, 285),
    "one-word-row": (32, 40),
    "probes": (512, 640),
}
RANKS = (1, 4, 8, 17, 128, 256)


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_plan_covers_every_word_row_once_and_fills_the_card(shape, k):
    _, Mp, Np = cs.plan_packing(*shape)
    Mw = Mp // cs.PACKED_WORD_BITS
    plan = cs.plan_h_split(Mp, Np, k, H100_SMS)
    assert 1 <= plan.nsplit <= Mw
    assert len(plan.chunks) == plan.nsplit
    # contiguous, in order, from word row 0 to Mw, sizes within one row
    assert plan.chunks[0][0] == 0 and plan.chunks[-1][1] == Mw
    for (_, e0), (b1, _) in zip(plan.chunks, plan.chunks[1:]):
        assert e0 == b1
    sizes = [e - b for b, e in plan.chunks]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert plan.scratch == (None if plan.nsplit == 1 else (plan.nsplit, k, Np))
    col_blocks = -(-Np // cs.H_COLS)
    assert plan.blocks == col_blocks * plan.nsplit
    slots = H100_SMS * cs.blocks_per_sm(k)
    assert plan.waves == pytest.approx(plan.blocks / slots)
    # at least WAVES rounds unless every chunk is one word row, and no
    # more than twice the least split that reaches them
    if plan.nsplit < Mw:
        assert plan.waves >= cs.WAVES
    s0 = min(Mw, -(-cs.WAVES * slots // col_blocks))
    assert s0 <= plan.nsplit <= 2 * s0


def test_plan_at_the_headline():
    """10^4 x 10^4 at K=128 on 132 SMs: 157 column blocks, 5 chunks of 64
    word rows, 785 blocks (three rounds of 264 resident blocks, the last 97%
    full)."""
    plan = cs.plan_h_split(10_240, 10_000, 128, H100_SMS)
    assert plan.nsplit == 5 and plan.blocks == 785
    assert plan.scratch == (5, 128, 10_000)
    assert plan.chunks == tuple((64 * s, 64 * s + 64) for s in range(5))


@pytest.mark.parametrize("k, split", [(1, False), (128, False), (129, True), (200, True),
                                      (256, True)])
def test_h_warp_specialised_at_its_edges(k, split):
    """The warp-specialised H pass takes exactly the TK = 16 ranks, where one
    block an SM runs, as the split planner counts it."""
    assert cs.h_warp_specialised(k) is split
    assert cs.blocks_per_sm(k) == (1 if split else 2)


def test_plan_at_the_k256_headline():
    """10^4 x 10^4 at K=256 on 132 SMs: one block an SM, 157 column blocks,
    4 chunks of 80 word rows, 628 blocks (1.31 GB of partials over 16
    lanes)."""
    assert cs.blocks_per_sm(256) == 1
    plan = cs.plan_h_split(10_240, 10_000, 256, H100_SMS)
    assert plan.nsplit == 4 and plan.blocks == 628
    assert plan.scratch == (4, 256, 10_000)
    assert plan.chunks == tuple((80 * s, 80 * s + 80) for s in range(4))
    assert 16 * 2 * 4 * plan.scratch[1] * plan.scratch[2] * 4 == 1_310_720_000


def test_warp_specialised_counters_name_float32_wrappers():
    """The launches of the warp-specialised block are counted per float32
    wrapper, beside the wrappers' own launch counters."""
    assert set(cs.H_WS_LAUNCHES) == {"hloss_terms_packed"} and set(cs.H_WS_LAUNCHES) <= set(
        cs.LAUNCHES)
    assert set(ds.H_WS_LAUNCHES) == {"hloss_terms", "h_terms"} and set(ds.H_WS_LAUNCHES) <= set(
        ds.LAUNCHES)


@pytest.mark.parametrize("nsplit", [0, 9])
def test_even_chunks_rejects_more_chunks_than_word_rows(nsplit):
    with pytest.raises(ValueError):
        cs.even_chunks(8, nsplit)


# ------------------------------------------------------ W in bit-plane order
@pytest.mark.parametrize("bm", [32, 256, 512])
def test_bitplane_rows_follow_the_word_layout(bm):
    """Entry 32 w + b is the data row bit b of word row w holds: reading the
    unpacked rows in that order gives the words' bits in word-row order
    (stripe 32), and the order is a permutation of the rows."""
    Mp, Np = 512, 12
    rng = np.random.default_rng(bm)
    words = torch.tensor(cs.pack_bits_host((rng.random((Mp, Np)) < 0.4).astype(np.float32), bm))
    rows = cs.bitplane_rows(Mp, bm)
    assert torch.equal(torch.sort(rows).values, torch.arange(Mp))
    assert torch.equal(cs.unpack_bits(words, bm)[rows], cs.unpack_bits(words, 32))
    w, b = 13, 29
    bmw = bm // 32
    assert int(rows[32 * w + b]) == (w // bmw) * bm + w % bmw + b * bmw


# ------------------------------------------------ split against the JAX package
def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _factors(rng, k, m, n, Mp, Np):
    W = np.zeros((k, Mp))
    W[:, :m] = rng.uniform(0.1, 0.9, (k, m))
    W[:, :m] /= W[:, :m].sum(axis=0, keepdims=True)
    H = np.zeros((k, Np))
    H[:, :n] = rng.uniform(0.1, 0.9, (k, n))
    return W, H


def _chunk_rows(Mp, bm, chunk, m):
    """Data rows of the word rows ``[w0, w1)``, the real ones (``< m``)
    first, and how many are real."""
    rows = cs.bitplane_rows(Mp, bm)[cs.PACKED_WORD_BITS * chunk[0]:cs.PACKED_WORD_BITS * chunk[1]]
    real = rows[rows < m]
    return torch.cat([real, rows[rows >= m]]), len(real)


def _split_sum(fn, plan, Mp, bm, m):
    """Sum, in chunk order, of ``fn(rows, m_real)`` over the plan's chunks."""
    parts = [fn(*_chunk_rows(Mp, bm, chunk, m)) for chunk in plan.chunks]
    if isinstance(parts[0], tuple):
        return tuple(functools.reduce(torch.add, out) for out in zip(*parts))
    return functools.reduce(torch.add, parts)


def _plan(Mp, Np, k, n_sm, bm):
    """The plan, and that a chunk boundary falls inside a stripe when the
    rows are split."""
    plan = cs.plan_h_split(Mp, Np, k, n_sm)
    if n_sm > 1:
        assert plan.nsplit > 1
        assert any(b % (bm // cs.PACKED_WORD_BITS) for b, _ in plan.chunks)
    return plan


@functools.lru_cache(maxsize=None)
def _packed_case(mode):
    """500 x 250 binary data at the port's padding (Mp 512, two stripes of
    bm 256; Np 252, n_real 250 inside the last column block), K=4, f64; the
    JAX K1 in interpret mode."""
    m, n, k = 500, 250, 4
    bm, Mp, Np = cs.plan_packing(m, n)
    rng = np.random.default_rng(41)
    Y = (rng.random((m, n)) < 0.35).astype(np.float64)
    mask = rng.random((m, n)) < 0.75
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    Ym = pad(Y if mode == "none" else Y * mask)
    Yc = pad((1 - Y) * mask) if mode == "corrected" else None
    W, H = _factors(rng, k, m, n, Mp, Np)
    words, words2 = cs.pack_bits_host(Ym, bm), None if Yc is None else cs.pack_bits_host(Yc, bm)
    num, den, ll = ps.hloss_terms_packed(_j(W), _j(H), _j(words), _j(words2), eps=EPS,
                                         block_m=bm, interpret=True)
    pad_ll = 0.0 if mode == "corrected" else (Mp * Np - m * n) * np.log1p(EPS)
    return dict(W=W, H=H, Ym=Ym, Yc=Yc, bm=bm, m=m, n=n, k=k,
                ref=(np.asarray(num), np.asarray(den), float(ll) - pad_ll))


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("mode", MODES)
def test_split_hloss_terms_packed_matches_pallas(mode, n_sm):
    c = _packed_case(mode)
    W, H, Ym, Yc = _t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Yc"])
    Mp, Np = Ym.shape
    plan = _plan(Mp, Np, c["k"], n_sm, c["bm"])
    pack = lambda A: None if A is None else torch.tensor(cs.pack_bits_host(A.numpy(), 32))

    def chunk(rows, m_real):
        return cs.hloss_terms_packed_plain(W[:, rows], H, pack(Ym[rows]),
                                           None if Yc is None else pack(Yc[rows]), eps=EPS,
                                           m_real=m_real, n_real=c["n"], bm=32)

    num, den, ll = _split_sum(chunk, plan, Mp, c["bm"], c["m"])
    assert _rel(num, c["ref"][0]) <= TOL_F64
    assert _rel(den, c["ref"][1]) <= TOL_F64
    assert abs(float(ll) - c["ref"][2]) <= TOL_F64 * abs(c["ref"][2])


@functools.lru_cache(maxsize=None)
def _dense_case(mode):
    """500 x 250 [0,1]-valued data under a weighted mask, padded to the JAX
    tiles (512 x 256), K=4, f64; the kernel walks stripe bm = 256.  The JAX
    hloss_terms, loglik_sum and h_terms in interpret mode."""
    m, n, k, block, bm = 500, 250, 4, 128, 256
    Mp, Np = 512, 256
    rng = np.random.default_rng(42)
    Y = rng.random((m, n))
    mask = (rng.random((m, n)) < 0.75) * np.where(rng.random((m, n)) < 0.3, 0.5, 1.0)
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    Ym = pad(Y if mode == "none" else Y * mask)
    Yc = pad((1 - Y) * mask) if mode == "corrected" else None
    W, H = _factors(rng, k, m, n, Mp, Np)
    args = (_j(W), _j(H), _j(Ym), _j(Yc))
    tiles = dict(block_m=block, block_n=block, interpret=True)
    num, den, ll = ps.hloss_terms(*args, eps=EPS, m_real=m, n_real=n, **tiles)
    ll_only = ps.loglik_sum(*args, m_real=m, n_real=n, eps=EPS, **tiles)
    h_num, h_den = ps.h_terms(*args, eps=EPS, **tiles)
    ref = dict(hloss=(np.asarray(num), np.asarray(den), float(ll)), loglik=float(ll_only),
               h_terms=(np.asarray(h_num), np.asarray(h_den)))
    return dict(W=W, H=H, Ym=Ym, Yc=Yc, bm=bm, m=m, n=n, k=k, ref=ref)


def _dense_split(mode, n_sm, fn):
    c = _dense_case(mode)
    W, H, Ym, Yc = _t(c["W"]), _t(c["H"]), _t(c["Ym"]), _t(c["Yc"])
    plan = _plan(*Ym.shape, c["k"], n_sm, c["bm"])
    out = _split_sum(lambda rows, m_real: fn(W[:, rows], H, Ym[rows],
                                             None if Yc is None else Yc[rows], m_real, c["n"]),
                     plan, Ym.shape[0], c["bm"], c["m"])
    return out, c["ref"]


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("mode", MODES)
def test_split_hloss_terms_matches_pallas(mode, n_sm):
    (num, den, ll), ref = _dense_split(mode, n_sm, lambda W, H, Ym, Yc, m_real, n_real:
                                       ds.hloss_terms_plain(W, H, Ym, Yc, eps=EPS, m_real=m_real,
                                                            n_real=n_real))
    assert _rel(num, ref["hloss"][0]) <= TOL_F64
    assert _rel(den, ref["hloss"][1]) <= TOL_F64
    assert abs(float(ll) - ref["hloss"][2]) <= TOL_F64 * abs(ref["hloss"][2])


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("mode", MODES)
def test_split_loglik_sum_matches_pallas(mode, n_sm):
    ll, ref = _dense_split(mode, n_sm, lambda W, H, Ym, Yc, m_real, n_real:
                           ds.loglik_sum_plain(W, H, Ym, Yc, eps=EPS, m_real=m_real,
                                               n_real=n_real))
    assert abs(float(ll) - ref["loglik"]) <= TOL_F64 * abs(ref["loglik"])


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("mode", ["none", "corrected"], ids=["Yc-None", "Yc-explicit"])
def test_split_h_terms_matches_pallas(mode, n_sm):
    (num, den), ref = _dense_split(mode, n_sm, lambda W, H, Ym, Yc, m_real, n_real:
                                   ds.h_terms_plain(W, H, Ym, Yc, eps=EPS))
    assert _rel(num, ref["h_terms"][0]) <= TOL_F64
    assert _rel(den, ref["h_terms"][1]) <= TOL_F64


def test_split_sums_chunks_in_order_to_the_unsplit_pass():
    """On the port's ragged padding the chunked plain pass equals the
    unchunked one to f64 rounding, in every chunk count up to one word row
    per chunk."""
    c = _packed_case("parity")
    W, H, Ym = _t(c["W"]), _t(c["H"]), _t(c["Ym"])
    words = torch.tensor(cs.pack_bits_host(c["Ym"], c["bm"]))
    kw = dict(eps=EPS, n_real=c["n"])
    whole = cs.hloss_terms_packed_plain(W, H, words, m_real=c["m"], bm=c["bm"], **kw)
    Mp = Ym.shape[0]
    pack = lambda A: torch.tensor(cs.pack_bits_host(A.numpy(), 32))
    chunk = lambda rows, m_real: cs.hloss_terms_packed_plain(W[:, rows], H, pack(Ym[rows]),
                                                             m_real=m_real, bm=32, **kw)
    for nsplit in range(1, Mp // 32 + 1):
        plan = cs.HSplit(nsplit, cs.even_chunks(Mp // 32, nsplit), None, 0, 0.0)
        for got, want in zip(_split_sum(chunk, plan, Mp, c["bm"], c["m"]), whole):
            assert _rel(got, want) <= TOL_F64


def test_launch_rejects_misaligned_operands():
    """The kernel copies the operand rows as 16-byte vectors: an operand that
    starts off a 16-byte boundary raises before anything is built."""
    W, H = torch.zeros((2, 32)), torch.zeros((2, 8))
    y = torch.zeros(32 * 8 + 1)[1:].reshape(32, 8)
    with pytest.raises(ValueError, match="16-byte boundary"):
        cs._launch_hloss("nbmf_hloss_terms_dense", "hloss_terms", W, H, y, None, eps=EPS,
                         m_real=32, n_real=8, bm=32)


# ------------------------------------------- the probe forms on the split
M, N, K, BM = 512, 640, 8, 256
MXU = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret_x32(monkeypatch):
    """Every pallas_call in interpret mode, and x64 off, for one test (the
    tools/ probes take ``interpret=`` only in part)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def _probe_problem(seed):
    """The probe tests' draw: W on a 1/64 grid, H on a 1/16 grid, so WH is
    exact in f32 whatever the order and bf16 operands agree."""
    rng = np.random.default_rng(seed)
    Y = (rng.random((M, N)) < 0.3).astype(np.float32)
    W = (rng.integers(1, 8, (K, M)) / 64).astype(np.float32)
    H = (rng.integers(2, 15, (K, N)) / 16).astype(np.float32)
    return W, H, Y


def _close(port, ref):
    for p, r in zip(port, ref):
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        assert p.shape == r.shape
        assert np.abs(p - r).max() <= TOL_PROBE * np.abs(r).max()


def _zeroed_split(fn, W, n_sm, bm):
    """Sum over the plan's chunks of ``fn(W_chunk)``, W_chunk zero outside
    the chunk's data rows: the stripe of every row stays where it was, as
    the per-stripe weights of ``mxu_only`` n_mm=2 need."""
    plan = _plan(M, N, K, n_sm, bm)

    def part(rows, _):
        Wc = torch.zeros_like(W)
        Wc[:, rows] = W[:, rows]
        return fn(Wc)

    return _split_sum(part, plan, M, bm, M)


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("n_sm", [4, H100_SMS])
@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("n_mm", [3, 2])
def test_split_mxu_only_matches_the_tools_probe(n_mm, mxu, n_sm):
    W, H, _ = _probe_problem(51)
    ref = bench_packed2.mxu_only(jnp.asarray(W), jnp.asarray(H), None, n_mm=n_mm, block_m=BM,
                                 mxu_dtype=MXU[mxu][0])
    got = _zeroed_split(lambda Wc: pr.mxu_only_plain(Wc, torch.tensor(H), n_mm=n_mm, block_m=BM,
                                                     mxu_dtype=MXU[mxu][1]),
                        torch.tensor(W), n_sm, BM)
    _close(got, ref)


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("n_sm", [4, H100_SMS])
@pytest.mark.parametrize("mxu", ["f32", "bf16"])
def test_split_chain3_acc_matches_the_tools_probe(mxu, n_sm):
    W, H, _ = _probe_problem(52)
    ref = bench_packed3.mxu_probe(jnp.asarray(W), jnp.asarray(H), variant="chain3_acc",
                                  block_m=BM, mxu_dtype=MXU[mxu][0])
    got = _zeroed_split(lambda Wc: pr.mxu_probe_plain(Wc, torch.tensor(H), variant="chain3_acc",
                                                      block_m=BM, mxu_dtype=MXU[mxu][1]),
                        torch.tensor(W), n_sm, BM)
    _close(got, ref)


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("n_sm", [4, H100_SMS])
@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_split_hloss_ngrid_matches_the_tools_probe(packed, mxu, n_sm):
    """hloss_ngrid walks stripe bm = Mp: one stripe, so every chunk boundary
    falls inside it.  Each chunk's rows form a problem of their own (the
    ll is unmasked), packed as one stripe of its rows."""
    W, H, Y = _probe_problem(53)
    data = cs.pack_bits_host(Y, M) if packed else Y
    ref = bench_packed3.hloss_ngrid(jnp.asarray(W), jnp.asarray(H), jnp.asarray(data),
                                    block_n=128, packed=packed, mxu_dtype=MXU[mxu][0],
                                    interpret=True)
    Wt, Ht, Yt = torch.tensor(W), torch.tensor(H), torch.tensor(Y)

    def chunk(rows, _):
        Yc = Yt[rows]
        Yc = torch.tensor(cs.pack_bits_host(Yc.numpy(), len(rows))) if packed else Yc
        return pr.hloss_ngrid_plain(Wt[:, rows], Ht, Yc, block_n=128, packed=packed,
                                    mxu_dtype=MXU[mxu][1])

    got = _split_sum(chunk, _plan(M, N, K, n_sm, M), M, M, M)
    _close(got, ref)


# ------------------------------------------------------- the tuning tool
def test_hpass_tune_variants_edit_only_the_h_pass():
    """The tuning tool's text edits still match the kernel source, leave the
    W pass's text as it is, and keep each variant's braces balanced."""
    from nbmf_mm_tpu_torch.ops import _build
    from nbmf_mm_tpu_torch.tools.hpass_tune import variants

    header = (_build.CSRC / "sweep_kernels.cuh").read_text()
    texts = variants(header)
    assert set(texts) == {"production", "one_block", "phase_a_x2", "phase_b_x2"}
    assert texts["production"] == header
    w_pass = header[header.index("// ---------------------------------------------------------"
                                 "--- W pass"):header.index("struct HPass {")]
    for name, text in texts.items():
        assert text.count("{") == text.count("}"), name
        assert w_pass in text, name
        assert name == "production" or text != header


def test_hpass_tune_variants_at_rank_256_edit_only_the_h_pass():
    """At k > 128 the tool's variants are those of the warp-specialised
    body: the parent's turn-taking body, the two-block design, the body
    without setmaxnreg and its two leave-one-outs; none edits the W pass."""
    from nbmf_mm_tpu_torch.ops import _build
    from nbmf_mm_tpu_torch.tools.hpass_tune import variants

    header = (_build.CSRC / "sweep_kernels.cuh").read_text()
    texts = variants(header, 256)
    assert set(texts) == {"production", "turn_taking", "two_block", "no_setmaxnreg",
                          "phase_a_x0", "phase_b_x0"}
    assert texts["production"] == header
    rule = "// ------------------------------------------------------------ "
    w_pass = header[header.index(rule + "W pass"):header.index(rule + "H pass")]
    for name, text in texts.items():
        assert text.count("{") == text.count("}"), name
        assert w_pass in text, name
        assert name == "production" or text != header
    assert "kSplit = false;" in texts["turn_taking"] and "kSplit = false;" in texts["two_block"]
    assert "constexpr int kHCols = 32;" in texts["two_block"]
    assert 'asm volatile("setmaxnreg' not in texts["no_setmaxnreg"]


# ------------------------------------------------- a leading lane axis on K1
# Batched factors W (R, k, Mp), H (R, k, Np) over shared words.  Lane r of the
# wrapper on CPU tensors equals the unbatched call bitwise (the plain version
# runs lane by lane); against the JAX K1 under jax.vmap in interpret mode
# (float64, the pad-bias constant added back) the bar is 1e-10 of max |JAX|.
TOL_VMAP = 1e-10


def _lane_factors(k, m, n, Mp, Np, R, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    pairs = [_factors(rng, k, m, n, Mp, Np) for _ in range(R)]
    return (np.stack([w for w, _ in pairs]).astype(dtype),
            np.stack([h for _, h in pairs]).astype(dtype))


@pytest.mark.parametrize("R", [1, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m, n", [(500, 250), (300, 70), (40, 30)],
                         ids=["two-stripes", "m300-jax-rejects", "one-stripe"])
def test_batched_k1_lane_equals_unbatched_bitwise(m, n, mode, dtype, R):
    bm, Mp, Np = cs.plan_packing(m, n)
    rng = np.random.default_rng(m + n)
    Y = (rng.random((m, n)) < 0.35).astype(np.float64)
    mask = rng.random((m, n)) < 0.75
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    words = _t(cs.pack_bits_host(pad(Y if mode == "none" else Y * mask), bm))
    words2 = _t(cs.pack_bits_host(pad((1 - Y) * mask), bm)) if mode == "corrected" else None
    W, H = map(torch.tensor, _lane_factors(4, m, n, Mp, Np, R, 7, dtype))
    kw = dict(eps=EPS, m_real=m, n_real=n, bm=bm)
    num, den, ll = cs.hloss_terms_packed(W, H, words, words2, **kw)
    assert num.shape == den.shape == (R, 4, Np) and ll.shape == (R,) and ll.dtype == W.dtype
    for r in range(R):
        for got, want in zip((num, den, ll), cs.hloss_terms_packed(W[r], H[r], words, words2,
                                                                   **kw)):
            assert torch.equal(got[r], want)


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_batched_k1_matches_pallas_under_vmap(mode, R):
    c = _packed_case(mode)
    m, n, k, bm = c["m"], c["n"], c["k"], c["bm"]
    Mp, Np = c["Ym"].shape
    Wb, Hb = _lane_factors(k, m, n, Mp, Np, R, 8)
    words = cs.pack_bits_host(c["Ym"], bm)
    words2 = None if c["Yc"] is None else cs.pack_bits_host(c["Yc"], bm)
    num_j, den_j, ll_j = jax.vmap(lambda W, H: ps.hloss_terms_packed(
        W, H, _j(words), _j(words2), eps=EPS, block_m=bm, interpret=True))(_j(Wb), _j(Hb))
    num, den, ll = cs.hloss_terms_packed(_t(Wb), _t(Hb), _t(words), _t(words2), eps=EPS,
                                         m_real=m, n_real=n, bm=bm)
    bias = 0.0 if mode == "corrected" else (Mp * Np - m * n) * np.log1p(EPS)
    assert _rel(num, num_j) <= TOL_VMAP and _rel(den, den_j) <= TOL_VMAP
    assert _rel(ll.numpy() + bias, ll_j) <= TOL_VMAP


def test_per_lane_checks_the_lane_axes():
    W, H = torch.zeros((3, 2, 32)), torch.zeros((3, 2, 8))
    words = torch.zeros((1, 8), dtype=torch.int32)
    kw = dict(eps=EPS, m_real=32, n_real=8, bm=32)
    with pytest.raises(ValueError, match="one R"):
        cs.hloss_terms_packed(W, H[:2], words, **kw)
    with pytest.raises(ValueError, match="one R"):
        cs.hloss_terms_packed(W, H[0], words, **kw)
    with pytest.raises(ValueError, match="lanes"):
        cs.lane_count("k1", torch.zeros((0, 2, 32)), torch.zeros((0, 2, 8)))
    assert cs.lane_count("k1", W[0], H[0]) is None and cs.lane_count("k1", W, H) == 3


def test_cuda_checks_learn_the_lane_axis():
    """``_check_cuda_operands`` on meta tensors standing in for the card's:
    shapes are read off the last two axes, and a lane axis passes only where
    the caller batches."""
    dev = "meta"
    W, H = torch.zeros((3, 2, 32), device=dev), torch.zeros((3, 2, 8), device=dev)
    words = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported device"):
        cs._check_cuda_operands("k1", W, H, words, None, 32, batched=True)


def test_launch_rejects_a_lane_stride_off_16_bytes():
    with pytest.raises(ValueError, match="lane stride"):
        cs._check_aligned("k1", (2 * 32, 2 * 7))
    cs._check_aligned("k1", (2 * 32, 2 * 8))
