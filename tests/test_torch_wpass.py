"""The W pass's column split: the planner that sizes the kernel's grid, and the
split decomposition it relies on, held against the JAX package.

The CUDA W pass (``csrc/sweep_kernels.cuh`` ``wpass_kernel``) cuts the
columns into ``S`` chunks of whole 32-column tiles, writes one partial of
``T`` per chunk and adds the partials in chunk order; the fp32 pass plans
its split by its own occupancy (``w_blocks_per_sm``), the tensor-core forms
by the H pass's (``blocks_per_sm``).  Here each chunk goes
through the plain version with its global column offset (``n_real`` less
the chunk's first column, so the ``col < n_real`` complement stays right),
the partials are summed in order, and the sum is compared with the JAX
kernels run in interpret mode on the CPU.

Tolerances: 1e-12 of max |T| in float64 (the same formulas, summed in
another order); the probe forms 1e-5 of max |JAX| in float32, as
``tests/test_torch_probes.py`` holds them (JAX with x64 off).
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
from tools import bench_packed, bench_packed2, bench_packed3

torch.set_num_threads(1)

EPS = 1e-8
H100_SMS = 132
TOL_F64 = 1e-12
TOL_PROBE = 1e-5

# (m, n) of the shapes the main paths give the W pass: the headline, every
# FoldInServer bucket against 10^4 features, lastfm, one word row.
SHAPES = {
    "headline": (10_000, 10_000),
    **{f"bucket{rows}": (rows, 10_000) for rows in (64, 256, 1024, 4096, 8192)},
    "lastfm": (1226, 285),
    "one-word-row": (32, 40),
}
RANKS = (1, 4, 8, 17, 128, 256)


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_plan_covers_every_column_once_and_fills_the_card(shape, k):
    _, Mp, Np = cs.plan_packing(*shape)
    plan = cs.plan_w_split(Mp, Np, k, H100_SMS)
    tiles = -(-Np // cs.W_TILE)
    assert 1 <= plan.nsplit <= tiles
    assert len(plan.chunks) == plan.nsplit
    # contiguous, in order, from column 0 to Np, boundaries on whole tiles
    assert plan.chunks[0][0] == 0 and plan.chunks[-1][1] == Np
    for (b0, e0), (b1, _) in zip(plan.chunks, plan.chunks[1:]):
        assert e0 == b1
    for b, e in plan.chunks:
        assert b < e and b % cs.W_TILE == 0
        assert e % cs.W_TILE == 0 or e == Np
    sizes = [-(-(e - b) // cs.W_TILE) for b, e in plan.chunks]
    assert max(sizes) - min(sizes) <= 1
    assert plan.scratch == (None if plan.nsplit == 1 else (plan.nsplit, k, Mp))
    row_blocks = -(-Mp // cs.W_ROWS)
    assert plan.blocks == row_blocks * plan.nsplit
    slots = H100_SMS * cs.w_blocks_per_sm(k)
    assert plan.waves == pytest.approx(plan.blocks / slots)
    if cs.w_warp_specialised(k):
        # the warp-specialised block: fewest rounds times tiles a block,
        # a block's own cost counted as W_BLOCK_TILES tiles
        cost = lambda s: -(-row_blocks * s // slots) * (-(-tiles // s) + cs.W_BLOCK_TILES)
        assert cost(plan.nsplit) == min(map(cost, range(1, tiles + 1)))
        assert all(cost(s) > cost(plan.nsplit) for s in range(1, plan.nsplit))  # least on ties
        return
    # about two waves: at least WAVES unless every chunk is one tile,
    # and no more than twice the least split that reaches them
    if plan.nsplit < tiles:
        assert plan.waves >= cs.WAVES
    s0 = min(tiles, -(-cs.WAVES * slots // row_blocks))
    assert s0 <= plan.nsplit <= 2 * s0


def test_plan_at_the_headline():
    """10^4 x 10^4 at K=128 on 132 SMs: 160 row blocks, 4 chunks of 78 or 79
    tiles, 640 blocks (five rounds of 132 resident blocks, the last 85%
    full)."""
    plan = cs.plan_w_split(10_240, 10_000, 128, H100_SMS)
    assert plan.nsplit == 4 and plan.blocks == 640
    assert plan.scratch == (4, 128, 10_240)
    assert {e - b for b, e in plan.chunks[:-1]} <= {78 * 32, 79 * 32}


@pytest.mark.parametrize("m, k, nsplit", [(64, 128, 105), (64, 65, 105), (8_192, 128, 1),
                                           (10_000, 96, 4), (100_000, 128, 1)])
def test_pipelined_split_at_the_serving_chunks_and_the_cells(m, k, nsplit):
    """The warp-specialised block's split against 10^4 columns: a 64-row
    serving chunk takes 105 chunks of three tiles (one round, each block's
    two producer groups both busy), an 8192-row chunk and the flagship one
    chunk, the headline four (the benchmark's splits, as before)."""
    _, Mp, Np = cs.plan_packing(m, 10_000)
    plan = cs.plan_w_split(Mp, Np, k, H100_SMS)
    assert plan.nsplit == nsplit
    assert {-(-(e - b) // cs.W_TILE) for b, e in plan.chunks} <= {313 // nsplit, -(-313 // nsplit)}


def test_tensor_core_plan_keeps_the_32_column_unit():
    """The tensor-core W passes plan as before: 32-column units at
    ``blocks_per_sm``, 8 chunks and 1280 blocks at the headline."""
    plan = cs.plan_w_split(10_240, 10_000, 128, H100_SMS, tensor_cores=True)
    assert plan.nsplit == 8 and plan.blocks == 1280
    assert plan.scratch == (8, 128, 10_240)
    assert plan.chunks == cs.column_chunks(10_000, 8)
    assert plan.waves == pytest.approx(1280 / (H100_SMS * cs.blocks_per_sm(128)))


def _kernel_tiles(Np, nsplit, s, tile=32):
    """Columns ``[begin, end)`` block ``(x, s)`` of the kernel walks: its
    ``t_begin``/``t_end`` in tiles of ``tile`` columns, cut at ``Np``."""
    nt = -(-Np // tile)
    t_begin = s * (nt // nsplit) + min(s, nt % nsplit)
    t_end = t_begin + nt // nsplit + (1 if s < nt % nsplit else 0)
    return t_begin * tile, min(Np, t_end * tile)


def _word_row_bit(w, b, bm):
    bmw = bm // 32
    j = w // bmw
    return j * bm + (w - j * bmw) + b * bmw


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_plan_covers_every_row_and_column_once_in_chunk_order(shape, k):
    """The kernel's grid over the plan: block (x, s) walks the columns of
    chunk s and the 64 data rows of word rows 2x and 2x + 1; the chunks,
    taken in order, cover 0..Np once, and the row blocks cover 0..Mp once."""
    bm, Mp, Np = cs.plan_packing(*shape)
    plan = cs.plan_w_split(Mp, Np, k, H100_SMS)
    assert plan.nsplit <= -(-Np // cs.W_TILE)  # the launcher's bound
    cols = []
    for s, chunk in enumerate(plan.chunks):
        assert _kernel_tiles(Np, plan.nsplit, s) == chunk
        cols += range(*chunk)
    assert cols == list(range(Np))
    Mw = Mp // 32
    rows = [_word_row_bit(2 * x + lr // 32, lr % 32, bm) for x in range((Mw + 1) // 2)
            for lr in range(cs.W_ROWS) if 2 * x + lr // 32 < Mw]
    assert sorted(rows) == list(range(Mp))
    assert plan.blocks == (Mw + 1) // 2 * plan.nsplit


# The benchmark's two shapes (m, n, k, lanes): the flagship fit and the
# headline's 16 restarts, at the solver's padding.
CELL_SHAPES = {"flagship": (100_000, 10_000, 128, 1), "headline_restarts16": (10_000, 10_000, 128, 16)}


@pytest.mark.parametrize("m, n, k, lanes", CELL_SHAPES.values(), ids=CELL_SHAPES.keys())
def test_w_split_scratch_never_exceeds_the_h_split_scratch(m, n, k, lanes):
    """The W pass's partials ((S, k, Mp) a lane) never outgrow the H pass's
    Num/Den partials (two of (S, k, Np) a lane), which set the fit's peak."""
    _, Mp, Np = cs.plan_packing(m, n)
    size = lambda scratch, copies: 0 if scratch is None else copies * lanes * int(np.prod(scratch))
    w = cs.plan_w_split(Mp, Np, k, H100_SMS)
    h = cs.plan_h_split(Mp, Np, k, H100_SMS)
    assert size(w.scratch, 1) <= size(h.scratch, 2)
    # and no more than the parent's 32-column plan at two blocks per SM
    assert size(w.scratch, 1) <= size(cs.plan_w_split(Mp, Np, k, H100_SMS,
                                                      tensor_cores=True).scratch, 1)


def test_plan_h_split_is_unchanged_at_the_cells_shapes():
    """The H pass keeps its own occupancy figure: its split at the cells'
    shapes is the one it had before the W pass took its own
    (``w_blocks_per_sm``)."""
    flagship = cs.plan_h_split(100_096, 10_000, 128, H100_SMS)
    assert flagship == cs.HSplit(5, ((0, 626), (626, 1252), (1252, 1878), (1878, 2503),
                                     (2503, 3128)), (5, 128, 10_000), 785, 785 / 264)
    headline = cs.plan_h_split(10_240, 10_000, 128, H100_SMS)
    assert headline == cs.HSplit(5, ((0, 64), (64, 128), (128, 192), (192, 256), (256, 320)),
                                 (5, 128, 10_000), 785, 785 / 264)
    assert cs.blocks_per_sm(128) == 2 and cs.blocks_per_sm(129) == 1


@pytest.mark.parametrize("k", [1, 16, 17, 32, 33, 64, 65, 128, 129, 256])
def test_w_geometry_restates_the_kernel(k):
    """``w_blocks_per_sm`` restates ``WPass::kMinBlocks`` by the k rows a
    thread holds (TK = 1, 2, 4, 8, 16); the split's chunks never outnumber
    the 32-column tiles."""
    tk = 1 if k <= 16 else 2 if k <= 32 else 4 if k <= 64 else 8 if k <= 128 else 16
    assert cs.w_blocks_per_sm(k) == (2 if tk <= 4 else 1)
    plan = cs.plan_w_split(64, 100, k, H100_SMS)
    assert plan.nsplit <= -(-100 // cs.W_TILE)


def test_plan_scratch_of_two_output_forms():
    plan = cs.plan_w_split(10_240, 10_240, 128, H100_SMS, n_out=2)
    assert plan.scratch == (plan.nsplit, 256, 10_240)


@pytest.mark.parametrize("nsplit", [0, 3])
def test_column_chunks_rejects_more_chunks_than_tiles(nsplit):
    with pytest.raises(ValueError):
        cs.column_chunks(64, nsplit)  # two tiles


# ------------------------------------------------ split against the JAX package
def _split_sum(fn, H, Ys, n_real, chunks):
    """Sum, in chunk order, of ``fn`` over each column chunk, given the
    chunk's columns of H and of each operand and its shifted ``n_real``."""
    parts = [fn(H[:, b:e], *[None if Y is None else Y[:, b:e] for Y in Ys], n_real - b)
             for b, e in chunks]
    if isinstance(parts[0], tuple):
        return tuple(functools.reduce(torch.add, out) for out in zip(*parts))
    return functools.reduce(torch.add, parts)


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


def _factors(rng, k, m, n, Mp, Np):
    W = np.zeros((k, Mp))
    W[:, :m] = rng.uniform(0.1, 0.9, (k, m))
    W[:, :m] /= W[:, :m].sum(axis=0, keepdims=True)
    H = np.zeros((k, Np))
    H[:, :n] = rng.uniform(0.1, 0.9, (k, n))
    return W, H


@functools.lru_cache(maxsize=None)
def _packed_case(mode):
    """240 x 250 binary data at the port's padding (Mp 256, Np 252: the last
    tile is 28 columns and n_real = 250 falls inside it), K=4, f64; the JAX
    K2 in interpret mode."""
    m, n, k = 240, 250, 4
    bm, Mp, Np = cs.plan_packing(m, n)
    rng = np.random.default_rng(21)
    Y = (rng.random((m, n)) < 0.35).astype(np.float64)
    mask = rng.random((m, n)) < 0.75
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    words = cs.pack_bits_host(pad(Y if mode == "none" else Y * mask), bm)
    words2 = None if mode == "none" else cs.pack_bits_host(pad((1 - Y) * mask), bm)
    W, H = _factors(rng, k, m, n, Mp, Np)
    ref = ps.w_terms_packed(jnp.asarray(W), jnp.asarray(H), jnp.asarray(words),
                            None if words2 is None else jnp.asarray(words2), n_real=n, eps=EPS,
                            block_m=bm, interpret=True)
    return dict(W=W, H=H, words=words, words2=words2, bm=bm, n=n, ref=np.asarray(ref))


@functools.lru_cache(maxsize=None)
def _dense_case(mode):
    """240 x 250 [0,1]-valued data under a weighted mask, padded to the JAX
    tiles (256 x 256), K=4, f64; the JAX w_terms in interpret mode."""
    m, n, k, block = 240, 250, 4, 128
    Mp = Np = 256
    rng = np.random.default_rng(22)
    Y = rng.random((m, n))
    mask = (rng.random((m, n)) < 0.75) * np.where(rng.random((m, n)) < 0.3, 0.5, 1.0)
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    Ym = pad(Y if mode == "none" else Y * mask)
    Ym2 = None if mode == "none" else pad((1 - Y) * mask)
    W, H = _factors(rng, k, m, n, Mp, Np)
    ref = ps.w_terms(jnp.asarray(W), jnp.asarray(H), jnp.asarray(Ym),
                     None if Ym2 is None else jnp.asarray(Ym2), n_real=n, eps=EPS,
                     block_m=block, block_n=block, interpret=True)
    return dict(W=W, H=H, Ym=Ym, Ym2=Ym2, bm=block, n=n, ref=np.asarray(ref))


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("n_sm", [1, 4, H100_SMS])
@pytest.mark.parametrize("mode", ["none", "parity", "corrected"])
def test_split_w_terms_packed_matches_pallas(mode, n_sm):
    c = _packed_case(mode)
    W, H = _t(c["W"]), _t(c["H"])
    plan = cs.plan_w_split(W.shape[1], H.shape[1], W.shape[0], n_sm)
    fn = lambda Hc, words, words2, n_real: cs.w_terms_packed_plain(
        W, Hc, words, words2, eps=EPS, n_real=n_real, bm=c["bm"])
    T = _split_sum(fn, H, (_t(c["words"]), _t(c["words2"])), c["n"], plan.chunks)
    if n_sm > 1:
        assert plan.nsplit > 1
    assert T.shape == c["ref"].shape
    assert _rel(T, c["ref"]) <= TOL_F64


@pytest.mark.parametrize("n_sm", [1, 4, H100_SMS])
@pytest.mark.parametrize("mode", ["none", "parity", "corrected"])
def test_split_w_terms_matches_pallas(mode, n_sm):
    c = _dense_case(mode)
    W, H = _t(c["W"]), _t(c["H"])
    plan = cs.plan_w_split(W.shape[1], H.shape[1], W.shape[0], n_sm)
    fn = lambda Hc, Ym, Ym2, n_real: ds.w_terms_plain(W, Hc, Ym, Ym2, eps=EPS, n_real=n_real)
    T = _split_sum(fn, H, (_t(c["Ym"]), _t(c["Ym2"])), c["n"], plan.chunks)
    if n_sm > 1:
        assert plan.nsplit > 1
    assert _rel(T, c["ref"]) <= TOL_F64


def test_split_sums_chunks_in_order_to_the_unsplit_pass():
    """On the port's ragged padding (Np = 252) the chunked plain pass equals
    the unchunked one to f64 rounding, in every chunk count up to one tile
    per chunk."""
    c = _packed_case("parity")
    W, H = _t(c["W"]), _t(c["H"])
    words, words2 = _t(c["words"]), _t(c["words2"])
    whole = cs.w_terms_packed_plain(W, H, words, words2, eps=EPS, n_real=c["n"], bm=c["bm"])
    fn = lambda Hc, y, y2, n_real: cs.w_terms_packed_plain(W, Hc, y, y2, eps=EPS,
                                                           n_real=n_real, bm=c["bm"])
    for nsplit in range(1, 9):
        T = _split_sum(fn, H, (words, words2), c["n"], cs.column_chunks(H.shape[1], nsplit))
        assert _rel(T, whole) <= TOL_F64


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
    return W, H, cs.pack_bits_host(Y, BM)


def _close(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= TOL_PROBE * np.abs(ref).max()


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("n_sm", [4, H100_SMS])
@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("name, module", [("w_packed", bench_packed), ("w_packed2", bench_packed2)])
def test_split_one_matmul_forms_match_the_tools_probes(name, module, mxu, n_sm):
    W, H, Yp = _probe_problem(31)
    n_real = N - 40
    ref = getattr(module, name)(jnp.asarray(W), jnp.asarray(H), jnp.asarray(Yp), n_real=n_real,
                                block_m=BM, mxu_dtype=MXU[mxu][0], interpret=True)
    plan = cs.plan_w_split(M, N, K, n_sm)
    assert plan.nsplit > 1
    plain = getattr(pr, name + "_plain")
    fn = lambda Hc, Ypc, n_r: plain(torch.tensor(W), Hc, Ypc, n_real=n_r, block_m=BM,
                                    mxu_dtype=MXU[mxu][1])
    _close(_split_sum(fn, torch.tensor(H), (torch.tensor(Yp),), n_real, plan.chunks), ref)


@pytest.mark.usefixtures("interpret_x32")
@pytest.mark.parametrize("n_sm", [4, H100_SMS])
@pytest.mark.parametrize("mxu", ["f32", "bf16"])
def test_split_chain3_tile_matches_the_tools_probe(mxu, n_sm):
    W, H, _ = _probe_problem(32)
    ref = bench_packed3.mxu_probe(jnp.asarray(W), jnp.asarray(H), variant="chain3_tile",
                                  block_m=BM, mxu_dtype=MXU[mxu][0])
    plan = cs.plan_w_split(M, N, K, n_sm, n_out=2)
    assert plan.nsplit > 1 and plan.scratch == (plan.nsplit, 2 * K, M)
    fn = lambda Hc, n_r: pr.mxu_probe_plain(torch.tensor(W), Hc, variant="chain3_tile",
                                            block_m=BM, mxu_dtype=MXU[mxu][1])
    got = _split_sum(fn, torch.tensor(H), (), N, plan.chunks)
    for g, r in zip(got, ref):
        _close(g, r)


# ------------------------------------------------- the SASS comparison tool
def test_sass_diff_parses_kernels_and_drops_path_tags():
    from nbmf_mm_tpu_torch.tools.sass_diff import parse_sass

    def dump(tag, pad):
        return (f"\nFatbin elf code:\n================\narch = sm_90a\ncode for sm_90a\n"
                f"\tFunction : _ZN41_GLOBAL__N__{tag}_9_probes_cu_6ccab7ce12hloss_kernelEv\n"
                f"\t.headerflags @\"EF_CUDA_SM90\"\n"
                f"        /*0000*/  MOV R1, c[0x0][0x28] ;{pad}/* 0x00000a00ff017624 */\n"
                f"        ..........\n"
                f"\tFunction : _ZN41_GLOBAL__N__{tag}_9_probes_cu_6ccab7ce8sum_partsEv\n"
                f"        /*0000*/  EXIT ;\n")

    a, b = parse_sass(dump("6b2d74c9", "  ")), parse_sass(dump("0badf00d", "     "))
    assert a == b
    assert set(a) == {"_ZN41_GLOBAL__N__probes_cu12hloss_kernelEv",
                      "_ZN41_GLOBAL__N__probes_cu8sum_partsEv"}
    assert "MOV R1" in a["_ZN41_GLOBAL__N__probes_cu12hloss_kernelEv"]


def test_sass_diff_keeps_the_next_objects_header_out_of_the_last_kernel():
    """A library of several objects: the headers that open the next object
    do not belong to the kernel listed before them."""
    from nbmf_mm_tpu_torch.tools.sass_diff import parse_sass

    header = ("\nFatbin elf code:\n================\narch = sm_90a\ncode version = [1,7]\n"
              "host = linux\ncompile_size = 64bit\n\n\tcode for sm_90a\n")
    kernel = "\t\tFunction : sum_splits_kernel\n        /*0000*/  EXIT ;\n        ..........\n"
    assert parse_sass(header + kernel) == parse_sass(header + kernel + header)


def test_wpass_tune_variants_edit_the_current_source():
    """The tuning tool's text edits still match the kernel source, and each
    variant keeps its braces balanced."""
    from nbmf_mm_tpu_torch.ops import _build
    from nbmf_mm_tpu_torch.tools.wpass_tune import variants

    header = (_build.CSRC / "sweep_kernels.cuh").read_text()
    texts = variants(header)
    assert set(texts) == {"production", "one_group", "phase_a_x0", "phase_b_x0", "hold_h",
                          "row_by_row"}
    assert texts["production"] == header
    for name, text in texts.items():
        assert text.count("{") == text.count("}"), name
        assert name == "production" or text != header


# ------------------------------------------------- a leading lane axis on K2
# Batched factors over shared words: lane r of the wrapper on CPU tensors
# equals the unbatched call bitwise; against the JAX K2 under jax.vmap in
# interpret mode (float64) the bar is 1e-10 of max |JAX|.
TOL_VMAP = 1e-10


def _lane_factors(k, m, n, Mp, Np, R, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    pairs = [_factors(rng, k, m, n, Mp, Np) for _ in range(R)]
    return (np.stack([w for w, _ in pairs]).astype(dtype),
            np.stack([h for _, h in pairs]).astype(dtype))


@pytest.mark.parametrize("R", [1, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["none", "parity", "corrected"])
@pytest.mark.parametrize("m, n", [(500, 250), (300, 70), (40, 30)],
                         ids=["two-stripes", "m300-jax-rejects", "one-stripe"])
def test_batched_k2_lane_equals_unbatched_bitwise(m, n, mode, dtype, R):
    bm, Mp, Np = cs.plan_packing(m, n)
    rng = np.random.default_rng(m + n)
    Y = (rng.random((m, n)) < 0.35).astype(np.float64)
    mask = rng.random((m, n)) < 0.75
    pad = lambda A: np.pad(A, ((0, Mp - m), (0, Np - n)))
    words = _t(cs.pack_bits_host(pad(Y if mode == "none" else Y * mask), bm))
    words2 = None if mode == "none" else _t(cs.pack_bits_host(pad((1 - Y) * mask), bm))
    W, H = map(torch.tensor, _lane_factors(4, m, n, Mp, Np, R, 9, dtype))
    T = cs.w_terms_packed(W, H, words, words2, eps=EPS, n_real=n, bm=bm)
    assert T.shape == (R, 4, Mp) and T.dtype == W.dtype
    for r in range(R):
        assert torch.equal(T[r], cs.w_terms_packed(W[r], H[r], words, words2, eps=EPS,
                                                   n_real=n, bm=bm))


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("mode", ["none", "parity", "corrected"])
def test_batched_k2_matches_pallas_under_vmap(mode, R):
    c = _packed_case(mode)
    k, Mp = c["W"].shape
    Np = c["H"].shape[1]
    Wb, Hb = _lane_factors(k, 240, c["n"], Mp, Np, R, 10)
    words, words2 = jnp.asarray(c["words"]), (None if c["words2"] is None
                                              else jnp.asarray(c["words2"]))
    T_j = jax.vmap(lambda W, H: ps.w_terms_packed(
        W, H, words, words2, n_real=c["n"], eps=EPS, block_m=c["bm"], interpret=True))(
            jnp.asarray(Wb), jnp.asarray(Hb))
    T = cs.w_terms_packed(_t(Wb), _t(Hb), _t(c["words"]), _t(c["words2"]), eps=EPS,
                          n_real=c["n"], bm=c["bm"])
    assert T.shape == (R, k, Mp)
    assert _rel(T, T_j) <= TOL_VMAP
