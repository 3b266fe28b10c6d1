"""Packed and sparse input of the port: ``PackedMatrix``, the packers, and
``solve``/``NBMF.fit`` on words and on ``scipy.sparse`` data.

Against the JAX package at shapes its planner takes, the packers give its
words bit for bit over the common columns (it pads the columns to a multiple
of 128, the port to 4).  Inside the port, every input kind gives the
dense-input result bitwise, also at shapes the JAX planner rejects.  Solves
run on the CPU with ``backend="fused"``, so the kernels' plain versions run.
Against the JAX ``solve`` on the Pallas kernels in interpret mode, with
explicit inits, over 10 float32 sweeps: losses within 1e-5 relative, factors
within 1e-4 absolute (float32 sums in another order; the port masks the
loss's pad entries exactly, the JAX packed kernel adds ``log(1 + eps)`` each).
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.ops import packed as jpacked
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import packed as ppacked
from nbmf_mm_tpu_torch.ops.packed import binary_as_uint8
from nbmf_mm_tpu_torch.solver import driver as port_driver
from nbmf_mm_tpu_torch.utils.interop import packed_from_reference

torch.set_num_threads(1)

K = 4
REF_SHAPES = [(256, 200), (500, 130), (128, 128)]  # the JAX planner takes these
PORT_SHAPES = [(300, 200), (1226, 285), (40, 33)]  # and rejects the first of these
FUSED = dict(backend="fused", dtype="float32", device="cpu", random_state=0)
LOSS_RTOL, FACTOR_ATOL = 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def _data(m, n, density=0.3):
    rng = np.random.default_rng(m * 1000 + n)
    Y = (rng.random((m, n)) < density).astype(np.float32)
    mask = (rng.random((m, n)) < 0.8).astype(np.float32)
    return Y, mask


def _same(a, b):
    assert a.n_iter == b.n_iter and a.converged == b.converged
    assert a.losses == b.losses
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)


def _ref_words(pm, Np):
    """The JAX words over the port's columns; its other pad columns are 0."""
    words = np.asarray(pm.words)
    assert not words[:, Np:].any()
    return words[:, :Np]


# ------------------------------------------------- packers against the JAX ones
@pytest.mark.parametrize("m, n", REF_SHAPES)
def test_geometry_shares_rows_and_stripe_with_jax(m, n):
    Mp, Np, bm = ppacked.plan_packing(m, n, K)
    ref = jref.pack_matrix(_data(m, n)[0], K)
    assert ref.padded_shape[0] == Mp and Np == cs.round_up(n, 4) <= ref.padded_shape[1]
    assert (bm, Mp, Np) == cs.plan_packing(m, n)


@pytest.mark.parametrize("m, n", REF_SHAPES)
def test_pack_matrix_gives_the_jax_words(m, n):
    Y = _data(m, n)[0]
    ref = jref.pack_matrix(Y, K)
    for source in (Y, Y.astype(bool), torch.tensor(Y), torch.tensor(Y, dtype=torch.float64)):
        pm = port.pack_matrix(source, K, device="cpu")
        assert pm.shape == (m, n) and pm.words.dtype == torch.int32
        assert pm.nbytes == pm.words.numel() * 4
        np.testing.assert_array_equal(pm.words.numpy(), _ref_words(ref, pm.words.shape[1]))
        np.testing.assert_array_equal(pm.unpack().numpy(), Y)
        np.testing.assert_array_equal(pm.unpack().numpy(), np.asarray(ref.unpack()))


@pytest.mark.parametrize("chunk_rows", [None, 100, 256, 1000])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("m, n", REF_SHAPES)
def test_pack_matrix_chunked_gives_the_jax_words(m, n, kind, chunk_rows):
    Y = _data(m, n)[0]
    source = Y if kind == "numpy" else torch.tensor(Y)
    calls = []

    def row_chunk(a, b):
        calls.append((a, b))
        return source[a:b]

    pm = port.pack_matrix_chunked(row_chunk, m, n, K, chunk_rows=chunk_rows, device="cpu")
    ref = jref.pack_matrix_chunked(lambda a, b: Y[a:b], m, n, K, chunk_rows=chunk_rows)
    np.testing.assert_array_equal(pm.words.numpy(), _ref_words(ref, pm.words.shape[1]))
    assert torch.equal(pm.words, port.pack_matrix(Y, K, device="cpu").words)
    assert pm.words.is_contiguous() and pm.words.data_ptr() % 16 == 0
    # Chunk heights are whole stripes, and the chunks tile the real rows.
    assert all(a % pm.block_m == 0 for a, _ in calls)
    assert calls[0][0] == 0 and calls[-1][1] == m
    assert all(prev[1] == nxt[0] for prev, nxt in zip(calls, calls[1:]))


@pytest.mark.parametrize("chunk_rows", [None, 64, 256])
@pytest.mark.parametrize("m, n", REF_SHAPES)
def test_pack_matrix_sparse_gives_the_jax_words(m, n, chunk_rows):
    Y = _data(m, n)[0]
    dense = port.pack_matrix(Y, K, device="cpu")
    ref = jref.pack_matrix_sparse(sp.csr_matrix(Y), K, chunk_rows=chunk_rows)
    for S in (sp.csr_matrix(Y), sp.coo_matrix(Y), sp.csc_matrix(Y), sp.lil_matrix(Y)):
        pm = port.pack_matrix_sparse(S, K, chunk_rows=chunk_rows, device="cpu")
        assert torch.equal(pm.words, dense.words) and pm.block_m == dense.block_m
        np.testing.assert_array_equal(pm.words.numpy(), _ref_words(ref, pm.words.shape[1]))


@pytest.mark.parametrize("complement", [False, True])
@pytest.mark.parametrize("chunk_rows", [None, 100, 256, 300])
@pytest.mark.parametrize("m, n", REF_SHAPES)
def test_pack_sparse_words_gives_the_jax_words(m, n, chunk_rows, complement):
    Y = _data(m, n)[0]
    S = sp.csr_matrix(Y)
    Mp, Np, bm = ppacked.plan_packing(m, n, K)
    words = ppacked.pack_sparse_words(S, Mp, Np, bm, complement=complement,
                                      chunk_rows=chunk_rows)
    padded = np.zeros((Mp, Np), dtype=np.uint8)
    padded[:m, :n] = (1 - Y) if complement else Y
    np.testing.assert_array_equal(words, cs.pack_bits_host(padded, bm))
    ref_pm = jref.pack_matrix(Y, K)
    ref = jpacked.pack_sparse_words(S, Mp, ref_pm.padded_shape[1], ref_pm.block_m,
                                    complement=complement, chunk_rows=chunk_rows)
    assert not ref[:, Np:].any()
    np.testing.assert_array_equal(words, ref[:, :Np])


@pytest.mark.parametrize("m, n, route", [(256, 200, "crop"), (500, 130, "crop"),
                                         (128, 128, "crop"), (600, 70, "crop"),
                                         (40, 33, "repack"), (200, 50, "repack")])
def test_packed_from_reference_round_trips(m, n, route):
    Y = _data(m, n)[0]
    ref = jref.pack_matrix(Y, K)
    ours = port.pack_matrix(Y, K, device="cpu")
    eff = cs.round_up(min(ref.block_m, cs.round_up(ref.padded_shape[0], 128)), 128)
    assert (eff == ours.block_m) == (route == "crop")
    pm = packed_from_reference(np.asarray(ref.words), ref.shape, ref.block_m, device="cpu")
    assert pm.shape == (m, n) and pm.block_m == ours.block_m
    assert torch.equal(pm.words, ours.words)
    np.testing.assert_array_equal(pm.unpack().numpy(), np.asarray(ref.unpack()))
    res = port.solve(pm, K, max_iter=3, **FUSED)
    _same(res, port.solve(Y, K, max_iter=3, **FUSED))


def test_packed_from_reference_rejects_bad_words():
    ref = jref.pack_matrix(_data(256, 200)[0], K)
    words = np.asarray(ref.words).copy()
    with pytest.raises(TypeError, match="int32"):
        packed_from_reference(words.astype(np.int64), ref.shape, ref.block_m, device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        packed_from_reference(words[:, :100], ref.shape, ref.block_m, device="cpu")
    words[0, 250] = 1
    with pytest.raises(ValueError, match="not zero"):
        packed_from_reference(words, ref.shape, ref.block_m, device="cpu")


def test_solve_names_the_converter_for_a_jax_packed_matrix():
    ref = jref.pack_matrix(_data(256, 200)[0], K)
    with pytest.raises(TypeError, match="packed_from_reference"):
        port.solve(ref, K, max_iter=2, **FUSED)


# ------------------------------------------ inside the port: bitwise to dense
@functools.lru_cache(maxsize=None)
def _dense_solve(m, n, mask_mode=None, max_iter=6):
    Y, mask = _data(m, n)
    kw = {} if mask_mode is None else dict(mask=mask, mask_mode=mask_mode)
    return port.solve(Y, K, max_iter=max_iter, **kw, **FUSED)


@pytest.mark.parametrize("m, n", PORT_SHAPES)
def test_the_jax_planner_rejects_what_the_port_packs(m, n):
    if (m, n) == (300, 200):  # its Mp = 384 is no multiple of the 256-row stripe
        with pytest.raises(ValueError, match="stripe"):
            jpacked.plan_packing(m, n, K)
    else:
        jpacked.plan_packing(m, n, K)
    Mp, Np, bm = ppacked.plan_packing(m, n, K)
    assert Mp % bm == 0 and Mp >= m and Np % 4 == 0


@pytest.mark.parametrize("m, n", PORT_SHAPES)
def test_packers_agree_at_port_shapes(m, n):
    Y = _data(m, n)[0]
    bm, Mp, Np = cs.plan_packing(m, n)
    padded = np.zeros((Mp, Np), dtype=np.float32)
    padded[:m, :n] = Y
    want = cs.pack_bits(torch.tensor(padded), bm)
    packs = {
        "pack_matrix numpy": port.pack_matrix(Y, K, device="cpu"),
        "pack_matrix tensor": port.pack_matrix(torch.tensor(Y), device="cpu"),
        "sparse": port.pack_matrix_sparse(sp.csr_matrix(Y), K, chunk_rows=70, device="cpu"),
        "chunked numpy": port.pack_matrix_chunked(lambda a, b: Y[a:b], m, n, K, chunk_rows=100,
                                                  device="cpu"),
        "chunked tensor": port.pack_matrix_chunked(lambda a, b: torch.tensor(Y[a:b]), m, n,
                                                   chunk_rows=257, validate=False,
                                                   device="cpu"),
    }
    for name, pm in packs.items():
        assert torch.equal(pm.words, want), name
        assert pm.block_m == bm and pm.padded_shape == (Mp, Np) and pm.shape == (m, n)
        np.testing.assert_array_equal(pm.unpack().numpy(), Y)


@pytest.mark.parametrize("m, n", PORT_SHAPES)
def test_solve_packed_matrix_equals_dense(m, n):
    pm = port.pack_matrix(_data(m, n)[0], K, device="cpu")
    res = port.solve(pm, K, max_iter=6, **FUSED)
    assert res.extras == {"backend": "fused", "packed": True}
    _same(res, _dense_solve(m, n))
    _same(port.solve(pm, K, max_iter=6, packed=True, **FUSED), res)


@pytest.mark.parametrize("fmt", ["csr", "coo", "csc"])
@pytest.mark.parametrize("m, n", PORT_SHAPES)
def test_solve_sparse_equals_dense(m, n, fmt):
    S = sp.csr_matrix(_data(m, n)[0]).asformat(fmt)
    res = port.solve(S, K, max_iter=6, **FUSED)
    assert res.extras == {"backend": "fused", "packed": True}
    _same(res, _dense_solve(m, n))


@pytest.mark.parametrize("mask_mode", ["parity", "corrected"])
@pytest.mark.parametrize("m, n", PORT_SHAPES)
def test_solve_sparse_under_sparse_mask_equals_dense(m, n, mask_mode, monkeypatch):
    Y, mask = _data(m, n)
    dense = _dense_solve(m, n, mask_mode)
    monkeypatch.setattr(port_driver, "_stage_dense", None)  # no dense staging on this route
    res = port.solve(sp.csr_matrix(Y), K, max_iter=6, mask=sp.csc_matrix(mask),
                     mask_mode=mask_mode, **FUSED)
    assert res.extras == {"backend": "fused", "packed": True}
    _same(res, dense)


def test_sparse_inputs_never_stage_dense(monkeypatch):
    m, n = 300, 200
    dense = _dense_solve(m, n)
    monkeypatch.setattr(port_driver, "_stage_dense", None)
    monkeypatch.setattr(port_driver, "_to_tensor", None)
    S = sp.csr_matrix(_data(m, n)[0])
    _same(port.solve(S, K, max_iter=6, **FUSED), dense)
    pm = port.pack_matrix_sparse(S, K, device="cpu")
    _same(port.solve(pm, K, max_iter=6, **FUSED), dense)


def test_sparse_mask_observed_count_comes_from_the_csr():
    m, n = 300, 200
    Y, mask = _data(m, n)
    # Duplicate mask entries that sum to one stored 1 each: still n_obs nonzeros.
    M = sp.csr_matrix(mask)
    res = port.solve(sp.csr_matrix(Y), K, max_iter=6, mask=M, **FUSED)
    _same(res, _dense_solve(m, n, "parity"))
    # An explicit stored zero in the mask is not an observed entry.
    rows, cols = np.nonzero(mask == 0)
    M0 = sp.csr_matrix((np.r_[M.tocoo().data, 0.0], (np.r_[M.tocoo().row, rows[0]],
                                                      np.r_[M.tocoo().col, cols[0]])),
                       shape=(m, n))
    assert M0.nnz == M.nnz + 1
    _same(port.solve(sp.csr_matrix(Y), K, max_iter=6, mask=M0, **FUSED), res)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(orientation="dir-beta"),
        dict(dtype="float64"),
        dict(backend="plain"),
        dict(packed=False),
        dict(dense_mask=True),
        dict(dense_mask=True, mask_mode="corrected"),
    ],
    ids=["dir-beta", "float64", "plain", "packed-False", "dense-mask", "dense-mask-corrected"],
)
def test_densified_routings_equal_dense_input(kwargs):
    m, n = 300, 200
    Y, mask = _data(m, n)
    kw = dict(FUSED, max_iter=5)
    kw.update(kwargs)
    if kw.pop("dense_mask", False):
        kw["mask"] = mask
    dense = port.solve(Y, K, **kw)
    sparse = port.solve(sp.csr_matrix(Y), K, **kw)
    assert sparse.extras == dense.extras
    _same(sparse, dense)


def test_sparse_mask_with_dense_data_densifies():
    m, n = 300, 200
    Y, mask = _data(m, n)
    _same(port.solve(Y, K, max_iter=6, mask=sp.csr_matrix(mask), **FUSED),
          _dense_solve(m, n, "parity"))


def test_duck_typed_toarray_densifies():
    class Lazy:
        shape = (300, 200)

        def toarray(self):
            return _data(300, 200)[0]

    _same(port.solve(Lazy(), K, max_iter=6, **FUSED), _dense_solve(300, 200))


def test_nonbinary_sparse_densifies_unless_packed_is_demanded():
    Y = _data(300, 200)[0]
    S = sp.csr_matrix(Y * 0.5)
    res = port.solve(S, K, max_iter=4, **FUSED)
    assert res.extras["packed"] is False
    _same(res, port.solve(Y * 0.5, K, max_iter=4, **FUSED))
    with pytest.raises(ValueError, match="binary"):
        port.solve(sp.csr_matrix(Y * 3.0), K, max_iter=4, packed=True, **FUSED)
    M = sp.csr_matrix(_data(300, 200)[1] * 0.5)
    res = port.solve(sp.csr_matrix(Y), K, max_iter=4, mask=M, **FUSED)
    assert res.extras["packed"] is False
    _same(res, port.solve(Y, K, max_iter=4, mask=M.toarray(), **FUSED))
    with pytest.raises(ValueError, match="binary"):
        port.solve(sp.csr_matrix(Y), K, max_iter=4, mask=M, packed=True, **FUSED)


# The three ways from host numpy operands to words on a device.  ``solve``
# takes the first; chip_smoke.py times all three on the card.
HOST_STAGINGS = ("f32-device", "host", "u8-device")


def _stage_host(Y, mask, how, *, Mp, Np, bm):
    """Words ``(Y1, Y2)`` of host operands, or None when they are not exactly
    binary after masking: the float32 operands through ``solve``'s own
    staging; or scanned on the host and packed there; or scanned on the host,
    moved as uint8 and packed on the device (the CPU here)."""
    if how == "f32-device":
        Y1, Y2, binary = port_driver._stage_dense(
            torch.from_numpy(Y), None if mask is None else torch.from_numpy(mask),
            Mp=Mp, Np=Np, bm=bm, packed=None)
        return (Y1, Y2) if binary else None
    operands = [binary_as_uint8(A) for A in port_driver._masked_operands(Y, mask)
                if A is not None]
    if any(U is None for U in operands):
        return None
    if how == "host":
        staged = [torch.from_numpy(ppacked._pack_host(U, Mp, Np, bm)) for U in operands]
    else:
        staged = [ppacked._pack_tensor(torch.from_numpy(U), Mp, Np, bm) for U in operands]
    return staged[0], staged[1] if mask is not None else None


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("m, n", PORT_SHAPES)
def test_host_stagings_give_identical_words(m, n, masked):
    Y, mask = _data(m, n)
    mask = mask if masked else None
    bm, Mp, Np = cs.plan_packing(m, n)
    kw = dict(Mp=Mp, Np=Np, bm=bm)
    staged = {how: _stage_host(Y, mask, how, **kw) for how in HOST_STAGINGS}
    Y1, Y2, use_packed = port_driver._stage_dense(
        torch.tensor(Y), None if mask is None else torch.tensor(mask), packed=None, **kw)
    assert use_packed and (Y2 is not None) == masked
    for how, (A, B) in staged.items():
        assert torch.equal(A, Y1), how
        assert (B is None and Y2 is None) or torch.equal(B, Y2), how
        assert A.is_contiguous() and A.dtype == torch.int32 and A.shape == (Mp // 32, Np)


@pytest.mark.parametrize("how", HOST_STAGINGS)
def test_host_stagings_decline_nonbinary_operands(how):
    Y, mask = _data(300, 200)
    bm, Mp, Np = cs.plan_packing(300, 200)
    kw = dict(Mp=Mp, Np=Np, bm=bm)
    assert _stage_host(Y * 0.5, None, how, **kw) is None
    assert _stage_host(Y, mask * 0.5, how, **kw) is None
    # Values at unobserved entries do not matter.
    soft = np.where(mask == 0, 0.5, Y).astype(np.float32)
    got = _stage_host(soft, mask, how, **kw)
    want = _stage_host(Y, mask, how, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("m, n", PORT_SHAPES)
def test_fit_matches_dense_on_all_input_kinds(m, n):
    Y = _data(m, n)[0]
    params = dict(n_components=K, max_iter=6, backend="fused", dtype="float32", device="cpu",
                  random_state=0)
    dense = port.NBMF(**params).fit(Y)
    for X in (sp.csr_matrix(Y), port.pack_matrix(Y, K, device="cpu")):
        est = port.NBMF(**params).fit(X)
        assert est.solver_result_.extras == {"backend": "fused", "packed": True}
        np.testing.assert_array_equal(est.W_, dense.W_)
        np.testing.assert_array_equal(est.components_, dense.components_)
        assert est.loss_curve_ == dense.loss_curve_ and est.n_iter_ == dense.n_iter_


def test_fit_sparse_under_sparse_mask_and_range_check():
    m, n = 300, 200
    Y, mask = _data(m, n)
    params = dict(n_components=K, max_iter=6, backend="fused", dtype="float32", device="cpu",
                  random_state=0)
    dense = port.NBMF(**params).fit(Y, mask=mask)
    est = port.NBMF(**params).fit(sp.csr_matrix(Y), mask=sp.csr_matrix(mask))
    np.testing.assert_array_equal(est.W_, dense.W_)
    assert est.loss_curve_ == dense.loss_curve_
    with pytest.raises(ValueError, match="X must be binary"):
        port.NBMF(**params).fit(sp.csr_matrix(Y * 2.0))
    # transform and score go on densifying sparse requests whole.
    np.testing.assert_array_equal(est.transform(sp.csr_matrix(Y[:20])), est.transform(Y[:20]))


# ------------------------------------------ against the JAX solve, Pallas interpret
def _inits(m, n):
    rng = np.random.default_rng(7)
    return (rng.uniform(0.1, 0.9, (m, K)).astype(np.float32),
            rng.uniform(0.1, 0.9, (K, n)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_solve(m, n, mask_mode):
    Y, mask = _data(m, n)
    W0, H0 = _inits(m, n)
    kw = {} if mask_mode is None else dict(mask=mask, mask_mode=mask_mode)
    return jref.solve(Y, K, max_iter=10, tol=0.0, W_init=W0, H_init=H0, dtype="float32",
                      backend="pallas", pallas_interpret=True, **kw)


def _close_to_jax(res, ref):
    assert ref.n_iter == res.n_iter == 10
    np.testing.assert_allclose(res.losses, np.asarray(ref.losses), rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(res.W, ref.W, rtol=0, atol=FACTOR_ATOL)
    np.testing.assert_allclose(res.H, ref.H, rtol=0, atol=FACTOR_ATOL)


@pytest.mark.parametrize("kind", ["packed", "sparse", "from-reference"])
@pytest.mark.parametrize("m, n", [(256, 200), (128, 128)])
def test_solve_on_words_close_to_jax_pallas(m, n, kind):
    Y = _data(m, n)[0]
    W0, H0 = _inits(m, n)
    if kind == "packed":
        X = port.pack_matrix(Y, K, device="cpu")
    elif kind == "sparse":
        X = sp.csr_matrix(Y)
    else:
        ref_pm = jref.pack_matrix(Y, K)
        X = packed_from_reference(np.asarray(ref_pm.words), ref_pm.shape, ref_pm.block_m,
                                  device="cpu")
    res = port.solve(X, K, max_iter=10, tol=0.0, W_init=W0, H_init=H0,
                     **dict(FUSED, random_state=None))
    assert res.extras["packed"] is True
    _close_to_jax(res, _jax_solve(m, n, None))


@pytest.mark.parametrize("mask_mode", ["parity", "corrected"])
def test_sparse_masked_solve_close_to_jax_pallas(mask_mode):
    m, n = 256, 200
    Y, mask = _data(m, n)
    W0, H0 = _inits(m, n)
    res = port.solve(sp.csr_matrix(Y), K, max_iter=10, tol=0.0, W_init=W0, H_init=H0,
                     mask=sp.csr_matrix(mask), mask_mode=mask_mode,
                     **dict(FUSED, random_state=None))
    assert res.extras["packed"] is True
    _close_to_jax(res, _jax_solve(m, n, mask_mode))


# ------------------------------------------------------------ contract errors
def test_packed_input_contract_errors():
    Y = _data(128, 128)[0]
    pm = port.pack_matrix(Y, 3, device="cpu")
    kw = dict(backend="fused", device="cpu", max_iter=2)
    with pytest.raises(ValueError, match="beta-dir"):
        port.solve(pm, 3, orientation="dir-beta", **kw)
    with pytest.raises(ValueError, match="mask"):
        port.solve(pm, 3, mask=np.ones((128, 128)), **kw)
    with pytest.raises(ValueError, match="packed=False"):
        port.solve(pm, 3, packed=False, **kw)
    with pytest.raises(ValueError, match="float32"):
        port.solve(pm, 3, dtype="float64", **kw)
    with pytest.raises(ValueError, match="fused loop"):
        port.solve(pm, 3, backend="plain", device="cpu")
    with pytest.raises(ValueError, match="fused loop"):
        port.solve(pm, 3, backend="auto", device="cpu")  # auto is the plain loop on the CPU
    with pytest.raises(ValueError, match=str(cs.MAX_RANK)):
        port.solve(pm, cs.MAX_RANK + 1, **kw)
    # Words packed for another stripe height, another padding or another type.
    for bad in (port.PackedMatrix(words=pm.words, shape=pm.shape, block_m=64),
                port.PackedMatrix(words=pm.words, shape=(100, 100), block_m=pm.block_m),
                port.PackedMatrix(words=pm.words[:, :64], shape=pm.shape, block_m=pm.block_m),
                port.PackedMatrix(words=pm.words.long(), shape=pm.shape, block_m=pm.block_m)):
        with pytest.raises(ValueError, match="PackedMatrix"):
            port.solve(bad, 3, **kw)
    with pytest.raises(ValueError, match="binary"):
        port.pack_matrix(Y + 0.5, 3, device="cpu")
    with pytest.raises(ValueError, match="binary"):
        port.pack_matrix(torch.tensor(Y) * 2, 3, device="cpu")
    with pytest.raises(ValueError, match="packed=True"):
        port.solve(Y * 0.5, 3, packed=True, **kw)


def test_fit_packed_matrix_keeps_the_contract():
    pm = port.pack_matrix(_data(128, 128)[0], 3, device="cpu")
    with pytest.raises(ValueError, match="beta-dir"):
        port.NBMF(n_components=3, orientation="dir-beta", backend="fused", device="cpu").fit(pm)
    with pytest.raises(ValueError, match="mask"):
        port.NBMF(n_components=3, backend="fused", device="cpu").fit(pm, mask=np.ones((128, 128)))


@pytest.mark.parametrize("block_m, block_n, ok", [(None, None, True), (256, None, True),
                                                   (None, 4, True), (None, 100, True),
                                                   (128, None, False), (512, None, False),
                                                   (None, 128, False)])
def test_plan_packing_takes_only_its_own_blocks(block_m, block_n, ok):
    if ok:
        assert ppacked.plan_packing(300, 200, K, block_m=block_m, block_n=block_n) == (
            512, 200, 256)
        return
    with pytest.raises(ValueError, match="plan"):
        ppacked.plan_packing(300, 200, K, block_m=block_m, block_n=block_n)
    with pytest.raises(ValueError, match="plan"):
        port.pack_matrix(_data(300, 200)[0], K, block_m=block_m, block_n=block_n, device="cpu")


def test_pack_matrix_sparse_contract():
    Y = _data(300, 200, 0.05)[0]
    S = sp.csr_matrix(Y)
    want = port.pack_matrix(Y, K, device="cpu").words
    with pytest.raises(ValueError, match="binary"):
        port.pack_matrix_sparse(sp.csr_matrix(Y * 3.0), K, device="cpu")
    with pytest.raises(TypeError, match="scipy.sparse"):
        port.pack_matrix_sparse(Y, K, device="cpu")
    # Explicit stored zeros are legal.
    S0 = S.copy().tolil()
    S0[0, 0] = 0.0
    S0 = S0.tocsr()
    assert torch.equal(port.pack_matrix_sparse(S0, K, device="cpu").words, want)
    # Duplicate entries sum in the dense view: two stored halves are one bit,
    # two stored ones are a 2 and rejected; the inputs stay as they were.
    halves = sp.csr_matrix((np.full(2, 0.5, np.float32), np.zeros(2, np.int32),
                            np.array([0, 2] + [2] * 299, np.int32)), shape=(300, 200))
    ones = sp.csr_matrix((np.ones(2, np.float32), np.zeros(2, np.int32),
                          np.array([0, 2] + [2] * 299, np.int32)), shape=(300, 200))
    assert not halves.has_canonical_format and not ones.has_canonical_format
    pm = port.pack_matrix_sparse(halves, K, device="cpu")
    assert float(pm.unpack().sum()) == 1.0 and float(pm.unpack()[0, 0]) == 1.0
    with pytest.raises(ValueError, match="binary"):
        port.pack_matrix_sparse(ones, K, device="cpu")
    with pytest.raises(ValueError, match="binary"):
        port.solve(ones, K, max_iter=2, packed=True, **FUSED)
    for S_dup in (halves, ones):
        assert S_dup.nnz == 2 and not S_dup.has_canonical_format
    assert ppacked.csr_binary_canonical(ones) is None
    assert ppacked.csr_binary_canonical(halves).nnz == 1


def test_chunked_packer_contract():
    m, n = 300, 200
    Y = _data(m, n)[0]
    with pytest.raises(ValueError, match="returned shape"):
        port.pack_matrix_chunked(lambda a, b: Y[a:b, :-1], m, n, K, device="cpu")
    with pytest.raises(ValueError, match="not exactly binary"):
        port.pack_matrix_chunked(lambda a, b: Y[a:b] * 0.5, m, n, K, device="cpu")
    with pytest.raises(ValueError, match="not exactly binary"):
        port.pack_matrix_chunked(lambda a, b: torch.tensor(Y[a:b]) * 2, m, n, K, device="cpu")
    # A chunk wholly inside the row padding is never asked for.
    calls = []
    pm = port.pack_matrix_chunked(lambda a, b: calls.append((a, b)) or Y[a:b], 257, n, K,
                                  chunk_rows=256, device="cpu")
    assert calls == [(0, 256), (256, 257)] and pm.padded_shape == (512, 200)
    tall = port.pack_matrix_chunked(lambda a, b: Y[a:b], 200, n, chunk_rows=32, device="cpu")
    assert tall.block_m == 224 and torch.equal(tall.words,
                                               port.pack_matrix(Y[:200], device="cpu").words)


def test_inputs_are_never_mutated():
    Y, mask = _data(300, 200)
    S, M = sp.csr_matrix(Y), sp.coo_matrix(mask)
    pm = port.pack_matrix(Y, K, device="cpu")
    before = (Y.copy(), S.copy(), M.copy(), pm.words.clone())
    port.solve(S, K, max_iter=3, mask=M, **FUSED)
    port.solve(S, K, max_iter=3, **FUSED)
    port.solve(pm, K, max_iter=3, **FUSED)
    port.pack_matrix_sparse(S, K, device="cpu")
    np.testing.assert_array_equal(Y, before[0])
    assert (S != before[1]).nnz == 0 and S.format == "csr"
    assert (M.tocsr() != before[2].tocsr()).nnz == 0 and M.format == "coo"
    assert torch.equal(pm.words, before[3])
    with pytest.raises(Exception):
        pm.block_m = 64  # frozen


# ------------------------------------------------------------ device results
@pytest.mark.parametrize("orientation", ["beta-dir", "dir-beta"])
@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_device_results_equal_the_numpy_results(backend, orientation):
    Y = _data(300, 200)[0]
    kw = dict(max_iter=6, backend=backend, orientation=orientation, dtype="float32",
              device="cpu", random_state=0)
    host = port.solve(Y, K, **kw)
    dev = port.solve(Y, K, device_results=True, **kw)
    assert all(isinstance(t, torch.Tensor) for t in (dev.W, dev.H, dev.losses))
    np.testing.assert_array_equal(dev.W.numpy(), host.W)
    np.testing.assert_array_equal(dev.H.numpy(), host.H)
    assert [float(x) for x in dev.losses] == host.losses
    assert (dev.n_iter, dev.converged, dev.extras) == (host.n_iter, host.converged, host.extras)


def test_device_results_on_words_and_at_max_iter_zero():
    Y = _data(300, 200)[0]
    pm = port.pack_matrix(Y, K, device="cpu")
    dev = port.solve(pm, K, max_iter=6, device_results=True, **FUSED)
    np.testing.assert_array_equal(dev.W.numpy(), _dense_solve(300, 200).W)
    simplex = dev.W.sum(dim=1)
    assert float((simplex - 1).abs().max()) < 1e-6
    empty = port.solve(pm, K, max_iter=0, device_results=True, **FUSED)
    assert empty.n_iter == 0 and empty.losses.numel() == 0 and empty.W.shape == (300, K)
    host = port.solve(pm, K, max_iter=0, **FUSED)
    assert host.losses == [] and np.array_equal(host.W, empty.W.numpy())


def test_fit_forwards_device_results():
    Y = _data(300, 200)[0]
    params = dict(n_components=K, max_iter=6, backend="fused", dtype="float32", device="cpu",
                  random_state=0)
    est = port.NBMF(**params, solver_options={"device_results": True}).fit(sp.csr_matrix(Y))
    ref = port.NBMF(**params).fit(Y)
    assert isinstance(est.W_, torch.Tensor) and isinstance(est.loss_curve_, torch.Tensor)
    np.testing.assert_array_equal(est.W_.numpy(), ref.W_)
    assert float(est.loss_) == ref.loss_
