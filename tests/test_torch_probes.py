"""The port's measurement probes (their plain versions, which CPU tensors
take) against the Pallas probes of the repository's ``tools/`` scripts, run
in interpret mode on the CPU, and the port's measurement harness.

The ``tools/`` probes take ``interpret=`` only in part, so every test runs
them with ``pallas_call`` patched to interpret mode; nothing in ``tools/``
changes.  JAX runs with x64 off (``unpack_concat_sign`` cannot store its
f64 select into an f32 ref under x64).  Inputs are made with numpy from a
seed; the factors sit on a coarse grid (W in 1/64, H in 1/16 steps), so
``WH`` is exact in f32 whatever the summation order and the bf16-rounded
matmul operands are the same in both packages.

Tolerances: terms within 1e-5 of max |JAX| (f32 sums in another order);
scalar sums within 1e-6 of sum |x| (JAX adds in f32 per stripe, the port in
f64).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import probes as pr
from nbmf_mm_tpu_torch.tools import bench_true
from tools import bench_diag, bench_packed, bench_packed2, bench_packed3, bench_stream, bench_vpu

torch.set_num_threads(1)

M, N, K = 512, 640, 8
BM = 256
TOL_TERMS = 1e-5
TOL_SUM = 1e-6
MXU = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def interpret_x32(monkeypatch):
    """Every pallas_call in interpret mode, and x64 off, for one test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    Y = (rng.random((M, N)) < 0.3).astype(np.float32)
    W = (rng.integers(1, 8, (K, M)) / 64).astype(np.float32)
    H = (rng.integers(2, 15, (K, N)) / 16).astype(np.float32)
    return dict(Y=Y, W=W, H=H, Yp=cs.pack_bits_host(Y, BM), Ypg=cs.pack_bits_host(Y, M))


def _close(port, ref, scale=None):
    """Each output of the port against JAX's: terms relative to max |JAX|,
    a scalar relative to ``scale`` (sum |x|; |JAX| where every term has one
    sign)."""
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p, r = np.asarray(p.float(), np.float64), np.asarray(r, np.float64)
        assert p.shape == r.shape or (p.size == r.size == 1)
        if r.size == 1:
            s = abs(float(r.ravel()[0])) if scale is None else scale
            assert abs(float(p.ravel()[0]) - float(r.ravel()[0])) <= TOL_SUM * s
        else:
            assert np.abs(p - r).max() <= TOL_TERMS * np.abs(r).max()


J = jnp.asarray
T = torch.tensor


# ------------------------------------------------------ packed H and W passes
@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("name, module", [("hloss_packed", bench_packed),
                                          ("hloss_packed2", bench_packed2)])
def test_hloss_packed_forms(name, module, mxu):
    c = _problem()
    ref = getattr(module, name)(J(c["W"]), J(c["H"]), J(c["Yp"]), block_m=BM,
                                mxu_dtype=MXU[mxu][0], interpret=True)
    out = getattr(pr, name)(T(c["W"]), T(c["H"]), T(c["Yp"]), block_m=BM, mxu_dtype=MXU[mxu][1])
    _close(out, ref)


@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("name, module", [("w_packed", bench_packed), ("w_packed2", bench_packed2)])
def test_w_packed_forms(name, module, mxu):
    c = _problem(1)
    n_real = N - 40  # Q masked to the real columns
    ref = getattr(module, name)(J(c["W"]), J(c["H"]), J(c["Yp"]), n_real=n_real, block_m=BM,
                                mxu_dtype=MXU[mxu][0], interpret=True)
    out = getattr(pr, name)(T(c["W"]), T(c["H"]), T(c["Yp"]), n_real=n_real, block_m=BM,
                            mxu_dtype=MXU[mxu][1])
    _close(out, ref)


@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_hloss_ngrid(packed, mxu):
    c = _problem(2)
    Y = c["Ypg"] if packed else c["Y"]
    ref = bench_packed3.hloss_ngrid(J(c["W"]), J(c["H"]), J(Y), block_n=128, packed=packed,
                                    mxu_dtype=MXU[mxu][0], interpret=True)
    out = pr.hloss_ngrid(T(c["W"]), T(c["H"]), T(Y), block_n=128, packed=packed,
                         mxu_dtype=MXU[mxu][1])
    _close(out, ref)


# ---------------------------------------------------------- matmul chains
@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("n_mm", [3, 2])
def test_mxu_only(n_mm, mxu):
    c = _problem(3)
    ref = bench_packed2.mxu_only(J(c["W"]), J(c["H"]), None, n_mm=n_mm, block_m=BM,
                                 mxu_dtype=MXU[mxu][0])
    out = pr.mxu_only(T(c["W"]), T(c["H"]), None, n_mm=n_mm, block_m=BM, mxu_dtype=MXU[mxu][1])
    _close(out, ref)


@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["chain3_acc", "chain3_tile"])
def test_mxu_probe(variant, mxu):
    c = _problem(4)
    ref = bench_packed3.mxu_probe(J(c["W"]), J(c["H"]), variant=variant, block_m=BM,
                                  mxu_dtype=MXU[mxu][0])
    out = pr.mxu_probe(T(c["W"]), T(c["H"]), variant=variant, block_m=BM,
                       mxu_dtype=MXU[mxu][1])
    _close(out, ref)


# ------------------------------------------------------- bench_diag kinds
@pytest.mark.parametrize("kind", ["hbm_only", "vpu_only", "mxu_only"])
def test_make_kernel(kind):
    c = _problem(5)
    Mp, Np, b = M, N, 128
    # vpu_only on data in [0.1, 0.9]: on 0/1 data XLA folds 1 + 1e-8 to 1 and
    # gives 0 * log(0) = NaN, which the written order does not.
    Y = np.random.default_rng(6).uniform(0.1, 0.9, (Mp, Np)).astype(np.float32) \
        if kind == "vpu_only" else c["Y"]
    ref = bench_diag.make_kernel(kind, K, Mp, Np, b, b, jax.lax.Precision.HIGHEST)(
        J(c["W"]), J(c["H"]), J(Y))
    out = pr.make_kernel(kind, K, Mp, Np, b, b, "highest")(T(c["W"]), T(c["H"]), T(Y))
    _close(out, ref)


def test_make_kernel_default_precision_is_one_bf16_pass():
    """precision DEFAULT is the TPU's one-pass bf16 matmul: with y = 0 both
    outputs are W bf16(WH), bench_packed2.mxu_only's o1 at mxu_dtype=bf16."""
    c = _problem(7)
    ref = bench_packed2.mxu_only(J(c["W"]), J(c["H"]), None, n_mm=3, block_m=BM,
                                 mxu_dtype=jnp.bfloat16)[0]
    zero = torch.zeros((M, N))
    for precision in (None, "default"):
        num, den = pr.make_kernel("mxu_only", K, M, N, 128, 128, precision)(
            T(c["W"]), T(c["H"]), zero)
        _close((num, den), (ref, ref))


# ------------------------------------------------------ reduction probes
@pytest.mark.parametrize("bm, bn, dtype", [(256, N, "f32"), (128, 128, "f32"),
                                           (256, N, "bf16"), (128, 128, "bf16")])
def test_stream_kernel(bm, bn, dtype):
    Y = _problem(8)["Y"]
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = bench_stream.stream_kernel(M, N, bm, bn, dtype)(J(Y).astype(jdt))
    out = pr.stream_kernel(M, N, bm, bn, dtype)(T(Y).to(tdt))
    assert out.shape == (1, 1)
    _close(out, ref)


@pytest.mark.parametrize("frag, packed", [
    ("stream_sum", False), ("stream_sum", True), ("unpack_concat_int", True),
    ("unpack_concat_sign", True), ("unpack_repeat_shift", True), ("ratios", False),
    ("loss2log", False), ("loss1log", False)])
def test_frag_kernel(frag, packed):
    c = _problem(9)
    X = c["Yp"] if packed else c["Y"]
    if frag in ("ratios", "loss2log", "loss1log"):
        # Values in [0.1, 0.9]: on 0/1 data a r + b r is 1e8 per zero, and
        # JAX's f32 stripe sums then drift by 2.6e-6 of the total.
        X = np.random.default_rng(10).uniform(0.1, 0.9, (M, N)).astype(np.float32)
    ref = bench_vpu.frag_kernel(J(X), frag=frag, bm=BM, packed=packed)
    out = pr.frag_kernel(T(X), frag=frag, bm=BM, packed=packed)
    assert out.shape == (1, 1)
    # Words add as signed int32 values: hold the sum to sum |x|.
    scale = float(np.abs(X.astype(np.float64)).sum()) if X.dtype == np.int32 else None
    _close(out, ref, scale)


def test_unpack_repeat_shift_is_not_the_bit_count():
    """pltpu.repeat tiles rows, so the fragment reads some bits several
    times and others never: the port computes the same value."""
    c = _problem(9)
    got = float(pr.frag_kernel(T(c["Yp"]), frag="unpack_repeat_shift", bm=BM, packed=True))
    assert got != float(c["Y"].sum())
    assert got == float(bench_vpu.frag_kernel(J(c["Yp"]), frag="unpack_repeat_shift", bm=BM,
                                              packed=True)[0, 0])


# --------------------------------------------------- bitwise equalities
@pytest.mark.parametrize("mxu", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_product_and_select_forms_agree_bitwise(mxu):
    c = _problem(10)
    W, H, Yp = T(c["W"]), T(c["H"]), T(c["Yp"])
    for a, b in zip(pr.hloss_packed(W, H, Yp, mxu_dtype=mxu),
                    pr.hloss_packed2(W, H, Yp, mxu_dtype=mxu)):
        assert torch.equal(a, b)
    assert torch.equal(pr.w_packed(W, H, Yp, n_real=N - 3, mxu_dtype=mxu),
                       pr.w_packed2(W, H, Yp, n_real=N - 3, mxu_dtype=mxu))


@pytest.mark.parametrize("mxu", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_hloss_ngrid_packed_equals_dense_bitwise(mxu):
    c = _problem(11)
    W, H = T(c["W"]), T(c["H"])
    dense = pr.hloss_ngrid(W, H, T(c["Y"]), block_n=128, mxu_dtype=mxu)
    packed = pr.hloss_ngrid(W, H, T(c["Ypg"]), block_n=128, packed=True, mxu_dtype=mxu)
    for a, b in zip(dense, packed):
        assert torch.equal(a, b)


def test_pack_bits_global_is_one_stripe():
    from nbmf_mm_tpu_torch.tools.bench_packed3 import pack_bits_global

    Y = _problem(12)["Y"]
    ref = np.asarray(bench_packed3.pack_bits_global(J(Y)))
    assert np.array_equal(pack_bits_global(T(Y)).numpy(), ref)


# ------------------------------------------------------ wrapper contract
def test_cpu_tensors_do_not_count_launches():
    c = _problem(13)
    for name in pr.LAUNCHES:
        pr.LAUNCHES[name] = 0
    W, H, Yp, Y = T(c["W"]), T(c["H"]), T(c["Yp"]), T(c["Y"])
    pr.hloss_packed(W, H, Yp)
    pr.w_packed2(W, H, Yp, n_real=N)
    pr.mxu_probe(W, H, variant="chain3_tile")
    pr.make_kernel("hbm_only", K, M, N, 128, 128, None)(W, H, Y)
    pr.stream_kernel(M, N, 256, N, "f32")(Y)
    pr.frag_kernel(Yp, frag="unpack_concat_int", packed=True)
    assert set(pr.LAUNCHES.values()) == {0}


def test_wrappers_reject_other_devices():
    W = torch.zeros((2, 256), device="meta")
    H = torch.zeros((2, 8), device="meta")
    Yp = torch.zeros((8, 8), dtype=torch.int32, device="meta")
    Y = torch.zeros((256, 8), device="meta")
    for call in (
        lambda: pr.hloss_packed2(W, H, Yp),
        lambda: pr.w_packed(W, H, Yp, n_real=8),
        lambda: pr.mxu_only(W, H),
        lambda: pr.hloss_ngrid(W, H, Y, block_n=8),
        lambda: pr.make_kernel("vpu_only", 2, 256, 8, 128, 8, None)(W, H, Y),
        lambda: pr.stream_kernel(256, 8, 128, 8, "f32")(Y),
        lambda: pr.frag_kernel(Y, frag="ratios"),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("bad", [
    lambda W, H, Yp, Y: pr.frag_kernel(Y, frag="unpack_concat_int"),
    lambda W, H, Yp, Y: pr.frag_kernel(Yp, frag="ratios", packed=True),
    lambda W, H, Yp, Y: pr.mxu_only(W, H, n_mm=4),
    lambda W, H, Yp, Y: pr.mxu_probe(W, H, variant="indep3_tile"),
    lambda W, H, Yp, Y: pr.hloss_packed(W, H, Yp, mxu_dtype=torch.float16),
    lambda W, H, Yp, Y: pr.hloss_ngrid(W, H, Y, block_n=300),
    lambda W, H, Yp, Y: pr.make_kernel("mxu_only", K, M, N, 128, 128, "high"),
    lambda W, H, Yp, Y: pr.stream_kernel(M, N, 300, N, "f32"),
], ids=["unpack-on-floats", "ratios-on-words", "n_mm", "variant", "mxu_dtype", "block_n",
        "precision", "tile"])
def test_probes_reject_bad_arguments(bad):
    c = _problem(14)
    with pytest.raises(ValueError):
        bad(T(c["W"]), T(c["H"]), T(c["Yp"]), T(c["Y"]))


# ------------------------------------------------------------ the harness
def test_true_time_is_the_slope():
    """A call that sleeps 2 ms has a slope of about 2 ms/call, whatever the
    fixed cost of a timed run; the function runs warm-up + reps (lo + hi)
    times."""
    import time

    calls = []

    def fn(W, H):
        calls.append(1)
        time.sleep(0.002)

    ms = bench_true.true_time(fn, torch.zeros(1), torch.zeros(1), (), "sleep", lo=2, hi=12,
                              reps=3, quiet=True)
    assert len(calls) == 1 + 3 * (2 + 12)
    assert 1.5 <= ms <= 20.0


def test_measurement_path_requires_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the GPU-less contract")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_true.main(["--mn", "256", "--k", "4", "--reps", "1"])


@pytest.mark.parametrize("tool, mn", [("bench_true", 256), ("bench_kernels", 256),
                                      ("bench_packed", 512), ("bench_packed2", 512),
                                      ("bench_packed3", 256), ("bench_diag", 512),
                                      ("bench_stream", 2048), ("bench_vpu", 256)])
def test_tool_entry_points_run_on_the_host(tool, mn, capsys):
    import importlib

    module = importlib.import_module(f"nbmf_mm_tpu_torch.tools.{tool}")
    module.main(["--device", "cpu", "--mn", str(mn), "--k", "4", "--reps", "1"])
    out = capsys.readouterr().out
    assert "device=cpu (plain versions)" in out
    assert "nan" not in out.lower()
