"""The PyTorch port's import boundary, device contract and routing.

The port never imports JAX; CUDA is used only when asked for and raises
where there is no card; CPU tensors take the kernels' plain versions.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nbmf_mm_tpu_torch as nbt
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.solver.driver import _resolve_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA = torch.device("cuda")
CPU = torch.device("cpu")


def _binary(m=24, n=16, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < 0.4).astype(np.float64)


def _require_no_card():
    # Decided inside the test: these check the GPU-less contract.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the GPU-less contract")


def test_import_leaves_jax_out():
    code = (
        "import sys; sys.path.insert(0, %r); import nbmf_mm_tpu_torch, "
        "nbmf_mm_tpu_torch.ops.cuda_sweep, nbmf_mm_tpu_torch.ops.dense_sweep, "
        "nbmf_mm_tpu_torch.ops._build, nbmf_mm_tpu_torch.ops.packed, "
        "nbmf_mm_tpu_torch.ops.tiers, "
        "nbmf_mm_tpu_torch.models.serving, "
        "nbmf_mm_tpu_torch.utils.interop, nbmf_mm_tpu_torch.ops.probes, "
        "nbmf_mm_tpu_torch.utils.profiling, nbmf_mm_tpu_torch.tools.bench_true, "
        "nbmf_mm_tpu_torch.tools.bench_kernels, nbmf_mm_tpu_torch.tools.bench_packed, "
        "nbmf_mm_tpu_torch.tools.bench_packed2, nbmf_mm_tpu_torch.tools.bench_packed3, "
        "nbmf_mm_tpu_torch.tools.bench_diag, nbmf_mm_tpu_torch.tools.bench_stream, "
        "nbmf_mm_tpu_torch.tools.bench_vpu, nbmf_mm_tpu_torch.tools.sass_diff, nbmf_mm_tpu_torch.tools.wpass_tune, "
        "nbmf_mm_tpu_torch.tools.hpass_tune, nbmf_mm_tpu_torch.tools.ab_time, "
        "nbmf_mm_tpu_torch.tools.wgmma_tf32_probe, "
        "nbmf_mm_tpu_torch.parallel, "
        "nbmf_mm_tpu_torch.parallel.restarts, nbmf_mm_tpu_torch.parallel.grid, "
        "nbmf_mm_tpu_torch.utils.checkpoint, nbmf_mm_tpu_torch.utils.debugging, "
        "nbmf_mm_tpu_torch.utils.rdata, nbmf_mm_tpu_torch.utils.cache, "
        "nbmf_mm_tpu_torch.models.baselines, nbmf_mm_compat_torch, "
        "nbmf_mm_tpu_torch.tools.stress_solve, nbmf_mm_tpu_torch.experiments, "
        "nbmf_mm_tpu_torch.experiments.data, nbmf_mm_tpu_torch.experiments.reproduce_magron2022, "
        "nbmf_mm_tpu_torch.experiments.benchmark_suite, "
        "nbmf_mm_tpu_torch.experiments.flagship_scale, "
        "nbmf_mm_tpu_torch.experiments.validate_implementation, "
        "nbmf_mm_compat_torch._utils; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'nbmf_mm_tpu' or m.startswith('nbmf_mm_tpu.') "
        "or m.startswith('nbmf_mm_compat') and not m.startswith('nbmf_mm_compat_torch')]; "
        "assert not bad, bad; print('ok')" % REPO
    )
    # -I: no PYTHONPATH / site hooks that could pre-import jax.
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_public_surface():
    for name in ("NBMF", "NBMFMM", "solve", "nbmf_mm_solver", "SolverResult", "FoldInServer",
                 "fold_in_fused", "PackedMatrix", "pack_matrix", "pack_matrix_chunked",
                 "pack_matrix_sparse", "grid_solve", "__version__"):
        assert hasattr(nbt, name)
        assert name in nbt.__all__
    assert nbt.NBMF is nbt.NBMFMM
    assert isinstance(nbt.__version__, str)


def test_cuda_device_raises_without_card():
    _require_no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        nbt.solve(_binary(), 2, max_iter=3)
    with pytest.raises(RuntimeError, match="cuda"):
        nbt.NBMF(n_components=2, max_iter=3).fit(_binary())


@pytest.mark.parametrize("kwargs", [dict(dtype="bfloat16"), dict(precision="default"),
                                    dict(precision="high")], ids=["bfloat16", "default", "high"])
def test_tiers_and_bf16_stay_on_the_card_unless_asked(kwargs):
    """A tier or the bf16-data mode does not move a solve to the CPU."""
    _require_no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        nbt.solve(_binary(), 2, max_iter=3, **kwargs)
    with pytest.raises(RuntimeError, match="cuda"):
        nbt.grid_solve(_binary(), 2, [1.0], [1.0], max_iter=3, **kwargs)
    with pytest.raises(RuntimeError, match="cuda"):
        nbt.FoldInServer(np.full((2, 16), 0.5), **kwargs)


def test_fused_on_cpu_uses_plain_versions():
    # Every counter, every form: a test in the same process may have counted
    # launches through a stub library.
    cs.LAUNCHES.update(dict.fromkeys(cs.LAUNCHES, 0))
    res = nbt.solve(_binary(), 2, max_iter=5, random_state=0, backend="fused",
                    dtype="float64", device="cpu")
    assert res.extras["backend"] == "fused"
    assert res.n_iter == 5 and len(res.losses) == 5
    assert set(cs.LAUNCHES.values()) == {0}


@pytest.mark.parametrize(
    "backend, dtype, device, binary, expected",
    [
        ("auto", torch.float32, CUDA, True, "fused"),
        ("auto", torch.float64, CUDA, True, "plain"),
        ("auto", torch.float64, CUDA, False, "plain"),
        ("auto", torch.float32, CPU, True, "plain"),
        ("auto", torch.float32, CPU, False, "plain"),
        ("plain", torch.float32, CUDA, False, "plain"),
        ("fused", torch.float32, CUDA, True, "fused"),
        ("fused", torch.float64, CPU, True, "fused"),
        ("fused", torch.float32, CPU, False, "fused"),
    ],
)
def test_resolve_backend(backend, dtype, device, binary, expected):
    assert _resolve_backend(backend, dtype, device, binary) == expected


def test_resolve_backend_nonbinary_cuda_auto_not_ported():
    # Non-binary float32 data on CUDA takes the fused loop over dense operands.
    assert _resolve_backend("auto", torch.float32, CUDA, False) == "fused"


@pytest.mark.parametrize(
    "backend, dtype, device, binary",
    [
        ("fused", torch.float64, CUDA, True),
        ("pallas", torch.float64, CUDA, True),
        ("xla", torch.float32, CPU, True),
    ],
)
def test_resolve_backend_rejects(backend, dtype, device, binary):
    with pytest.raises(ValueError):
        _resolve_backend(backend, dtype, device, binary)


@pytest.mark.parametrize("alias, name", [("jnp", "plain"), ("pallas", "fused")])
def test_resolve_backend_takes_the_jax_names(alias, name):
    # The JAX package's "jnp" (XLA) and "pallas" loops are the port's plain
    # and fused loops.
    for dtype, device in ((torch.float32, CPU), (torch.float32, CUDA), (torch.float64, CPU)):
        assert _resolve_backend(alias, dtype, device, True) == _resolve_backend(
            name, dtype, device, True)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(mesh=object()),
        dict(dtype="bfloat16"),
        dict(precision="default"),
        dict(precision="high"),
        dict(device_results=True),
    ],
    ids=["mesh", "bfloat16", "precision-default",
         "precision-high", "device_results"],
)
def test_options_left_out_raise(kwargs):
    if kwargs == dict(device_results=True):  # ported since: tensors come back
        res = nbt.solve(_binary(), 2, max_iter=2, device="cpu", **kwargs)
        assert all(isinstance(t, torch.Tensor) for t in (res.W, res.H, res.losses))
        return
    if "mesh" not in kwargs:  # ported since: the bf16-data mode and the tiers run
        res = nbt.solve(_binary().astype(np.float32), 2, max_iter=2, device="cpu",
                        backend="fused", **kwargs)
        assert res.extras["precision"] == kwargs.get("precision", "default")
        assert np.isfinite(res.losses).all() and res.W.dtype == np.float32
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nbt.solve(_binary(), 2, max_iter=2, device="cpu", **kwargs)


def test_sparse_input_not_ported():
    # Ported since: sparse input gives the dense-input result.
    sp = pytest.importorskip("scipy.sparse")
    kw = dict(max_iter=2, random_state=0, dtype="float64", device="cpu")
    dense = nbt.solve(_binary(), 2, **kw)
    sparse = nbt.solve(sp.csr_matrix(_binary()), 2, **kw)
    np.testing.assert_array_equal(sparse.W, dense.W)
    np.testing.assert_array_equal(sparse.H, dense.H)


def test_precision_highest_accepted():
    res = nbt.solve(_binary(), 2, max_iter=2, device="cpu", precision="highest",
                    dtype="float64", random_state=1)
    assert res.n_iter == 2


def test_wrapper_rejects_other_devices():
    W = torch.zeros((2, 32), device="meta")
    H = torch.zeros((2, 4), device="meta")
    words = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cs.hloss_terms_packed(W, H, words, eps=1e-8, m_real=32, n_real=4, bm=32)
    with pytest.raises(ValueError, match="unsupported device"):
        cs.w_terms_packed(W, H, words, eps=1e-8, n_real=4, bm=32)
