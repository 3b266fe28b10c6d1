"""Contracts of the port that differed from the JAX package's: the
estimator's constructor parameters, ``SolverResult``'s fields, ranks above
the kernels' cap, the process-wide TF32 switches, the errors of the restart
options, what the port's sources import, the JAX package's option names
(P7), the exports, and the sparse-densify warning (P8)."""

import ast
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port
import nbmf_mm_tpu.models as jref_models
import nbmf_mm_tpu.utils as jref_utils
from nbmf_mm_tpu.models import serving as jref_serving
from nbmf_mm_tpu.parallel import grid as jref_grid
from nbmf_mm_tpu.parallel import restarts as jref_restarts
from nbmf_mm_tpu.solver.driver import SolverResult as RefSolverResult
from nbmf_mm_tpu.utils import cache as jref_cache
from nbmf_mm_tpu.utils import checkpoint as jref_checkpoint
from nbmf_mm_tpu.utils import debugging as jref_debugging
from nbmf_mm_tpu_torch.models import estimator as port_estimator
from nbmf_mm_tpu_torch.models import serving as port_serving
from nbmf_mm_tpu_torch.ops import _build, tiers
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds
from nbmf_mm_tpu_torch.parallel.grid import driver as port_grid_driver
from nbmf_mm_tpu_torch.solver import driver as port_driver
from nbmf_mm_tpu_torch.utils import checkpoint as port_checkpoint
from nbmf_mm_tpu_torch.solver.driver import _resolve_backend, ieee_fp32_products

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
OVER = cs.MAX_RANK + 1
LEGACY = ("use_numexpr", "use_numba", "projection_backend")


def _binary(m=24, n=16, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < 0.4).astype(np.float64)


# ------------------------------------------------- P1: constructor parameters
def _init_params(cls):
    return [p for p in inspect.signature(cls.__init__).parameters if p != "self"]


def test_constructor_has_the_reference_parameters_plus_device():
    assert _init_params(port.NBMF) == _init_params(jref.NBMF) + ["device"]


@pytest.mark.parametrize("name", LEGACY)
def test_legacy_flags_are_accepted_and_ignored(name):
    est = port.NBMF(n_components=2, max_iter=3, random_state=0, dtype="float64", device="cpu",
                    **{name: True})
    assert getattr(est, name) is True
    base = port.NBMF(n_components=2, max_iter=3, random_state=0, dtype="float64", device="cpu")
    np.testing.assert_array_equal(est.fit(_binary()).W_, base.fit(_binary()).W_)


def test_get_params_has_the_reference_names_plus_device():
    pytest.importorskip("sklearn")
    assert set(port.NBMF().get_params()) == set(jref.NBMF().get_params()) | {"device"}
    est = port.NBMF(mesh_axes=("a", "b"), solver_options={"max_iter": 2})
    assert est.get_params()["mesh_axes"] == ("a", "b")
    assert est.get_params()["solver_options"] == {"max_iter": 2}


def test_solver_options_reach_solve_and_override(monkeypatch):
    seen = {}

    def fake_solve(X, **kwargs):
        seen.update(kwargs)
        raise RuntimeError("stop here")

    monkeypatch.setattr(port_estimator, "solve", fake_solve)
    est = port.NBMF(n_components=2, max_iter=50, device="cpu",
                    solver_options={"max_iter": 4, "device_results": True})
    with pytest.raises(RuntimeError, match="stop here"):
        est.fit(_binary())
    assert seen["max_iter"] == 4 and seen["device_results"] is True
    assert seen["n_components"] == 2 and seen["device"] == "cpu"


def test_solver_options_change_the_fit():
    kw = dict(n_components=2, max_iter=50, tol=0.0, random_state=0, dtype="float64",
              device="cpu")
    est = port.NBMF(**kw, solver_options={"max_iter": 4}).fit(_binary())
    assert est.n_iter_ == 4
    ref = port.NBMF(**dict(kw, max_iter=4)).fit(_binary())
    np.testing.assert_array_equal(est.W_, ref.W_)


# --------------------------------------------------- P2: SolverResult's fields
def test_solver_result_fields_equal_the_reference():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(port.SolverResult) == names(RefSolverResult)


def test_solver_result_restart_fields_default():
    res = port.solve(_binary(), 2, max_iter=3, random_state=5, dtype="float64", device="cpu")
    assert res.best_restart == 0 and res.all_final_losses is None and res.seed == 5
    positional = port.SolverResult(res.W, res.H, res.losses, 0.0, 3, False, 0, None, 7)
    assert positional.seed == 7


# ------------------------------------------- P3: ranks above the kernels' cap
@pytest.mark.parametrize("k, expected", [(cs.MAX_RANK, "fused"), (OVER, "plain")])
def test_auto_takes_the_plain_loop_above_the_cap(k, expected):
    assert _resolve_backend("auto", torch.float32, CUDA, True, None, k) == expected


@pytest.mark.parametrize("device", [CUDA, CPU])
def test_fused_above_the_cap_raises_up_front(device):
    with pytest.raises(ValueError, match=str(cs.MAX_RANK)):
        _resolve_backend("fused", torch.float32, device, True, None, OVER)
    assert _resolve_backend("fused", torch.float32, device, True, None, cs.MAX_RANK) == "fused"


def test_solve_fused_above_the_cap_raises_before_staging():
    with pytest.raises(ValueError, match=str(cs.MAX_RANK)):
        port.solve(_binary(), OVER, max_iter=2, backend="fused", device="cpu")


def test_packed_true_above_the_cap_raises():
    with pytest.raises(ValueError, match="packed=True"):
        _resolve_backend("auto", torch.float32, CUDA, True, True, OVER)


def test_transform_route_follows_the_cap():
    big = 1 << 23
    route = lambda backend, k: port.NBMF(n_components=k, backend=backend)._use_fused_transform(
        big, torch.float32, CUDA)
    assert route("auto", cs.MAX_RANK) is True
    assert route("auto", OVER) is False
    assert route("plain", 4) is False
    with pytest.raises(ValueError, match=str(cs.MAX_RANK)):
        route("fused", OVER)


def test_fold_in_server_follows_the_cap():
    H = np.random.default_rng(0).uniform(0.1, 0.9, (OVER, 12))
    assert port.FoldInServer(H, device="cpu").route == "plain"
    with pytest.raises(ValueError, match=str(cs.MAX_RANK)):
        port.FoldInServer(H, backend="fused", device="cpu")
    with pytest.raises(ValueError, match=str(cs.MAX_RANK)):
        port.fold_in_fused(H, _binary(8, 12), device="cpu")


# ------------------------------------------------- P4: the TF32 switches
def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture(params=[True, False], ids=["from-True", "from-False"])
def tf32(request):
    """Both switches set to the parameter, and put back afterwards."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = request.param
    torch.backends.cudnn.allow_tf32 = request.param
    yield (request.param, request.param)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _recording(monkeypatch, module, name, seen):
    """Wrap ``module.name`` so that each call records the switches it saw."""
    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        seen.append(_flags())
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("backend, loop", [("plain", "_solve_core"),
                                           ("fused", "_solve_core_fused")])
def test_solve_turns_tf32_off_inside_and_restores_it(tf32, monkeypatch, backend, loop):
    seen = []
    _recording(monkeypatch, port_driver, loop, seen)
    port.solve(_binary(), 2, max_iter=2, backend=backend, dtype="float64", device="cpu")
    assert seen == [(False, False)]
    assert _flags() == tf32


def test_raising_solve_restores_tf32(tf32, monkeypatch):
    def boom(*args, **kwargs):
        assert _flags() == (False, False)
        raise RuntimeError("boom")

    monkeypatch.setattr(port_driver, "_solve_core", boom)
    with pytest.raises(RuntimeError, match="boom"):
        port.solve(_binary(), 2, max_iter=2, backend="plain", dtype="float64", device="cpu")
    assert _flags() == tf32
    with pytest.raises(ValueError, match="orientation"):
        port.solve(_binary(), 2, orientation="sideways", device="cpu")
    assert _flags() == tf32


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_fold_in_turns_tf32_off_inside_and_restores_it(tf32, monkeypatch, backend):
    seen = []
    _recording(monkeypatch, port_serving, "_fold_in_chunk", seen)
    H = np.random.default_rng(1).uniform(0.1, 0.9, (2, 16))
    port.FoldInServer(H, n_iter=2, buckets=(32,), backend=backend, dtype="float64",
                      device="cpu").transform(_binary())
    assert seen == [(False, False)] and _flags() == tf32
    port.fold_in_fused(H, _binary(), n_iter=2, dtype="float64", device="cpu")
    assert seen == [(False, False)] * 2 and _flags() == tf32


def test_estimator_transform_restores_tf32(tf32, monkeypatch):
    est = port.NBMF(n_components=2, max_iter=3, random_state=0, backend="plain",
                    dtype="float64", device="cpu").fit(_binary())
    seen = []
    _recording(monkeypatch, port_estimator, "_transform_core", seen)
    est.transform(_binary(seed=1))
    assert seen == [(False, False)] and _flags() == tf32


def test_staged_operands_are_contiguous():
    # A dir-beta solve stages Y.T: at a shape that needs no padding the
    # padded operand used to stay a transposed view, which the kernels refuse.
    A = torch.rand(8, 4).T
    assert not A.is_contiguous()
    assert port_driver._pad(A, 4, 8).is_contiguous()
    assert torch.equal(port_driver._pad(A, 4, 8), A)
    assert port_driver._pad(A, 6, 12).is_contiguous()


def test_guard_is_reentrant(tf32):
    with ieee_fp32_products():
        with ieee_fp32_products():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == tf32


# ------------------------------------- P5: the restart options' own errors
def test_n_init_with_custom_init_raises_the_reference_error():
    """``n_init > 1`` with a custom init is the JAX package's ValueError, in
    both orientations, whichever factor is given."""
    Y = _binary()
    kw = dict(max_iter=3, n_init=2, dtype="float64", device="cpu")
    msg = "n_init > 1 is incompatible with explicit W_init/H_init"
    with pytest.raises(ValueError, match=msg):
        port.solve(Y, 2, W_init=np.full((24, 2), 0.5), **kw)
    with pytest.raises(ValueError, match=msg):
        port.solve(Y, 2, H_init=np.full((2, 16), 0.5), **kw)
    with pytest.raises(ValueError, match=msg):
        port.solve(Y, 2, W_init=np.full((24, 2), 0.5), H_init=np.full((2, 16), 0.5),
                   orientation="dir-beta", **kw)
    with pytest.raises(ValueError, match=msg):
        jref.solve(Y, 2, W_init=np.full((24, 2), 0.5), max_iter=3, n_init=2)


def test_return_all_with_one_init_raises_the_reference_error():
    msg = "return_all requires n_init > 1"
    with pytest.raises(ValueError, match=msg):
        port.solve(_binary(), 2, max_iter=3, return_all=True, dtype="float64", device="cpu")
    with pytest.raises(ValueError, match=msg):
        jref.solve(_binary(), 2, max_iter=3, return_all=True)


@pytest.mark.parametrize("n_init", [0, -1])
def test_n_init_below_one_raises(n_init):
    with pytest.raises(ValueError, match="n_init must be >= 1"):
        port.solve(_binary(), 2, max_iter=3, n_init=n_init, device="cpu")


# --------------------------------------------- P6: what the sources import
def _port_sources():
    root = pathlib.Path(port.__file__).resolve().parent
    compat = root.parent / "nbmf_mm_compat_torch"
    return (sorted(root.rglob("*.py")) + sorted(compat.rglob("*.py"))
            + [root.parent / "chip_smoke.py"])


def _imported_roots(path):
    """Top-level names of every absolute import in a source, wherever in the
    file it stands (inside functions too)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_cover_the_parallel_package():
    names = {p.name for p in _port_sources() if p.parent.name == "parallel"}
    assert {"__init__.py", "restarts.py", "grid.py"} <= names
    assert any(p.name == "chip_smoke.py" for p in _port_sources())


def test_sources_cover_the_tier_module():
    assert any(p.name == "tiers.py" and p.parent.name == "ops" for p in _port_sources())


def test_sources_cover_the_host_surface_and_the_compat_shim():
    names = {(p.parent.name, p.name) for p in _port_sources()}
    assert {("utils", "checkpoint.py"), ("utils", "debugging.py"), ("utils", "rdata.py"),
            ("utils", "cache.py"), ("models", "baselines.py"),
            ("nbmf_mm_compat_torch", "__init__.py"),
            ("nbmf_mm_compat_torch", "_utils.py")} <= names


def test_sources_cover_the_stress_driver_and_the_experiments():
    names = {(p.parent.name, p.name) for p in _port_sources()}
    assert {("tools", "stress_solve.py"), ("experiments", "__init__.py"),
            ("experiments", "data.py"), ("experiments", "reproduce_magron2022.py"),
            ("experiments", "benchmark_suite.py"), ("experiments", "flagship_scale.py"),
            ("experiments", "validate_implementation.py")} <= names


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: f"{p.parent.name}/{p.name}")
def test_no_port_source_imports_jax_or_the_jax_package(path):
    assert not {"jax", "jaxlib", "nbmf_mm_tpu", "nbmf_mm_compat"} & _imported_roots(path)


# ------------------------- the operand forms' entry points and the device
def test_every_operand_form_entry_point_has_a_source_and_a_counter():
    """Each form's C entry point in ``_SIGNATURES`` is defined by a source
    of ``csrc/`` (the bf16 forms through the tensor-core form macros, the
    TF32 form by name through the entry macros of ``sweep_wgmma_tf32.cuh``
    or in full; the build compiles one ``nvcc`` each) and counted under its
    own name."""
    csrc = pathlib.Path(_build.__file__).resolve().parent / "csrc"
    sources = {p.name: p.read_text() for p in csrc.glob("*.cu")}
    forms = [name for name in _build._SIGNATURES if name.rpartition("_")[2] in tiers.FORMS]
    assert len(forms) == 2 * 2 + 4 * 3
    for name in forms:
        base, _, form = name.rpartition("_")
        if form in cs.TF32_FORMS:
            assert sum(f"ENTRY({name}," in text or f"int {name}(" in text
                       for text in sources.values()) == 1, name
        else:
            macro = "NBMF_WGMMA_PACKED_FORM" if base.endswith("_packed") else (
                "NBMF_WGMMA_DENSE_FORM")
            assert sum(f"{macro}(_{form}," in text or f"{macro}(_{form})" in text
                       for text in sources.values()) == 1, name
        counter = name.removeprefix("nbmf_").replace("_dense", "")
        assert counter in (cs.LAUNCHES if base.endswith("_packed") else ds.LAUNCHES), counter


def _entry(name):
    """A public callable of the port by name: the package root's, then the
    utils' and the models'."""
    for owner in (port, port.utils, port.models):
        if hasattr(owner, name):
            return getattr(owner, name)
    raise AttributeError(name)


@pytest.mark.parametrize("entry", ["solve", "NBMF", "grid_solve", "FoldInServer",
                                   "fold_in_fused", "pack_matrix", "pack_matrix_chunked",
                                   "pack_matrix_sparse", "load_model", "resume_fit", "NBMFEM",
                                   "LogisticPCA"])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(_entry(entry)).parameters["device"].default == "cuda"


# ------------------------------- P7: the JAX package's option names and exports
# (JAX callable, port callable): every public callable whose parameters must
# cover the JAX package's, plus device where the port takes one.
SIGNATURE_PAIRS = {
    "solve": (jref.solve, port.solve),
    "nbmf_mm_solver": (jref.nbmf_mm_solver, port.nbmf_mm_solver),
    "NBMF": (jref.NBMF, port.NBMF),
    "grid_solve": (jref_grid.grid_solve, port.grid_solve),
    "vmapped_solve": (jref_restarts.vmapped_solve, port.parallel.vmapped_solve),
    "FoldInServer": (jref_serving.FoldInServer, port.FoldInServer),
    "fold_in_fused": (jref_serving.fold_in_fused, port.fold_in_fused),
    "pack_matrix": (jref.pack_matrix, port.pack_matrix),
    "pack_matrix_chunked": (jref.pack_matrix_chunked, port.pack_matrix_chunked),
    "pack_matrix_sparse": (jref.pack_matrix_sparse, port.pack_matrix_sparse),
    "save_checkpoint": (jref_utils.save_checkpoint, port.utils.save_checkpoint),
    "load_checkpoint": (jref_utils.load_checkpoint, port.utils.load_checkpoint),
    "save_model": (jref_utils.save_model, port.utils.save_model),
    "load_model": (jref_utils.load_model, port.utils.load_model),
    "resume_fit": (jref_utils.resume_fit, port.utils.resume_fit),
    "fit_checkpointed": (jref_checkpoint.fit_checkpointed, port_checkpoint.fit_checkpointed),
    "enable_nan_checks": (jref_debugging.enable_nan_checks, port.utils.enable_nan_checks),
    "enable_compilation_cache": (jref_cache.enable_compilation_cache,
                                 port.utils.enable_compilation_cache),
    "NBMFEM": (jref_models.NBMFEM, port.models.NBMFEM),
    "LogisticPCA": (jref_models.LogisticPCA, port.models.LogisticPCA),
}
# The only names a port subpackage may lack: the mesh functions of the JAX
# package's parallel/sharding.py (ROADMAP queue 1, item 9, Multi-GPU).
MESH_FUNCTIONS = {"make_mesh", "data_sharding", "factor_shardings", "shard_solver_operands"}


def _params(fn):
    return [p for p in inspect.signature(fn).parameters if p != "self"]


@pytest.mark.parametrize("name", sorted(SIGNATURE_PAIRS))
def test_parameters_cover_the_reference_plus_device(name):
    ref, ours = SIGNATURE_PAIRS[name]
    missing = [p for p in _params(ref) if p not in _params(ours)]
    assert not missing, missing
    assert set(_params(ours)) - set(_params(ref)) <= {"device"}


@pytest.mark.parametrize("sub", ["", "models", "utils", "parallel", "solver", "ops"])
def test_subpackage_exports_cover_the_reference(sub):
    import importlib

    ref = importlib.import_module("nbmf_mm_tpu" + (f".{sub}" if sub else ""))
    ours = importlib.import_module("nbmf_mm_tpu_torch" + (f".{sub}" if sub else ""))
    allowed = MESH_FUNCTIONS if sub == "parallel" else set()
    assert set(ref.__all__) - set(ours.__all__) == allowed
    for name in ours.__all__:
        assert hasattr(ours, name), name


@pytest.mark.parametrize("alias, name", [("jnp", "plain"), ("pallas", "fused")])
def test_backend_aliases_are_bitwise_their_loops(alias, name):
    mask = (np.random.default_rng(3).random((24, 16)) < 0.8).astype(np.float64)
    kw = dict(max_iter=15, tol=0.0, random_state=0, dtype="float32", device="cpu", mask=mask)
    a = port.solve(_binary(), 3, backend=alias, **kw)
    b = port.solve(_binary(), 3, backend=name, **kw)
    assert a.extras == b.extras and a.extras["backend"] == name
    assert a.losses == b.losses and a.n_iter == b.n_iter
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)
    grid = lambda backend: port.grid_solve(_binary(), 3, [1.0, 2.0], [1.5], max_iter=8,
                                           backend=backend, device="cpu")
    ga, gb = grid(alias), grid(name)
    assert all(np.array_equal(ga[key], gb[key]) for key in ga)
    H = np.random.default_rng(4).uniform(0.1, 0.9, (3, 16))
    serve = lambda backend: port.FoldInServer(H, n_iter=5, buckets=(32,), backend=backend,
                                              device="cpu").transform(_binary())
    assert all(map(np.array_equal, serve(alias), serve(name)))
    est = lambda backend: port.NBMF(n_components=3, max_iter=10, random_state=0, backend=backend,
                                    device="cpu").fit(_binary())
    np.testing.assert_array_equal(est(alias).W_, est(name).W_)


def test_pallas_estimator_transform_takes_the_fused_route():
    est = port.NBMF(n_components=3, backend="pallas")
    assert est._use_fused_transform(10, torch.float32, CPU) is True
    assert port.NBMF(n_components=3, backend="jnp")._use_fused_transform(
        1 << 23, torch.float32, CUDA) is False


def test_block_sizes_are_accepted_and_ignored():
    kw = dict(max_iter=10, tol=0.0, random_state=0, dtype="float32", device="cpu",
              backend="fused")
    base = port.solve(_binary(), 3, **kw)
    tiles = port.solve(_binary(), 3, block_m=256, block_n=128, pallas_interpret=True, **kw)
    assert base.losses == tiles.losses
    np.testing.assert_array_equal(base.W, tiles.W)
    g = port.grid_solve(_binary(), 3, [1.0], [1.5], max_iter=5, block_m=64, block_n=64,
                        pallas_interpret=True, device="cpu")
    assert g["W"].shape == (1, 24, 3)
    H = np.random.default_rng(5).uniform(0.1, 0.9, (3, 16))
    W, _ = port.fold_in_fused(H, _binary(), n_iter=3, block_m=64, block_n=64, interpret=True,
                              device="cpu")
    W2, _ = port.fold_in_fused(H, _binary(), n_iter=3, device="cpu")
    np.testing.assert_array_equal(W, W2)
    server = port.FoldInServer(H, block_m=64, block_n=32, pallas_interpret=True,
                               mesh_axes=("a", "b"), device="cpu")
    assert (server.block_m, server.block_n, server.pallas_interpret) == (64, 32, True)
    assert server.mesh_axes == ("a", "b")


def test_solver_options_take_the_reference_examples():
    kw = dict(n_components=3, max_iter=8, tol=0.0, random_state=0, dtype="float32",
              device="cpu")
    base = port.NBMF(**kw).fit(_binary())
    for options in ({"block_m": 256}, {"block_n": 64}, {"pallas_interpret": True}):
        est = port.NBMF(**kw, solver_options=options).fit(_binary())
        np.testing.assert_array_equal(est.W_, base.W_)


@pytest.fixture
def cuda_without_card(monkeypatch):
    """``device="cuda"`` resolved as if a card were present, and every
    staging step refused, so that a check must fire before anything is
    staged."""
    monkeypatch.setattr(cs, "resolve_device", lambda device: torch.device(device))

    def staged(*args, **kwargs):
        raise AssertionError("staged before the interpret check")

    for module in (port_driver, port_grid_driver):
        monkeypatch.setattr(module, "_to_tensor", staged)
    monkeypatch.setattr(port_serving, "_stage_chunk", staged)
    monkeypatch.setattr(port_serving, "_padded_H", staged)


@pytest.mark.usefixtures("cuda_without_card")
def test_interpret_on_cuda_raises_before_staging():
    H = np.full((3, 16), 0.5)
    calls = {
        "solve": lambda: port.solve(_binary(), 3, pallas_interpret=True, device="cuda"),
        "grid_solve": lambda: port.grid_solve(_binary(), 3, [1.0], [1.5],
                                              pallas_interpret=True, device="cuda"),
        "FoldInServer": lambda: port.FoldInServer(H, pallas_interpret=True, device="cuda"),
        "fold_in_fused": lambda: port.fold_in_fused(H, _binary(), interpret=True,
                                                    device="cuda"),
        "NBMF": lambda: port.NBMF(n_components=3, device="cuda",
                                  solver_options={"pallas_interpret": True}).fit(_binary()),
    }
    for what, call in calls.items():
        with pytest.raises(ValueError, match="interpret=True"):
            call()


def test_mesh_axes_are_checked_only_with_a_mesh():
    res = port.solve(_binary(), 2, max_iter=2, mesh_axes=("x",), device="cpu")
    assert res.n_iter == 2
    with pytest.raises(ValueError, match="mesh_axes"):
        port.solve(_binary(), 2, mesh=object(), mesh_axes=("x",), device="cpu")
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        port.solve(_binary(), 2, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        port.FoldInServer(np.full((2, 4), 0.5), mesh=object(), device="cpu")
    est = port.NBMF(n_components=2, max_iter=2, mesh_axes=("a", "b"), device="cpu")
    assert est.fit(_binary()).n_iter_ == 2


# ------------------------------------------- P8: the sparse-densify warning
def test_sparse_densify_warning_points_to_the_ports_server():
    sparse = pytest.importorskip("scipy.sparse")
    from nbmf_mm_tpu_torch.utils import validation

    big = sparse.csr_matrix((1, validation.SPARSE_DENSIFY_WARN_ENTRIES))
    with pytest.warns(UserWarning) as record:
        validation.warn_large_sparse_densify(big, "transform")
    text = str(record[0].message)
    assert "nbmf_mm_tpu_torch.models.serving.FoldInServer" in text
    assert "one bucket-chunk at a time" in text and "nbmf_mm_tpu.models" not in text
