"""Contracts of the port that differed from the JAX package's: the
estimator's constructor parameters, ``SolverResult``'s fields, ranks above
the kernels' cap, the process-wide TF32 switches, the errors of the restart
options, and what the port's sources import."""

import ast
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest
import torch

import nbmf_mm_tpu as jref
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.solver.driver import SolverResult as RefSolverResult
from nbmf_mm_tpu_torch.models import estimator as port_estimator
from nbmf_mm_tpu_torch.models import serving as port_serving
from nbmf_mm_tpu_torch.ops import _build, tiers
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.ops import dense_sweep as ds
from nbmf_mm_tpu_torch.solver import driver as port_driver
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
    return sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]


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


@pytest.mark.parametrize("entry", ["solve", "NBMF", "grid_solve", "FoldInServer",
                                   "fold_in_fused", "pack_matrix", "pack_matrix_chunked",
                                   "pack_matrix_sparse"])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(getattr(port, entry)).parameters["device"].default == "cuda"
