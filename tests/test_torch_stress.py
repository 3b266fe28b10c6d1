"""The port's stress driver (``nbmf_mm_tpu_torch.tools.stress_solve``)
against the JAX package's (``tools/stress_solve.py``), on the CPU.

- Draw identity: for three seeds, 40 draws of each of the six backend names
  give bitwise the JAX tool's ``Y``, masks, ``kw`` and ``meta``.
- Plain draws (float64): the port's ``solve`` against the JAX
  ``solve(backend="jnp", dtype="float64")`` from the same inits (both
  packages' ``_random_uniform_inits`` replaced by one numpy draw; the edge
  draws' custom inits as drawn): ``n_iter`` equal, losses within 1e-8
  relative, factors within 1e-7.
- Fused draws (float32, the kernels' plain versions): against the JAX
  ``solve(backend="pallas", pallas_interpret=True)`` from the same inits,
  losses within 1e-5 relative and factors within 1e-4, on the first draws of
  seed 0 in the continuous regime of the update map
  (``stress_solve.stable_map``: outside it the JAX tool itself holds no two
  routes to a bound); a shape the JAX planner rejects (ROADMAP R1) is held
  against its ``jnp`` route in float32.
- Every backend's oracles on a few draws, and the geometry planners on 2000
  random geometries (host only).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbmf_mm_tpu as jref
from nbmf_mm_tpu.solver import driver as jd
from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
from nbmf_mm_tpu_torch.solver import driver as pd
from nbmf_mm_tpu_torch.tools import stress_solve as st

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_stress_solve", REPO / "tools" / "stress_solve.py")
jst = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jst)  # imports numpy only at module level

SIX = ("plain", "fused", "estimator", "estimator-fused", "edge", "edge-fused")
PLAIN_TOL = dict(loss=1e-8, factor=1e-7)
FUSED_TOL = dict(loss=1e-5, factor=1e-4)


def _same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", SIX)
def test_draws_are_the_jax_tools_draws(seed, backend):
    ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in range(40):
        Y, kw, meta = st.draw_config(ours, backend)
        jY, jkw, jmeta = jst.draw_config(theirs, st.REFERENCE_NAMES[backend])
        _same(Y, jY, f"draw {i} Y")
        assert kw.keys() == jkw.keys() and meta.keys() == jmeta.keys(), i
        for key in kw:
            if kw[key] is None or jkw[key] is None:
                assert kw[key] is jkw[key] is None, (i, key)
            else:
                _same(kw[key], jkw[key], f"draw {i} kw[{key}]")
        for key in meta:
            _same(meta[key], jmeta[key], f"draw {i} meta[{key}]")
    # Both generators stand at the same state after the 40 draws.
    assert ours.integers(1 << 62) == theirs.integers(1 << 62)


def test_jax_names_draw_as_the_port_names():
    for port, ref in st.REFERENCE_NAMES.items():
        a = st.draw_config(np.random.default_rng(5), port)
        b = st.draw_config(np.random.default_rng(5), ref)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[2] == b[2]


@pytest.mark.parametrize("backend", st.MESH_BACKENDS)
def test_mesh_backends_name_the_multi_gpu_item(backend):
    with pytest.raises(NotImplementedError, match="item 9"):
        st.draw_config(np.random.default_rng(0), backend)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        st.main(["--backend", backend, "--device", "cpu", "--draws", "1"])


@pytest.fixture
def same_inits(monkeypatch):
    """Both packages draw their random inits from one numpy generator."""
    def draws(n_init, m, n, k):
        rng = np.random.default_rng(2024)
        return (rng.uniform(0.1, 0.9, (n_init, m, k)), rng.uniform(0.1, 0.9, (n_init, k, n)))

    monkeypatch.setattr(jd, "_random_uniform_inits", lambda key, n_init, m, n, k, dtype: tuple(
        jnp.asarray(a, dtype=dtype) for a in draws(n_init, m, n, k)))
    monkeypatch.setattr(pd, "_random_uniform_inits", lambda seed, n_init, m, n, k, dtype: tuple(
        torch.tensor(a, dtype=dtype) for a in draws(n_init, m, n, k)))


def _draw(backend, seed, index):
    rng = np.random.default_rng(seed)
    for _ in range(index):
        st.draw_config(rng, backend)
    return st.draw_config(rng, backend)


def _against(res, ref, tol):
    assert res.n_iter == ref.n_iter and len(res.losses) == res.n_iter
    assert res.best_restart == ref.best_restart
    la, lb = np.asarray(res.losses, np.float64), np.asarray(ref.losses, np.float64)
    np.testing.assert_allclose(la, lb, rtol=tol["loss"], atol=0)
    np.testing.assert_allclose(res.W, np.asarray(ref.W), rtol=0, atol=tol["factor"])
    np.testing.assert_allclose(res.H, np.asarray(ref.H), rtol=0, atol=tol["factor"])


PLAIN_DRAWS = [("plain", 0, i) for i in range(12)] + [("edge", 3, i) for i in range(8)]


@pytest.mark.usefixtures("same_inits")
@pytest.mark.parametrize("backend, seed, index", PLAIN_DRAWS)
def test_plain_draw_matches_the_jax_solve(backend, seed, index):
    Y, kw, meta = _draw(backend, seed, index)
    kw, _ = st.finalize_config(Y, kw, meta, backend, device="cpu")
    res = pd.solve(Y, meta["k"], **kw)
    ref = jref.solve(Y, meta["k"], backend="jnp",
                     **{key: val for key, val in kw.items() if key != "device"})
    _against(res, ref, PLAIN_TOL)


def _stable_fused_draws(count, seed=0):
    rng, out = np.random.default_rng(seed), []
    for i in range(200):
        Y, kw, meta = st.draw_config(rng, "fused")
        if st.stable_map(kw):
            out.append(i)
        if len(out) == count:
            return out
    raise AssertionError("too few draws in the continuous regime")


@pytest.mark.usefixtures("same_inits")
@pytest.mark.parametrize("index", _stable_fused_draws(7))
def test_fused_draw_matches_the_jax_pallas_solve(index):
    Y, kw, meta = _draw("fused", 0, index)
    kw, _ = st.finalize_config(Y, kw, meta, "fused", device="cpu")
    res = pd.solve(Y, meta["k"], **kw)
    jkw = {key: val for key, val in kw.items() if key != "device"}
    try:
        ref = jref.solve(Y, meta["k"], **dict(jkw, backend="pallas", pallas_interpret=True))
    except ValueError as e:  # the JAX planner's R1 rejection: its jnp route
        assert "stripe" in str(e) or "block" in str(e), e
        ref = jref.solve(Y, meta["k"], **dict(jkw, backend="jnp", block_m=None, block_n=None))
    _against(res, ref, FUSED_TOL)


@pytest.mark.parametrize("backend", SIX)
def test_every_backend_passes_its_oracles(backend):
    out = st.stress(backend, 3, seed=7, precision="draw", device="cpu", quiet=True)
    assert out["failures"] == [] and out["draws"] == 3


@pytest.mark.parametrize("precision", st.PRECISIONS)
def test_each_operand_form_passes_the_fused_oracles(precision):
    Y, kw, meta = _draw("fused", 0, 0)
    kw, tol_mono = st.finalize_config(Y, kw, meta, "fused", precision, device="cpu")
    assert st.run_draw(Y, kw, meta, "fused", tol_mono) is None  # no card: no comparison
    assert kw["dtype"] == ("bfloat16" if precision == "bf16-data" else "float32")
    assert kw.get("precision") == (precision if precision in ("high", "default") else None)


def test_precision_draw_is_independent_of_the_configurations():
    picks = [st.draw_precision(0, i) for i in range(200)]
    assert set(picks) == set(st.PRECISIONS)
    assert picks == [st.draw_precision(0, i) for i in range(200)]


def test_descent_bounds_scale_with_the_loss():
    assert st._scale([0.5, 0.2]) == 1.0
    assert st._scale([4096.0, 4000.0]) == 4096.0
    assert st._scale([]) == 1.0


def test_host_planner_draw_meets_the_kernels_preconditions():
    out = st.planner_sweep(2000, seed=0, device="cpu", quiet=True)
    assert out["drawn"] == 2000 and out["planned"] + out["refused"] == 2000
    assert out["refused"] >= 1 and out["planned"] > 1500


def test_planner_draw_covers_every_form_rank_edge_and_the_lane_cap():
    rng = np.random.default_rng(0)
    geoms = [st.draw_geometry(rng) for _ in range(2000)]
    assert {g.form for g in geoms} == set(st.FORMS)
    assert {g.n_sm for g in geoms} == set(st.SM_COUNTS) and {g.n_out for g in geoms} == {1, 2}
    assert {33, 65, 129, 257} <= {g.k for g in geoms}
    assert min(g.m for g in geoms) < 32 and max(g.m for g in geoms) > 100_000
    assert max(g.n for g in geoms) > 20_000 and max(g.lanes for g in geoms) == 64
    over = st.draw_geometry(rng)._replace(lanes=cs.MAX_LANES + 1)
    assert st.check_geometry(over) == "refused"
    assert st.check_geometry(over._replace(lanes=1, k=cs.MAX_RANK + 1)) == "refused"


@pytest.mark.parametrize("k", [1, 17, 64, 123, 256])
def test_dyadic_factors_make_wh_and_the_rounded_operands_exact(k):
    from nbmf_mm_tpu_torch.ops import tiers

    W, H = st.dyadic_factors(3, k, 300, 70, 512, 72, torch.Generator().manual_seed(k), "cpu")
    assert W.shape == (3, k, 512) and H.shape == (3, k, 72)
    assert not W[..., 300:].any() and not H[..., 70:].any() and (W[..., :300] > 0).all()
    wh = W.transpose(-1, -2) @ H
    assert torch.equal(wh.double(), W.double().transpose(-1, -2) @ H.double())
    assert float(wh.max()) < 7 / 8
    for form in ("bf16r", "tf32r", "bf16d"):
        for A in (W, H):
            assert torch.equal(tiers.mxu_round(A, form), A)
        assert torch.equal(tiers.complement(H, form), 1.0 - H)


def test_fp32_shared_memory_restates_the_kernels():
    # sweep_kernels.cuh: HPass/WPass kSmem at TK = 8 (k = 128), dense, two
    # operands: (128*64 + 2*128*32 + 2*64*32 + 2*32*64) = 24576 floats for the H pass
    # (plus ll_warp); the W pass's producer and consumer warps at TK = 8 hold four
    # H stages, three of 1 - H and Ps/Qs and two of the operands, (128*64 +
    # 4*128*32 + 3*(128*32 + 2*64*32) + 2*(2*64*32)) = 57344, one block per SM; at
    # TK = 4 (k = 64) one group, (64*64 + 3*64*32 + 2*64*32 + 2*64*32) = 18432, two.
    assert st.fp32_smem("h", 128, dense=True, second=True) == 4 * 24576 + 64
    assert st.fp32_smem("w", 128, dense=True, second=True) == 4 * 57344
    assert st.fp32_smem("w", 64, dense=True, second=True) == 4 * 18432
    assert cs.blocks_per_sm(128) == 2 and cs.blocks_per_sm(129) == 1
    assert cs.w_blocks_per_sm(64) == 2 and cs.w_blocks_per_sm(65) == 1


def test_fp32_shared_memory_of_the_warp_specialised_h_pass():
    # sweep_kernels.cuh: HPass::kSmem at TK = 16 (k = 256) with the terms: H
    # (256*64), three W slices (3*256*32), two stages of Ps/Qs (2*2*64*32)
    # and of the operand tiles, dense two (2*2*32*64) or packed one (2*64),
    # plus the four producer warps' ll_warp; the dense block with its second
    # operand is the largest and fits the 227 KiB a block may use.
    assert st.fp32_smem("h", 256, dense=True, second=True) == 4 * 57344 + 32
    assert st.fp32_smem("h", 256, dense=False, second=False) == 4 * 49280 + 32
    assert st.fp32_smem("h", 256, dense=True, second=True) <= 232_448
    assert st.fp32_smem("h", 256, dense=True, second=False, terms=False) == 4 * (
        256 * 64 + 2 * 256 * 32 + 32 * 64) + 64


@pytest.mark.parametrize("g", [
    st.Geometry(1, 1, 1, 1, "f32", 1, 1),
    st.Geometry(255, 4, 33, 2, "bf16r", 1, 132),
    st.Geometry(200_000, 50_000, 256, 64, "tf32r", 1, 114),
    st.Geometry(300, 1_234, 129, 1, "tf32r", 1, 132),
    st.Geometry(31, 3, 65, 3, "bf16d", 1, 1),
    st.Geometry(10_000, 10_000, 256, 16, "f32", 2, 132),
])
def test_edge_geometries_plan(g):
    assert st.check_geometry(g) == "planned"


def test_a_broken_plan_is_caught(monkeypatch):
    g = st.Geometry(1_000, 1_234, 17, 1, "f32", 1, 132)
    real = cs.plan_h_split

    def gap(Mp, Np, k, n_sm):
        plan = real(Mp, Np, k, n_sm)
        return plan._replace(chunks=plan.chunks[:-1] + ((plan.chunks[-1][0] + 1,
                                                          plan.chunks[-1][1]),))
    monkeypatch.setattr(cs, "plan_h_split", gap)
    with pytest.raises(AssertionError):
        st.check_geometry(g)


def test_main_runs_on_the_cpu(tmp_path, capsys):
    assert st.main(["--backend", "edge", "--device", "cpu", "--draws", "2"]) == 0
    assert st.main(["--backend", "pallas", "--device", "cpu", "--only-draw", "1",
                    "--precision", "draw"]) == 0
    out = tmp_path / "draw.npz"
    assert st.main(["--backend", "edge", "--dump-draw", "4", str(out)]) == 0
    with np.load(out) as d:
        np.testing.assert_array_equal(d["Y"], _draw("edge", 0, 4)[0])
    assert st.main(["--planners", "50", "--device", "cpu"]) == 0
    assert "planner sweep PASSED" in capsys.readouterr().out


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the GPU-less contract")
    with pytest.raises(RuntimeError, match="is_available"):
        st.main(["--draws", "1"])
