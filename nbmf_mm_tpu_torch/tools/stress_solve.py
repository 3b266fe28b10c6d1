"""Randomized stress sweep of the port: ``solve()`` and the estimator over
random configurations, and the kernels' geometry planners over random shapes
(the counterpart of the repository's ``tools/stress_solve.py``).

    python -m nbmf_mm_tpu_torch.tools.stress_solve [--draws 200] [--seed 0]
        [--backend plain|fused|estimator|estimator-fused|edge|edge-fused]
        [--precision none|high|default|bf16-data|draw] [--device cuda|cpu]
        [--only-draw I] [--dump-draw I OUT.npz] [--planners N] [--launch N]

Draw ``i`` of a seed is bitwise the JAX tool's draw ``i`` (the same ``Y``,
``kw`` and ``meta``): :func:`draw_config` consumes the same rng calls, the
port's names standing for the JAX tool's (``plain`` for ``jnp``, ``fused``
for ``pallas``, ``estimator-fused`` for ``estimator-pallas``, ``edge-fused``
for ``edge-pallas``; the JAX names are accepted too).  The fused names draw
the Pallas block sizes, which the port accepts and ignores, so that a failing
draw replays by index in both tools (``--only-draw``, ``--dump-draw``).  The
mesh backends raise ``NotImplementedError`` (ROADMAP queue 1, item 9).

Each draw checks the JAX tool's oracles: descent where the MM guarantee
holds, loss bounds scaled to the loss's magnitude, the simplex and box
constraints (all-zero simplex vectors on fully unobserved rows and
columns), ``len(losses) == n_iter``, finite outputs, packed = dense =
sparse bitwise on fused draws, the warm-start round trip on edge draws and
the estimator contract.  ``--precision draw`` picks one of ``None``,
``"high"``, ``"default"`` and the bf16-data mode per fused draw, so that the
random shapes reach every operand form of the kernels.  On the card each
fused draw in the continuous regime of the update map (``normalize``,
``alpha, beta >= 1``) also runs the card's plain loop with ``tol=0`` from the
same inits, and the fused loop, run with ``tol=0`` too, is held to it:
``n_iter`` equal, losses within ``CARD_LOSS_REL`` relative, factors within
``CARD_FACTOR_ABS``.

``--planners N`` draws ``N`` geometries (``m`` to 2e5, ``n`` to 5e4, ``k``
to 300, 1 to 64 lanes and one draw at ``MAX_LANES + 1``, every operand form,
``n_out`` 1 or 2, 132, 114 or 1 SMs) and holds every plan of
``plan_packing``, ``plan_h_split``, ``plan_w_split``, ``plan_wgmma`` and
``wgmma_shape`` to the launch preconditions of ``ops/csrc/`` (or checks that
the wrappers refuse the geometry with ``ValueError`` before they allocate);
on the card ``--launch N`` of those whose operands fit in 256 MB go through
every pass of their form and are held against the plain versions.

Without a card the device defaults fail; pass ``--device cpu`` (the kernels'
plain versions) for a host run.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from functools import partial
from typing import NamedTuple

import numpy as np

# The JAX tool's backend names and the port's.
PORT_NAMES = {"jnp": "plain", "pallas": "fused", "estimator": "estimator",
              "estimator-pallas": "estimator-fused", "edge": "edge", "edge-pallas": "edge-fused"}
REFERENCE_NAMES = {port: ref for ref, port in PORT_NAMES.items()}
MESH_BACKENDS = ("mesh", "edge-mesh")
FUSED_BACKENDS = ("fused", "estimator-fused", "edge-fused")
# The operand forms a fused draw may take (--precision draw picks one).
PRECISIONS = (None, "high", "default", "bf16-data")
# The card's fused loop against its plain loop (both tol=0, the same inits):
# the bars the fused solve was held to against the JAX interpret mode.
CARD_LOSS_REL = 1e-5
CARD_FACTOR_ABS = 1e-4

# Orientation aliases by canonical form (the estimator's aliases inverted):
# estimator draws pick a random alias and assert that fit() canonicalizes it.
_ORIENT_ALIASES = {
    "beta-dir": ["beta-dir", "Beta-Dir", "binary ICA", "Binary ICA", "bICA"],
    "dir-beta": ["dir-beta", "Dir-Beta", "Dir Beta", "Aspect Bernoulli"],
}


def port_name(backend: str) -> str:
    """The port's name of a backend given by either tool's name; the mesh
    backends raise ``NotImplementedError``."""
    if backend in MESH_BACKENDS:
        raise NotImplementedError(f"backend {backend!r} needs a device mesh, which is not "
                                  "ported yet (ROADMAP: queue 1, item 9, Multi-GPU)")
    if backend in PORT_NAMES:
        return PORT_NAMES[backend]
    if backend in REFERENCE_NAMES:
        return backend
    raise ValueError(f"unknown backend {backend!r}: one of {sorted(REFERENCE_NAMES)} "
                     f"(or the JAX tool's {sorted(PORT_NAMES)})")


def draw_config(rng, backend):
    """One random ``solve()`` configuration ``(Y, kw, meta)``, bitwise the JAX
    tool's draw for the same backend.  Consumes a fixed rng-call sequence
    (nothing downstream draws from ``rng``), so draw i of a seed is
    reproducible by replaying i+1 calls of this function."""
    backend = REFERENCE_NAMES[port_name(backend)]  # the JAX tool's name
    m = int(rng.integers(3, 200))
    n = int(rng.integers(3, 200))
    k = int(rng.integers(1, min(m, n) + 3))  # rank may exceed dims
    p = float(rng.uniform(0.05, 0.95))
    Y = (rng.random((m, n)) < p).astype(float)
    alpha = float(rng.uniform(0.3, 4.0))
    beta = float(rng.uniform(0.3, 4.0))
    orientation = str(rng.choice(["beta-dir", "dir-beta"]))
    projection = str(rng.choice(["normalize", "duchi"]))
    mask_mode = str(rng.choice(["parity", "corrected"]))
    n_init = int(rng.choice([1, 1, 1, 3]))
    masked = bool(rng.random() < 0.5)
    weighted = masked and mask_mode == "corrected" and bool(rng.random() < 0.3)
    if masked:
        mask = (rng.random((m, n)) < rng.uniform(0.4, 0.95)).astype(float)
        if mask.sum() == 0:
            mask.flat[0] = 1.0
        if weighted:
            mask *= rng.uniform(0.2, 1.0, size=mask.shape)
    else:
        mask = None

    kw = dict(
        max_iter=int(rng.integers(3, 60)),
        tol=float(rng.choice([0.0, 1e-6, 1e-4])),
        alpha=alpha, beta=beta, mask=mask,
        random_state=int(rng.integers(0, 2**31)),
        orientation=orientation, projection=projection,
        mask_mode=mask_mode, n_init=n_init,
    )
    # Only the fused (Pallas) and mesh draws consume block sizes, and only
    # mesh draws a mesh shape: each backend's rng sequence is the JAX tool's.
    blocks = (
        (int(rng.choice([64, 128])), int(rng.choice([64, 128])))
        if backend in ("pallas", "mesh", "estimator-pallas", "edge-pallas", "edge-mesh")
        else (None, None)
    )
    mesh_shape = (
        tuple(int(x) for x in rng.choice([[2, 2], [4, 1], [1, 4], [2, 1]]))
        if backend in ("mesh", "edge-mesh")
        else None
    )
    # Only estimator draws consume an alias pick.
    alias = (
        str(rng.choice(_ORIENT_ALIASES[orientation]))
        if backend in ("estimator", "estimator-pallas")
        else orientation
    )
    meta = dict(m=m, n=n, k=k, p=p, masked=masked, weighted=weighted,
                blocks=blocks, mesh_shape=mesh_shape, alias=alias)
    if backend.startswith("edge"):
        # Boundary-biased structural patterns that uniform draws almost never
        # hit (fully unobserved rows and columns, single observations,
        # constant data, k=1, custom inits on the constraint boundary); only
        # edge draws consume these rng calls.
        pattern = str(rng.choice([
            "zero_rows", "zero_cols", "zero_both", "single_obs_rows",
            "one_obs_total", "all_zero_Y", "all_one_Y", "constant_cols",
            "k1", "init_boundary",
        ]))
        meta["pattern"] = pattern
        mask = (rng.random((m, n)) < 0.7).astype(float)
        if pattern == "zero_rows":
            mask[rng.choice(m, size=max(1, m // 3), replace=False), :] = 0.0
        elif pattern == "zero_cols":
            mask[:, rng.choice(n, size=max(1, n // 3), replace=False)] = 0.0
        elif pattern == "zero_both":
            mask[rng.choice(m, size=max(1, m // 4), replace=False), :] = 0.0
            mask[:, rng.choice(n, size=max(1, n // 4), replace=False)] = 0.0
        elif pattern == "single_obs_rows":
            mask[:] = 0.0
            mask[np.arange(m), rng.integers(0, n, size=m)] = 1.0
        elif pattern == "one_obs_total":
            mask[:] = 0.0
            mask[int(rng.integers(0, m)), int(rng.integers(0, n))] = 1.0
        elif pattern == "all_zero_Y":
            Y = np.zeros_like(Y)
            mask = None
        elif pattern == "all_one_Y":
            Y = np.ones_like(Y)
            mask = None
        elif pattern == "constant_cols":
            Y = np.tile((rng.random(n) < 0.5).astype(float), (m, 1))
            mask = None
        elif pattern == "k1":
            meta["k"] = 1
            mask = mask if meta["masked"] else None
        elif pattern == "init_boundary":
            # Custom inits on the constraint boundary: zero simplex vectors
            # (the fixed 0/0 renorm) and exact-0/1 Beta entries (the eps clip).
            k = meta["k"]
            if kw["orientation"] == "beta-dir":
                W0 = rng.random((m, k))
                W0[rng.choice(m, size=max(1, m // 4), replace=False), :] = 0.0
                H0 = (rng.random((k, n)) < 0.5).astype(float)
            else:
                W0 = (rng.random((m, k)) < 0.5).astype(float)
                H0 = rng.random((k, n))
                H0[:, rng.choice(n, size=max(1, n // 4), replace=False)] = 0.0
            kw["W_init"], kw["H_init"] = W0, H0
            kw["n_init"] = 1
            mask = mask if meta["masked"] else None
        # Keep clear of the all-zero-mask ValueError contract.
        if mask is not None and mask.sum() == 0:
            mask.flat[0] = 1.0
        kw["mask"] = mask
        meta["masked"] = mask is not None
        meta["weighted"] = False
    return Y, kw, meta


def draw_precision(seed: int, index: int):
    """The operand form of ``--precision draw`` for draw ``index`` of
    ``seed``: from a generator of its own, so that the configuration draws
    stay the JAX tool's."""
    return PRECISIONS[int(np.random.default_rng([seed, index, 0x7E]).integers(len(PRECISIONS)))]


def finalize_config(Y, kw, meta, backend, precision=None, device="cpu"):
    """``(kw, tol_mono)``: the backend's options and the descent bound that
    applies (``None``: no descent bound, structural checks only)."""
    kw = dict(kw, device=device)
    if port_name(backend) in FUSED_BACKENDS:
        kw.update(backend="fused", dtype="float32",
                  block_m=meta["blocks"][0], block_n=meta["blocks"][1])
        if precision == "bf16-data":
            kw["dtype"] = "bfloat16"
        elif precision is not None:
            kw["precision"] = precision
        # With IEEE fp32 products (precision None) the update map still
        # carries f32 rounding, and near a slow tail the true per-sweep
        # decrease can drop below it: the JAX tool's 5e-4 for exact products.
        # Reduced-precision products move the fixed point (ROADMAP R5): 2e-3.
        tol_mono = 5e-4 if precision is None else 2e-3
    else:
        kw.update(dtype="float64")
        tol_mono = 1e-10
    if kw["mask_mode"] == "parity" and kw["mask"] is not None:
        # Parity masking is the reference's asymmetric scheme, not a true MM
        # descent: no descent bound exists.
        tol_mono = None
    if kw["projection"] == "duchi" or kw["alpha"] < 1.0 or kw["beta"] < 1.0:
        # Descent is guaranteed only for the multiplicative step with
        # alpha, beta >= 1.
        tol_mono = None
    return kw, tol_mono


def _losses(res) -> np.ndarray:
    return np.asarray(res.losses, dtype=np.float64)


def _scale(losses) -> float:
    """The magnitude a loss bound scales with: ``max(1, max |loss|)``.  The
    objective is normalized by the observed count, so a one-observation mask
    gives losses of order 1e4, where one float32 ulp is 4e-3 (the JAX tool's
    rule for its route-parity bounds, applied to every loss bound here)."""
    return max(1.0, float(np.max(np.abs(losses)))) if len(losses) else 1.0


def run_estimator_draw(Y, kw, meta, tol_mono):
    """The estimator's contract on one draw: fit() canonicalizes and stores
    the orientation alias; the fitted attributes; fit() bitwise solve() with
    the same options; same-seed refit and fit_transform bitwise; a
    scipy.sparse fit (sparse mask too) bitwise the dense one;
    transform/score/perplexity deterministic and consistent; on fused draws
    the fused fold-in's simplex rows and packed = dense fold-ins; otherwise
    save_model/load_model round trips and resume_fit continuing the same
    trajectory."""
    import scipy.sparse as sp

    from nbmf_mm_tpu_torch import NBMF, solve
    from nbmf_mm_tpu_torch.utils.checkpoint import load_model, resume_fit, save_model

    k, m, n = meta["k"], meta["m"], meta["n"]
    mask = kw["mask"]
    fused = kw.get("backend") == "fused"
    est_kw = dict(
        n_components=k, alpha=kw["alpha"], beta=kw["beta"],
        max_iter=kw["max_iter"], tol=kw["tol"],
        random_state=kw["random_state"], orientation=meta["alias"],
        n_init=kw["n_init"], projection=kw["projection"],
        mask_mode=kw["mask_mode"], dtype=kw["dtype"], precision=kw.get("precision"),
        device=kw["device"],
    )
    if fused:
        est_kw.update(backend="fused",
                      solver_options=dict(block_m=kw["block_m"], block_n=kw["block_n"]))
    model = NBMF(**est_kw)
    model.fit(Y, mask=mask)

    assert model.orientation == kw["orientation"], meta["alias"]
    losses = np.asarray(model.loss_curve_, dtype=np.float64)
    assert len(losses) == model.n_iter_ and len(losses) > 0
    assert model.objective_history_ is model.loss_curve_
    assert float(model.loss_) == losses[-1] == float(model.reconstruction_err_)
    assert isinstance(model.converged_, (bool, np.bool_))
    assert model.fit_time_ > 0
    assert model.W_.shape == (m, k) and model.components_.shape == (k, n)
    assert np.all(np.isfinite(model.W_)) and np.all(np.isfinite(model.components_))
    if tol_mono is not None and len(losses) > 1:
        viol = float(np.max(np.diff(losses)))
        assert viol <= tol_mono * _scale(losses), f"descent violated by {viol}"

    res = solve(Y, k, **kw)
    np.testing.assert_array_equal(model.W_, res.W)
    np.testing.assert_array_equal(model.components_, res.H)
    np.testing.assert_array_equal(losses, _losses(res))

    m2 = NBMF(**est_kw)
    if mask is None:
        np.testing.assert_array_equal(m2.fit_transform(Y), model.W_)
    else:
        m2.fit(Y, mask=mask)
        np.testing.assert_array_equal(m2.W_, model.W_)
    np.testing.assert_array_equal(np.asarray(m2.loss_curve_), losses)

    m3 = NBMF(**est_kw)
    m3.fit(sp.csr_matrix(Y), mask=None if mask is None else sp.csr_matrix(mask))
    np.testing.assert_array_equal(m3.W_, model.W_)
    np.testing.assert_array_equal(np.asarray(m3.loss_curve_), losses)

    # Fold-in data from a generator of its own (the --only-draw contract).
    rng2 = np.random.default_rng(kw["random_state"] ^ 0xA5A5)
    m_new = int(rng2.integers(2, 40))
    Xnew = (rng2.random((m_new, n)) < meta["p"]).astype(float)
    Wt = model.transform(Xnew)
    assert Wt.shape == (m_new, k) and np.all(np.isfinite(Wt))
    np.testing.assert_array_equal(model.transform(Xnew), Wt)
    rec = model.inverse_transform(Wt)
    assert rec.shape == (m_new, n)
    assert rec.min() >= 0.0 and rec.max() <= 1.0
    s = model.score(Xnew)
    assert np.isfinite(s)
    assert np.isclose(model.perplexity(Xnew), np.exp(-s))

    if fused:
        # backend="fused" routes every transform through fold_in_fused: each
        # returned row is on the simplex to f32 accumulation (k-term sums).
        atol = max(1e-6, 3e-8 * k * 4)
        np.testing.assert_allclose(np.asarray(Wt, np.float64).sum(axis=1), 1.0, atol=atol)
        maskT = (rng2.random((m_new, n)) < 0.8).astype(float) if rng2.random() < 0.5 else None
        try:
            model.packed = False
            Wt_dense = model.transform(Xnew)
            Wtm_dense = None if maskT is None else model.transform(Xnew, mask=maskT)
        finally:
            model.packed = None
        np.testing.assert_array_equal(Wt_dense, Wt)
        if maskT is not None:
            Wtm = model.transform(Xnew, mask=maskT)
            assert Wtm.shape == (m_new, k) and np.all(np.isfinite(Wtm))
            np.testing.assert_array_equal(model.transform(Xnew, mask=maskT), Wtm)
            np.testing.assert_array_equal(Wtm_dense, Wtm)
        return kw

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt.npz")
        save_model(path, model)
        loaded = load_model(path, device=kw["device"])
        np.testing.assert_array_equal(loaded.W_, model.W_)
        np.testing.assert_array_equal(loaded.components_, model.components_)
        np.testing.assert_array_equal(np.asarray(loaded.loss_curve_), losses)
        assert loaded.n_iter_ == model.n_iter_
        # The file names no dtype, and the port's dtype=None is float32: the
        # restored estimator is given the fit's dtype for a bitwise fold-in.
        loaded.dtype = kw["dtype"]
        np.testing.assert_array_equal(loaded.transform(Xnew), Wt)

        resumed = resume_fit(path, Y, mask=mask, device=kw["device"], dtype=kw["dtype"])
        rl = np.asarray(resumed.loss_curve_, dtype=np.float64)
        assert len(rl) == resumed.n_iter_
        assert resumed.n_iter_ >= model.n_iter_
        np.testing.assert_array_equal(rl[: len(losses)], losses)
        if tol_mono is not None and len(rl) > len(losses):
            jump = float(rl[len(losses)] - rl[len(losses) - 1])
            assert jump <= tol_mono * _scale(rl), f"resume boundary ascent {jump}"
    return kw


def stable_map(kw) -> bool:
    """The continuous regime of the update map (``normalize``, ``alpha, beta
    >= 1``), where two routes differ only by rounding; outside it duchi's
    projection is discontinuous and exponents below 1 ride the eps clip, so
    no cross-route bound is valid (the JAX tool's mesh oracle, the same
    rule)."""
    return kw["projection"] != "duchi" and kw["alpha"] >= 1.0 and kw["beta"] >= 1.0


def card_against_plain(Y, k, kw, res):
    """The fused loop on the card against the card's plain loop, both with
    ``tol=0`` from the same inits (a seed's inits are one CPU draw, whatever
    the loop).  Returns ``(gated, stable, {"loss": rel, "factor": abs})``
    (``stable``: :func:`stable_map`).  The bars
    (:data:`CARD_LOSS_REL`, :data:`CARD_FACTOR_ABS`) hold the float32
    products in :func:`stable_map`'s regime (``gated``); elsewhere the
    deviations are reported only: outside that regime no cross-route bound
    is valid, and under a reduced tier or on bf16 data the plain loop (the
    JAX package's emulation of the tier) rounds at other places than the
    kernels, so the two loops are not one function.  With restarts the best
    restart may differ on a near-tie, so every restart's final loss is
    compared and the trajectories only where both pick the same restart."""
    from nbmf_mm_tpu_torch import solve

    stable = stable_map(kw)
    gated = stable and "precision" not in kw and kw["dtype"] == "float32"
    kw0 = dict(kw, tol=0.0)
    fused = res if kw["tol"] == 0.0 else solve(Y, k, **kw0)
    plain = solve(Y, k, **dict(kw0, backend="plain"))
    assert fused.n_iter == plain.n_iter == kw["max_iter"], (fused.n_iter, plain.n_iter)
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    dev = {"loss": 0.0, "factor": 0.0}
    if kw["n_init"] > 1:
        dev["loss"] = rel(fused.all_final_losses, plain.all_final_losses)
    if kw["n_init"] == 1 or fused.best_restart == plain.best_restart:
        dev = {"loss": max(dev["loss"], rel(_losses(fused), _losses(plain))),
               "factor": float(max(np.max(np.abs(fused.W - plain.W)),
                                   np.max(np.abs(fused.H - plain.H))))}
    if gated:
        assert dev["loss"] <= CARD_LOSS_REL and dev["factor"] <= CARD_FACTOR_ABS, (
            f"card against plain: {dev}")
    return gated, stable, dev


def run_draw(Y, kw, meta, backend, tol_mono):
    """Solve one finalized draw and check its oracles.  Returns
    :func:`card_against_plain`'s ``(gated, stable, deviations)`` for a fused
    draw on the card, else None."""
    from nbmf_mm_tpu_torch import solve

    name = port_name(backend)
    if name.startswith("estimator"):
        run_estimator_draw(Y, kw, meta, tol_mono)
        return None

    k, m, n = meta["k"], meta["m"], meta["n"]
    mask = kw["mask"]
    if os.environ.get("NBMF_STRESS_VERBOSE"):
        cfg = {kk: vv for kk, vv in kw.items() if kk not in ("mask", "W_init", "H_init")}
        print(f"draw: m={m} n={n} k={k} p={meta['p']:.3f} masked={meta['masked']} "
              f"weighted={meta['weighted']} {cfg}", flush=True)
    res = solve(Y, k, **kw)

    losses = _losses(res)
    assert len(losses) == res.n_iter, (len(losses), res.n_iter)
    assert np.all(np.isfinite(losses)), "non-finite losses"
    assert np.all(np.isfinite(res.W)) and np.all(np.isfinite(res.H))
    if tol_mono is not None and len(losses) > 1:
        viol = np.max(np.diff(losses))
        assert viol <= tol_mono * _scale(losses), f"descent violated by {viol}"
    # f32 factors: each entry carries ~1 ulp of projection rounding, so a
    # k-term sum drifts by ~k * 6e-8.
    atol = 1e-6 if name == "plain" else max(1e-6, 3e-8 * k * 4)

    def check_simplex(sums, observed):
        sums = sums.astype(np.float64)
        np.testing.assert_allclose(sums[observed], 1.0, atol=atol)
        assert np.all((np.abs(sums - 1.0) <= atol) | (sums == 0.0))

    # An all-zero simplex vector given as an init is absorbing (0 * x = 0):
    # under init_boundary such vectors stay zero even where observed.
    if kw["orientation"] == "beta-dir":
        obs = np.ones(m, bool) if mask is None else mask.sum(axis=1) > 0
        if meta.get("pattern") == "init_boundary":
            obs &= np.asarray(kw["W_init"]).sum(axis=1) > 0
        check_simplex(res.W.sum(axis=1), obs)
        assert res.H.min() >= 0 and res.H.max() <= 1
    else:
        obs = np.ones(n, bool) if mask is None else mask.sum(axis=0) > 0
        if meta.get("pattern") == "init_boundary":
            obs &= np.asarray(kw["H_init"]).sum(axis=0) > 0
        check_simplex(res.H.sum(axis=0), obs)
        assert res.W.min() >= 0 and res.W.max() <= 1

    if name in ("fused", "edge-fused") and not meta["weighted"]:
        # Auto-packing on exactly binary data is bitwise the dense operands
        # (packed=False), and scipy.sparse input (a sparse mask too) bitwise
        # the dense input, whatever route the sparse data takes.
        import scipy.sparse as sp

        a = solve(Y, k, **{**kw, "packed": False})
        np.testing.assert_array_equal(a.W, res.W)
        np.testing.assert_array_equal(_losses(a), losses)
        Smask = None if mask is None else sp.csr_matrix(mask)
        c = solve(sp.csr_matrix(Y), k, **{**kw, "mask": Smask})
        np.testing.assert_array_equal(res.W, c.W)
        np.testing.assert_array_equal(losses, _losses(c))

    if name.startswith("edge"):
        # Re-solving from any returned factors (all-zero simplex vectors,
        # exact-0/1 Beta entries) stays finite; descent across and after the
        # restart holds where the true MM guarantee does.
        kw2 = {k2: v2 for k2, v2 in kw.items() if k2 not in ("W_init", "H_init")}
        kw2.update(W_init=np.asarray(res.W), H_init=np.asarray(res.H), n_init=1)
        r2 = solve(Y, k, **kw2)
        l2 = _losses(r2)
        assert len(l2) == r2.n_iter
        assert np.all(np.isfinite(l2)), "warm-start losses not finite"
        assert np.all(np.isfinite(r2.W)) and np.all(np.isfinite(r2.H))
        mm_ok = tol_mono is not None and (kw["mask_mode"] == "corrected" or kw["mask"] is None)
        if mm_ok and len(l2) > 1:
            viol2 = np.max(np.diff(l2))
            assert viol2 <= tol_mono * _scale(l2), f"warm-start descent violated by {viol2}"
        if mm_ok and len(losses) and len(l2):
            # 1e-8 absorbs the final re-normalization's drift correction.
            bound = max(tol_mono, 1e-8) * _scale(losses)
            assert l2[0] <= losses[-1] + bound, (
                f"warm-start ascent across restart: {l2[0]} > {losses[-1]}")

    if kw["device"] != "cpu" and name in ("fused", "edge-fused"):
        return card_against_plain(Y, k, kw, res)
    return None


def one_draw(rng, backend, precision=None, device="cpu"):
    Y, kw, meta = draw_config(rng, backend)
    kw, tol_mono = finalize_config(Y, kw, meta, backend, precision, device)
    return run_draw(Y, kw, meta, backend, tol_mono)


def stress(backend, draws, seed=0, precision=None, device="cpu", quiet=False):
    """``draws`` draws of ``backend`` from ``seed``.  Every draw runs: a
    draw that fails is recorded with its index (``--only-draw`` replays it)
    and its error, and the sweep goes on.  Returns ``{"draws", "failures":
    [(index, error)], "worst": {"loss", "factor"}, "compared", "forms"}``:
    the worst card-against-plain deviations per operand form and regime
    (``"f32"`` is held to the bars; ``"unstable"`` marks draws outside
    :func:`stable_map`, ``"(reported)"`` deviations held to no bar) with the
    count of draws compared, and the count of draws per operand form."""
    rng = np.random.default_rng(seed)
    failures, worst, compared, forms = [], {}, {}, {}
    for i in range(draws):
        prec = draw_precision(seed, i) if precision == "draw" else precision
        if port_name(backend) in FUSED_BACKENDS:
            form = "f32" if prec is None else prec
            forms[form] = forms.get(form, 0) + 1
        try:
            dev = one_draw(rng, backend, prec, device)
        except Exception as e:  # recorded with its index; the sweep goes on
            failures.append((i, f"{type(e).__name__}: {e}"[:400]))
            if not quiet:
                print(f"FAILED at draw {i} (seed {seed}, precision {prec}): {failures[-1][1]}",
                      flush=True)
            continue
        if dev is not None:
            gated, stable, dev = dev
            key = (("f32" if prec is None else prec) + ("" if stable else " unstable")
                   + ("" if gated else " (reported)"))
            compared[key] = compared.get(key, 0) + 1
            old = worst.get(key, {"loss": 0.0, "factor": 0.0})
            worst[key] = {name: max(old[name], dev[name]) for name in old}
        if not quiet and (i + 1) % 20 == 0:
            print(f"{i + 1}/{draws} drawn, {len(failures)} failed", flush=True)
    return {"draws": draws, "failures": failures, "worst": worst, "compared": compared,
            "forms": forms}


# ------------------------------------------------------------ the planners
# The launch preconditions of ops/csrc/ (sweep_kernels.cuh, sweep_wgmma.cuh,
# sweep_wgmma_tf32.cuh), restated for the host: the card's limits first.
SMEM_OPTIN = 227 * 1024  # a block's shared memory, opt-in maximum of an H100
SMEM_PER_SM = 228 * 1024  # an SM's shared memory
SMEM_RESERVED = 1024  # the runtime's shared memory per resident block
REGS_PER_SM = 65536
GRID_YZ = 65535  # gridDim.y and gridDim.z
GRID_X = 2**31 - 1
FORMS = ("f32", "bf16r", "tf32r", "bf16d")
SM_COUNTS = (132, 114, 1)
MAX_PLANNER_M, MAX_PLANNER_N, MAX_PLANNER_K, MAX_PLANNER_LANES = 200_000, 50_000, 300, 64
# The ranks at which the kernels change instance (TK, KN, nkb) and their
# neighbours; half of the planner draws take one of them.
EDGE_RANKS = (1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 300)
LAUNCH_BYTES = 256 * 2**20  # the operands of a launched geometry
LAUNCH_ENTRIES = 2**25  # lanes x Mp x Np of a launched geometry (plain versions' work)


class Geometry(NamedTuple):
    m: int
    n: int
    k: int
    lanes: int
    form: str
    n_out: int
    n_sm: int


def draw_geometry(rng) -> Geometry:
    """One random geometry: ``m`` and ``n`` log-uniform (so single stripes,
    one word row and the largest shapes all occur), ``k`` uniform to 300 or
    one of :data:`EDGE_RANKS`, lanes log-uniform to 64."""
    log_int = lambda top: int(np.exp(rng.uniform(0.0, np.log(top + 1))))
    m = max(1, min(MAX_PLANNER_M, log_int(MAX_PLANNER_M)))
    n = max(1, min(MAX_PLANNER_N, log_int(MAX_PLANNER_N)))
    k = (int(rng.choice(EDGE_RANKS)) if rng.random() < 0.5
         else int(rng.integers(1, MAX_PLANNER_K + 1)))
    lanes = max(1, min(MAX_PLANNER_LANES, log_int(MAX_PLANNER_LANES)))
    form = str(rng.choice(FORMS))
    n_out = int(rng.choice([1, 2])) if form == "f32" else 1  # n_out 2: the chain3_tile probe
    return Geometry(m, n, k, lanes, form, n_out, int(rng.choice(SM_COUNTS)))


def _tk(k: int) -> int:
    """k rows per thread of the fp32 passes (``dispatch_tk``)."""
    return 1 if k <= 16 else 2 if k <= 32 else 4 if k <= 64 else 8 if k <= 128 else 16


def fp32_smem(which: str, k: int, *, dense: bool, second: bool, terms: bool = True,
              n_out: int = 1) -> int:
    """Bytes of shared memory a block of the fp32 H (``"h"``) or W (``"w"``)
    pass asks for: ``HPass::kSmem``/``WPass::kSmem`` plus the static
    arrays.  ``n_out=2`` is the W probe that reads no operand and forms no
    ``1 - h`` (``chain3_tile``).  The W pass at TK = 8 (its producer and
    consumer warps) holds four H stages, three of 1 - h and Ps/Qs, and two
    of the operand tiles; the H pass at TK = 16 with its terms (its producer
    and consumer warps) three W stages and two each of Ps/Qs and of the
    operand tiles."""
    kpad = 16 * _tk(k)
    nops = 2 if second else 1
    if which == "h":
        ys = 32 * 64 if dense else 64
        if terms and _tk(k) == 16:
            floats = kpad * 64 + 3 * kpad * 32 + 2 * 2 * 64 * 32 + 2 * nops * ys
            return 4 * floats + 8 * 4  # ll_warp of the four producer warps
        floats = kpad * 64 + 2 * kpad * 32 + (2 * 64 * 32 if terms else 0) + nops * ys
        return 4 * floats + 8 * 8  # ll_warp
    reads = n_out == 1
    h_stages, stages, y_stages = (4, 3, 2) if _tk(k) == 8 else (2, 1, 1)
    ys = 64 * 32 if dense else 2 * 32
    floats = (kpad * 64 + h_stages * kpad * 32
              + stages * ((kpad * 32 if reads else 0) + 2 * 64 * 32)
              + y_stages * (nops * ys if reads else 0))
    return 4 * floats


def pass_smem(which: str, form: str, k: int, *, dense: bool, second: bool,
              terms: bool = True, n_out: int = 1) -> int:
    """Shared memory of one block of a pass of ``form`` at rank ``k``."""
    from ..ops import cuda_sweep as cs

    if form == "f32":
        return fp32_smem(which, k, dense=dense, second=second, terms=terms, n_out=n_out)
    shape = cs.wgmma_shape(k, form)
    if which == "h":
        if form == "tf32r" and not terms:  # no phase-B tile
            shape = shape._replace(h_smem=shape.h_smem - 4 * cs.plan_wgmma(k, 32, 4).kn * 32)
        return shape.h_smem + 8 * 4  # ll_warp
    return shape.w_smem


def _chunks_ok(chunks, total: int) -> bool:
    """Chunks that cover ``[0, total)`` in order, with no gap and none empty."""
    at = 0
    for b, e in chunks:
        if b != at or e <= b:
            return False
        at = e
    return at == total


def check_geometry(g: Geometry) -> str:
    """Plan ``g`` as the wrappers do and hold every plan to the kernels'
    launch preconditions; raises ``AssertionError`` where one fails.
    Returns ``"planned"``, or ``"refused"`` where the wrappers raise
    ``ValueError`` before they allocate (a rank above ``MAX_RANK`` or more
    than ``MAX_LANES`` lanes)."""
    import torch

    from ..ops import cuda_sweep as cs
    from ..solver.driver import _resolve_backend

    refused = []
    # The lane count is checked first, on the factors' shapes alone: an
    # expanded view allocates nothing.
    W = torch.zeros((1, 1, 1)).expand(g.lanes, 1, 1)
    try:
        cs.lane_count("stress", W, W)
    except ValueError:
        refused.append("lanes")
    if g.k > cs.MAX_RANK:
        try:
            _resolve_backend("fused", torch.float32, torch.device("cpu"), True, None, g.k)
        except ValueError:
            refused.append("rank")
        else:
            raise AssertionError(f"{g}: backend='fused' took k={g.k} above MAX_RANK")
        if g.form != "f32":
            try:
                cs.plan_wgmma(g.k, 32, 4)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{g}: plan_wgmma took k={g.k} above MAX_RANK")
    assert (g.lanes > cs.MAX_LANES) == ("lanes" in refused), g
    if refused:
        return "refused"

    bm, Mp, Np = cs.plan_packing(g.m, g.n)
    Mw = Mp // cs.PACKED_WORD_BITS
    assert Np % 4 == 0 and Np >= g.n and Np - g.n < 4, (g, Np)
    assert bm % 32 == 0 and bm >= 32 and Mp % bm == 0 and Mp >= g.m and Mp - g.m < bm, (g, bm, Mp)
    assert bm == (256 if g.m >= 256 else cs.round_up(g.m, 32)), (g, bm)
    # 16-byte rows and lane strides of every operand and factor the kernels
    # copy as vectors (_check_aligned): Np floats or words per row, k Mp and
    # k Np floats per lane.
    assert (4 * Np) % 16 == 0 and (4 * g.k * Mp) % 16 == 0 and (4 * g.k * Np) % 16 == 0, g

    hs = cs.plan_h_split(Mp, Np, g.k, g.n_sm)
    ws = cs.plan_w_split(Mp, Np, g.k, g.n_sm, g.n_out, tensor_cores=g.form != "f32")
    assert 1 <= hs.nsplit <= Mw and _chunks_ok(hs.chunks, Mw), (g, hs)
    assert 1 <= ws.nsplit <= -(-Np // cs.W_TILE) and _chunks_ok(ws.chunks, Np), (g, ws)
    assert all(b % cs.W_TILE == 0 for b, _ in ws.chunks), (g, ws)
    assert hs.nsplit <= GRID_YZ and ws.nsplit <= GRID_YZ and g.lanes <= GRID_YZ, g
    assert (hs.scratch is None) == (hs.nsplit == 1) and (ws.scratch is None) == (ws.nsplit == 1)
    if hs.scratch is not None:
        assert hs.scratch == (hs.nsplit, g.k, Np), (g, hs)
    if ws.scratch is not None:
        assert ws.scratch == (ws.nsplit, g.n_out * g.k, Mp), (g, ws)

    packed_forms = g.form in ("f32", "bf16r", "tf32r")
    col_blocks, row_blocks = -(-Np // cs.H_COLS), (Mw + 1) // 2
    if g.form == "f32":
        assert 1 <= g.k <= cs.MAX_RANK, g
        # The fp32 passes: grid x of each pass and of the small kernels
        # around them (the bit-plane copy, the split sums).
        assert col_blocks <= GRID_X and row_blocks <= GRID_X
        assert -(-g.k * Mp // 256) <= GRID_X and -(-g.k * Np // 256) <= GRID_X
        # the launch bounds' kMinBlocks of each pass
        assert cs.blocks_per_sm(g.k) == (2 if _tk(g.k) <= 8 else 1), g
        assert cs.w_blocks_per_sm(g.k) == (2 if _tk(g.k) <= 4 else 1), g
        for which in ("h", "w"):
            resident = cs.blocks_per_sm(g.k) if which == "h" else cs.w_blocks_per_sm(g.k)
            for dense in ((False, True) if packed_forms else (True,)):
                for second in (False, True):
                    smem = pass_smem(which, "f32", g.k, dense=dense, second=second,
                                     n_out=g.n_out if which == "w" else 1)
                    assert smem <= SMEM_OPTIN, (g, which, smem)
                    # The resident blocks the plan counts: their shared memory
                    # and registers (128 a thread of 256 threads at two blocks;
                    # at one, the W pass's 512 threads at TK = 8 take 128).
                    assert resident * (smem + SMEM_RESERVED) <= SMEM_PER_SM, (g, which, smem)
                    threads = 512 if which == "w" and _tk(g.k) == 8 else 256
                    regs = 128 if resident == 2 or threads == 512 else 255
                    assert resident * threads * regs <= REGS_PER_SM, (g, which)
        return "planned"

    assert g.n_out == 1, g
    plan = cs.plan_wgmma(g.k, Mp, Np)
    assert plan.kn in (32, 64, 128) and plan.kn >= min(g.k, 128), (g, plan)
    assert plan.nkb == -(-g.k // plan.kn) and plan.kstage == plan.kn * plan.nkb >= g.k
    # Staged rows: a multiple of 64 elements, past Mp + 32 / Np + 32, so each
    # 64-wide tile a step reads from any 32-boundary lies inside its row.
    assert plan.Mps % 64 == 0 and plan.Mps >= Mp + 32, (g, plan)
    assert plan.Nps % 64 == 0 and plan.Nps >= Np + 32, (g, plan)
    elem = 2 if g.form in cs.WGMMA_FORMS else 4
    assert (elem * plan.kstage * plan.Mps) % 16 == 0 and (elem * plan.kstage * plan.Nps) % 16 == 0
    shape = cs.wgmma_shape(g.k, g.form)
    assert shape.step == (64 if g.form in cs.WGMMA_FORMS else 32), (g, shape)
    assert (col_blocks * plan.nkb <= GRID_X and row_blocks * plan.nkb <= GRID_X)
    if g.form == "tf32r":
        # The TF32 staging grid (Mps/32, kstage/32, lanes) of 32 x 8 threads.
        assert plan.Mps % 32 == 0 and plan.Nps % 32 == 0 and plan.kstage % 32 == 0
        assert plan.kstage // 32 <= GRID_YZ
    for which in ("h", "w"):
        for terms in ((True, False) if which == "h" else (True,)):
            smem = pass_smem(which, g.form, g.k, dense=True, second=True, terms=terms)
            assert smem <= SMEM_OPTIN, (g, which, smem)
    return "planned"


def launch_fits(g: Geometry) -> bool:
    """Whether a planned geometry is launched on the card: its operands
    (dense data and a second operand, R lanes of factors and outputs) within
    :data:`LAUNCH_BYTES`, and the plain versions' work within
    :data:`LAUNCH_ENTRIES`."""
    from ..ops import cuda_sweep as cs

    bm, Mp, Np = cs.plan_packing(g.m, g.n)
    factors = g.lanes * g.k * (Mp + Np) * 4 * 3
    return (2 * 4 * Mp * Np + factors <= LAUNCH_BYTES
            and g.lanes * Mp * Np <= LAUNCH_ENTRIES and g.k <= cs.MAX_RANK)


# Phase 3's bars of chip_smoke.py: Num/Den/T within 1e-5 of max |plain|, ll
# within 1e-6 relative.
LAUNCH_BARS = (1e-5, 1e-6)


def dyadic_factors(lanes, k, m, n, Mp, Np, gen, device):
    """Factors on which every product and partial sum of ``W^T H`` is exact
    in float32, and every operand exact in bf16 and TF32: ``W`` entries
    ``u / 2^c`` (``u`` in 1..7, ``2^c >= 8 k``, so ``W^T H < 7/8``) and
    ``H`` entries ``v / 64`` (``v`` in 1..63).  A reduced form's kernel then
    forms bitwise the plain version's ``WH``, ``p`` and ``q`` (they differ
    only where a sum in another order rounds one of them to the next bf16
    or TF32 value, which moves a sum over few rows by more than any fixed
    fraction of its largest entry), so it is held to the float32 bars."""
    import torch

    c = 3 + max(0, (k - 1).bit_length())
    W = torch.zeros((lanes, k, Mp), device=device)
    W[..., :m] = torch.randint(1, 8, (lanes, k, m), generator=gen, device=device) / 2.0**c
    H = torch.zeros((lanes, k, Np), device=device)
    H[..., :n] = torch.randint(1, 64, (lanes, k, n), generator=gen, device=device) / 64.0
    return W, H


def launch_geometry(g: Geometry, device, seed: int = 0, dyadic: bool = False) -> dict:
    """Every pass of ``g``'s form on ``device`` against its plain version, on
    binary data in corrected mode (both operands) with ``g.lanes`` lanes:
    random simplex factors, or with ``dyadic`` :func:`dyadic_factors`.
    Returns the worst relative errors ``{"terms", "ll"}`` (Num/Den/T against
    max |plain|, ll relative)."""
    import torch

    from ..ops import cuda_sweep as cs
    from ..ops import dense_sweep as ds

    bm, Mp, Np = cs.plan_packing(g.m, g.n)
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    Y = (rand(g.m, g.n) < 0.3).float()
    mask = (rand(g.m, g.n) < 0.8).float()
    pad = lambda A: torch.nn.functional.pad(A, (0, Np - g.n, 0, Mp - g.m)).contiguous()
    Ym, Ym2 = pad(Y * mask), pad((1.0 - Y) * mask)
    if dyadic:
        W, H = dyadic_factors(g.lanes, g.k, g.m, g.n, Mp, Np, gen, device)
    else:
        W = torch.zeros((g.lanes, g.k, Mp), device=device)
        W[..., : g.m] = rand(g.lanes, g.k, g.m) * 0.8 + 0.1
        W[..., : g.m] /= W[..., : g.m].sum(dim=-2, keepdim=True)
        H = torch.zeros((g.lanes, g.k, Np), device=device)
        H[..., : g.n] = rand(g.lanes, g.k, g.n) * 0.8 + 0.1
    if g.lanes == 1:
        W, H = W[0], H[0]
    precision = {"f32": None, "bf16r": "default", "tf32r": "high", "bf16d": None}[g.form]
    kw = dict(eps=1e-8, bm=bm, precision=precision)
    hkw = dict(kw, m_real=g.m, n_real=g.n)
    wkw = dict(kw, n_real=g.n)
    plain = lambda fn, fkw: partial(cs.per_lane, fn, **{key: val for key, val in fkw.items()
                                                       if key != "bm"})
    runs = []
    if g.form != "bf16d":
        words, words2 = cs.pack_bits(Ym, bm), cs.pack_bits(Ym2, bm)
        runs += [(partial(cs.hloss_terms_packed, **hkw),
                  partial(cs.per_lane, cs.hloss_terms_packed_plain, **hkw), (words, words2)),
                 (partial(cs.w_terms_packed, **wkw),
                  partial(cs.per_lane, cs.w_terms_packed_plain, **wkw), (words, words2))]
    dense = (Ym.to(torch.bfloat16), Ym2.to(torch.bfloat16)) if g.form == "bf16d" else (Ym, Ym2)
    runs += [(partial(ds.hloss_terms, **hkw), plain(ds.hloss_terms_plain, hkw), dense),
             (partial(ds.w_terms, **wkw), plain(ds.w_terms_plain, wkw), dense),
             (partial(ds.loglik_sum, **hkw), plain(ds.loglik_sum_plain, hkw), dense)]
    worst = {"terms": 0.0, "ll": 0.0}
    for kernel, reference, ops in runs:
        got, want = kernel(W, H, *ops), reference(W, H, *ops)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            a, b = a.double(), b.double()
            if a.dim() == (0 if g.lanes == 1 else 1):  # ll, one per lane
                worst["ll"] = max(worst["ll"], float(((a - b).abs() / b.abs()).max()))
            else:
                worst["terms"] = max(worst["terms"], float((a - b).abs().max() / b.abs().max()))
    return worst


def planner_sweep(count, seed=0, launch=0, device="cpu", quiet=False):
    """``count`` geometries from ``seed`` (the last at ``MAX_LANES + 1``
    lanes), each planned and checked (:func:`check_geometry`); on a CUDA
    ``device`` the first ``launch`` planned geometries that
    :func:`launch_fits` go through every pass of their form
    (:func:`launch_geometry`), and a refused rank and lane count are passed
    to the wrappers, which must raise ``ValueError`` with nothing allocated.

    A launched geometry is held to :data:`LAUNCH_BARS`: the float32 form on
    random factors, a reduced form on :func:`dyadic_factors`; a reduced form
    on random factors is launched too and its deviation reported (``
    "reported"``), not held to a bar.  Returns the counts, the worst held
    and reported errors and the launches per form; raises
    ``AssertionError`` past a bar."""
    from ..ops import cuda_sweep as cs

    rng = np.random.default_rng(seed)
    geoms = [draw_geometry(rng) for _ in range(count - 1)]
    geoms.append(draw_geometry(rng)._replace(lanes=cs.MAX_LANES + 1))
    out = {"drawn": 0, "planned": 0, "refused": 0, "launched": 0, "forms": {},
           "worst": {"terms": 0.0, "ll": 0.0}, "reported": {"terms": 0.0, "ll": 0.0}}
    picked = []
    for g in geoms:
        out[check_geometry(g)] += 1
        out["drawn"] += 1
        if g.lanes <= cs.MAX_LANES and g.k <= cs.MAX_RANK and len(picked) < launch \
                and launch_fits(g):
            picked.append(g)
    merge = lambda a, b: {key: max(a[key], b[key]) for key in a}
    if device != "cpu" and picked:
        for i, g in enumerate(picked):
            held = launch_geometry(g, device, seed=seed + i, dyadic=g.form != "f32")
            assert held["terms"] <= LAUNCH_BARS[0] and held["ll"] <= LAUNCH_BARS[1], (g, held)
            out["worst"] = merge(out["worst"], held)
            if g.form != "f32":
                out["reported"] = merge(out["reported"], launch_geometry(g, device, seed=seed + i))
            out["forms"][g.form] = out["forms"].get(g.form, 0) + 1
            out["launched"] += 1
        out["refusals"] = refusals_on_the_card(device)
    if not quiet:
        print(f"planner sweep: {json.dumps(out)}", flush=True)
    return out


def refusals_on_the_card(device) -> int:
    """A rank above ``MAX_RANK`` and ``MAX_LANES + 1`` lanes through the
    wrappers on ``device``: each raises ``ValueError`` and allocates
    nothing.  Returns the count of refusals checked."""
    import torch

    from ..ops import cuda_sweep as cs
    from ..ops import dense_sweep as ds

    bm, Mp, Np = cs.plan_packing(32, 4)
    k = cs.MAX_RANK + 1
    W, H = torch.ones((k, Mp), device=device), torch.ones((k, Np), device=device)
    Ym = torch.zeros((Mp, Np), device=device)
    words = torch.zeros((Mp // 32, Np), dtype=torch.int32, device=device)
    lanes_W = torch.ones((1, 4, Mp), device=device).expand(cs.MAX_LANES + 1, 4, Mp)
    lanes_H = torch.ones((1, 4, Np), device=device).expand(cs.MAX_LANES + 1, 4, Np)
    calls = [lambda: cs.hloss_terms_packed(W, H, words, eps=1e-8, m_real=32, n_real=4, bm=bm),
             lambda: cs.w_terms_packed(W, H, words, eps=1e-8, n_real=4, bm=bm),
             lambda: ds.hloss_terms(W, H, Ym, eps=1e-8, m_real=32, n_real=4, bm=bm),
             lambda: ds.w_terms(W, H, Ym, eps=1e-8, n_real=4, bm=bm,
                                precision="high"),
             lambda: cs.hloss_terms_packed(lanes_W, lanes_H, words, eps=1e-8, m_real=32,
                                           n_real=4, bm=bm),
             lambda: ds.w_terms(lanes_W, lanes_H, Ym, eps=1e-8, n_real=4, bm=bm)]
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    for call in calls:
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError("a wrapper took a geometry past MAX_RANK or MAX_LANES")
        assert torch.cuda.memory_allocated(device) == before, "a refused call allocated"
    return len(calls)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--draws", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="plain",
                    choices=sorted(REFERENCE_NAMES) + sorted(PORT_NAMES) + list(MESH_BACKENDS))
    ap.add_argument("--precision", default="none",
                    choices=["none", "high", "default", "bf16-data", "draw"],
                    help="the operand form of fused draws; 'draw' picks one per draw")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only-draw", type=int, default=None,
                    help="replay the rng and solve only this draw index")
    ap.add_argument("--dump-draw", nargs=2, metavar=("I", "OUT"), default=None,
                    help="save draw I's Y/mask/config to OUT (.npz) without solving")
    ap.add_argument("--planners", type=int, default=0,
                    help="draw this many kernel geometries instead of solves")
    ap.add_argument("--launch", type=int, default=64,
                    help="planned geometries to launch on the card with --planners")
    args = ap.parse_args(argv)
    precision = None if args.precision == "none" else args.precision
    backend = port_name(args.backend)

    if args.dump_draw is not None:
        idx, out = int(args.dump_draw[0]), args.dump_draw[1]
        rng = np.random.default_rng(args.seed)
        for _ in range(idx):
            draw_config(rng, backend)
        Y, kw, meta = draw_config(rng, backend)
        mask = kw.pop("mask")
        for key in ("W_init", "H_init"):
            if key in kw:
                kw[key] = np.asarray(kw[key]).tolist()
        np.savez(out, Y=Y, mask=(np.zeros(0) if mask is None else mask),
                 kw=json.dumps(kw), meta=json.dumps(meta))
        print(f"draw {idx} (seed {args.seed}) -> {out}: m={meta['m']} n={meta['n']} "
              f"k={meta['k']}")
        return 0

    from ..ops import cuda_sweep as cs

    device = str(cs.resolve_device(args.device))
    t0 = time.perf_counter()
    if args.planners:
        out = planner_sweep(args.planners, args.seed, args.launch, device)
        print(f"planner sweep PASSED in {time.perf_counter() - t0:.1f} s on {device}")
        return 0
    if args.only_draw is not None:
        rng = np.random.default_rng(args.seed)
        for _ in range(args.only_draw):
            draw_config(rng, backend)
        prec = draw_precision(args.seed, args.only_draw) if precision == "draw" else precision
        dev = one_draw(rng, backend, prec, device)
        print(f"draw {args.only_draw} (seed {args.seed}, precision {prec}) PASSED; card "
              f"against plain {dev}")
        return 0
    out = stress(backend, args.draws, args.seed, precision, device)
    print(f"stress sweep: {args.draws} draws, backend={backend}, precision={args.precision}, "
          f"device={device}: {len(out['failures'])} failed; card against plain over "
          f"{out['compared']} draws: worst {out['worst']}; forms {out['forms']} "
          f"({time.perf_counter() - t0:.1f} s)")
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
