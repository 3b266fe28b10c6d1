"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the sweep kernels from ``nbmf_mm_tpu_torch/ops/csrc`` (one ``nvcc`` per
source, started together) and checks each against its plain PyTorch version
on the card: the bit-packed pair K1/K2 and the three dense kernels, which on
binary data must equal K1/K2 bitwise.  Then it drives the port's three main
paths through the entry points a user calls, each with the launch counters
set to 0 just before and read just after:

1. the binary fit, ``NBMF.fit`` on a 10^4 x 10^4 binary matrix at K=128,
   float32 (K1 and K2);
2. the dense fit, ``NBMF.fit`` on the 10^4 x 10^4 [0,1]-valued mean matrix
   of the ``link="mean"`` generator at K=128 (the dense H pass, W pass and
   the ``loglik_sum`` fill);
3. fold-in serving, ``FoldInServer`` on that model with binary requests of
   100 to 20 000 rows (K2) and a weighted-mask request (the dense W pass).

It also checks packed against dense through ``solve``, runs masked and
dir-beta fits and a fold-in on the lastfm matrix, and times the kernels, the
two fused loops and the serving requests.

Phase 7 is the measurement path (``nbmf_mm_tpu_torch/tools/``): ``h_terms``
and every variant of the ten probe kernels against their plain versions at
the tools' correctness shape (512 x 640, K=16) and their headline size
(10240^2, K=128), the bitwise equalities (``h_terms`` and ``hloss_terms``;
``hloss_ngrid`` packed and dense; ``hloss_packed`` and ``hloss_packed2``),
a timing line per probe, then every script of the package through its entry
point with the launch counters zeroed before and read after.

Each phase prints one line or more; any failure raises and the script exits
non-zero.  The last line is a JSON object with ``"ok": true`` and the
device; the line before it lists the kernels.

Imports torch, numpy and nbmf_mm_tpu_torch only.  Needs one CUDA card.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import time
from functools import partial

import numpy as np
import torch

DEV = "cuda"
HEADLINE = dict(m=10_000, n=10_000, k=128, density=0.3, seed=0)
FIT_SWEEPS = 100
# Serving: binary requests of these row counts (the largest is chunked by the
# top bucket) and one weighted-mask request of the top bucket's rows.
SERVE_ROWS = (100, 3_000, 8_192, 20_000)
SERVE_BUCKETS = (64, 256, 1024, 4096, 8192)
LASTFM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "lastfm.npz")
EPS = 1e-8
# Kernel against plain: Num/Den/T within 1e-5 of max |plain| (fp32 sums in
# another order); ll and the probes' scalar sums within 1e-6 of sum |x|
# (both add in fp64).
TOL_TERMS = 1e-5
TOL_LL = 1e-6
# Fold-in W from the kernels against the plain fold-in's after 50 iterations.
TOL_FOLD_IN = 1e-4
# The JAX reference package is named as the port without its "_torch".
SWEEP = "nbmf_mm_tpu_torch".removesuffix("_torch") + "/ops/pallas_sweep.py"
# name: (source, file:line of the TPU kernel it replaces).  The kernels of
# the three main paths; the dense H and W kernels also replace the stripe
# forms hloss_terms_stripe (:546) and w_terms_stripe (:650).
PATH_KERNELS = {
    "hloss_terms_packed": ("sweep_packed.cu", f"{SWEEP}:843"),
    "w_terms_packed": ("sweep_packed.cu", f"{SWEEP}:947"),
    "hloss_terms": ("sweep_dense.cu", f"{SWEEP}:212"),
    "w_terms": ("sweep_dense.cu", f"{SWEEP}:333"),
    "loglik_sum": ("sweep_dense.cu", f"{SWEEP}:444"),
}
# The kernels that only the measurement path (nbmf_mm_tpu_torch/tools/)
# runs: h_terms and the probes of the repository's tools/ scripts.
MEASUREMENT_KERNELS = {
    "h_terms": ("sweep_dense.cu", f"{SWEEP}:122"),
    "make_kernel": ("probes.cu", "tools/bench_diag.py:38"),
    "hloss_packed": ("probes.cu", "tools/bench_packed.py:65"),
    "w_packed": ("probes.cu", "tools/bench_packed.py:135"),
    "hloss_packed2": ("probes.cu", "tools/bench_packed2.py:50"),
    "w_packed2": ("probes.cu", "tools/bench_packed2.py:118"),
    "mxu_only": ("probes.cu", "tools/bench_packed2.py:168"),
    "mxu_probe": ("probes.cu", "tools/bench_packed3.py:37"),
    "hloss_ngrid": ("probes.cu", "tools/bench_packed3.py:110"),
    "stream_kernel": ("probes.cu", "tools/bench_stream.py:26"),
    "frag_kernel": ("probes.cu", "tools/bench_vpu.py:32"),
}
KERNELS = {**PATH_KERNELS, **MEASUREMENT_KERNELS}
# The measurement path's scripts, driven through their entry points.
TOOLS = ("bench_kernels", "bench_true", "bench_packed", "bench_packed2", "bench_packed3",
         "bench_diag", "bench_stream", "bench_vpu")
# Probe shapes: the tools' correctness shape and their headline size.
PROBE_SIZES = ((512, 640, 16), (10_240, 10_240, 128))
CSRC = "nbmf_mm_tpu_torch/ops/csrc/"
MODES = ("unmasked", "parity", "corrected")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` launches, after a
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def zero_counts(*modules) -> None:
    for module in modules:
        for name in module.LAUNCHES:
            module.LAUNCHES[name] = 0


def read_counts(*modules) -> dict:
    return {name: n for module in modules for name, n in module.LAUNCHES.items()}


def headline_matrix() -> np.ndarray:
    h = HEADLINE
    rng = np.random.default_rng(h["seed"])
    return (rng.random((h["m"], h["n"])) < h["density"]).astype(np.float32)


def mean_matrix() -> np.ndarray:
    """The [0,1]-valued mean matrix W_true @ H_true of the ``link="mean"``
    generator at the headline size, seed 0: soft binary data in the model's
    own mean parameterization."""
    from nbmf_mm_tpu_torch.utils.synth import generate_synthetic_binary_data

    h = HEADLINE
    _, W_true, H_true = generate_synthetic_binary_data(
        h["m"], h["n"], h["k"], random_state=h["seed"], link="mean")
    return (W_true @ H_true).astype(np.float32)


def lastfm_matrix() -> np.ndarray:
    with np.load(LASTFM) as d:
        return d["Y"].astype(np.float32)


def padded(A: torch.Tensor, Mp: int, Np: int) -> torch.Tensor:
    return torch.nn.functional.pad(A, (0, Np - A.shape[1], 0, Mp - A.shape[0])).contiguous()


def factors(m, n, k, Mp, Np, seed):
    """Random (W, H) on the card at the solver's padded geometry."""
    rng = np.random.default_rng(seed)
    W = np.zeros((k, Mp), np.float32)
    W[:, :m] = rng.uniform(0.1, 0.9, (k, m))
    W[:, :m] /= W[:, :m].sum(axis=0, keepdims=True)
    H = np.zeros((k, Np), np.float32)
    H[:, :n] = rng.uniform(0.1, 0.9, (k, n))
    return torch.tensor(W, device=DEV), torch.tensor(H, device=DEV)


def operands(Y, k, mode, seed, cs, *, weighted=False):
    """Dense operands (``Ym``, the H pass's ``Yc``, the W pass's ``Ym2``,
    padded), their packed words when the mask is binary, and random (W, H).
    ``weighted`` gives the mask entries of 0.5 (20% of the observed)."""
    m, n = Y.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    Yt = torch.as_tensor(Y, device=DEV)
    if mode == "unmasked":
        Ym, Ym2 = padded(Yt, Mp, Np), None
    else:
        u = torch.rand((m, n), generator=gen, device=DEV)
        mask = (u < 0.8).float()
        if weighted:
            mask = mask * torch.where(u < 0.16, 0.5, 1.0)
        Ym, Ym2 = padded(Yt * mask, Mp, Np), padded((1 - Yt) * mask, Mp, Np)
    W, H = factors(m, n, k, Mp, Np, seed)
    o = dict(W=W, H=H, Ym=Ym, Yc=Ym2 if mode == "corrected" else None, Ym2=Ym2, m=m, n=n,
             bm=bm)
    if not weighted:
        o["words"] = cs.pack_bits(Ym, bm)
        o["words2_w"] = None if Ym2 is None else cs.pack_bits(Ym2, bm)
        o["words2_h"] = o["words2_w"] if mode == "corrected" else None
    return o


def check_packed_kernels(name, Y, k, card, cs, errors):
    """K1 and K2 against their plain versions in all three mask modes, and
    launched twice for bitwise repeatability."""
    for mode in MODES:
        o = operands(Y, k, mode, 1, cs)
        k1 = lambda: cs.hloss_terms_packed(o["W"], o["H"], o["words"], o["words2_h"], eps=EPS,
                                           m_real=o["m"], n_real=o["n"], bm=o["bm"])
        k2 = lambda: cs.w_terms_packed(o["W"], o["H"], o["words"], o["words2_w"], eps=EPS,
                                       n_real=o["n"], bm=o["bm"])
        num, den, ll = k1()
        num2, den2, ll2 = k1()
        T, T2 = k2(), k2()
        torch.cuda.synchronize()
        pnum, pden, pll = cs.hloss_terms_packed_plain(
            o["W"], o["H"], o["words"], o["words2_h"], eps=EPS, m_real=o["m"], n_real=o["n"],
            bm=o["bm"])
        pT = cs.w_terms_packed_plain(o["W"], o["H"], o["words"], o["words2_w"], eps=EPS,
                                     n_real=o["n"], bm=o["bm"])
        e = dict(num=rel(num, pnum), den=rel(den, pden), T=rel(T, pT), ll=rel_ll(ll, pll))
        errors["hloss_terms_packed"] = max(errors["hloss_terms_packed"], abs_err(num, pnum),
                                           abs_err(den, pden), abs_err(ll, pll))
        errors["w_terms_packed"] = max(errors["w_terms_packed"], abs_err(T, pT))
        repeat = all(map(torch.equal, (num, den, ll, T), (num2, den2, ll2, T2)))
        print(f"kernels {name} {mode} k={k}: rel err num {e['num']:.3e} den {e['den']:.3e} "
              f"T {e['T']:.3e} (bound {TOL_TERMS:g} of max|plain|), ll {e['ll']:.3e} "
              f"(bound {TOL_LL:g}); bitwise repeat {repeat} [{card}]", flush=True)
        check(max(e["num"], e["den"], e["T"]) <= TOL_TERMS and e["ll"] <= TOL_LL,
              f"{name} {mode}: kernel disagrees with plain {e}")
        check(repeat, f"{name} {mode}: kernel outputs differ between two launches")


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def rel_ll(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_dense_kernels(name, Y, k, card, cs, ds, errors):
    """The three dense kernels against their plain versions in all three
    mask modes (weighted masks), each launched twice for bitwise
    repeatability; loglik_sum's ll equals the H pass's bitwise."""
    for mode in MODES:
        o = operands(Y, k, mode, 5, cs, weighted=True)
        kw_h = dict(eps=EPS, m_real=o["m"], n_real=o["n"])
        kw_w = dict(eps=EPS, n_real=o["n"])
        h = lambda: ds.hloss_terms(o["W"], o["H"], o["Ym"], o["Yc"], bm=o["bm"], **kw_h)
        w = lambda: ds.w_terms(o["W"], o["H"], o["Ym"], o["Ym2"], bm=o["bm"], **kw_w)
        s = lambda: ds.loglik_sum(o["W"], o["H"], o["Ym"], o["Yc"], bm=o["bm"], **kw_h)
        (num, den, ll), (num2, den2, ll2) = h(), h()
        T, T2 = w(), w()
        lls, lls2 = s(), s()
        torch.cuda.synchronize()
        pnum, pden, pll = ds.hloss_terms_plain(o["W"], o["H"], o["Ym"], o["Yc"], **kw_h)
        pT = ds.w_terms_plain(o["W"], o["H"], o["Ym"], o["Ym2"], **kw_w)
        plls = ds.loglik_sum_plain(o["W"], o["H"], o["Ym"], o["Yc"], **kw_h)
        e = dict(num=rel(num, pnum), den=rel(den, pden), T=rel(T, pT), ll=rel_ll(ll, pll),
                 loglik=rel_ll(lls, plls))
        errors["hloss_terms"] = max(errors["hloss_terms"], abs_err(num, pnum),
                                    abs_err(den, pden), abs_err(ll, pll))
        errors["w_terms"] = max(errors["w_terms"], abs_err(T, pT))
        errors["loglik_sum"] = max(errors["loglik_sum"], abs_err(lls, plls))
        repeat = all(map(torch.equal, (num, den, ll, T, lls), (num2, den2, ll2, T2, lls2)))
        same_ll = torch.equal(lls, ll)
        print(f"dense kernels {name} {mode} k={k}: rel err num {e['num']:.3e} den "
              f"{e['den']:.3e} T {e['T']:.3e} (bound {TOL_TERMS:g} of max|plain|), ll "
              f"{e['ll']:.3e} loglik_sum {e['loglik']:.3e} (bound {TOL_LL:g}); bitwise repeat "
              f"{repeat}; loglik_sum == H-pass ll bitwise {same_ll} [{card}]", flush=True)
        check(max(e["num"], e["den"], e["T"]) <= TOL_TERMS
              and max(e["ll"], e["loglik"]) <= TOL_LL,
              f"{name} {mode}: dense kernel disagrees with plain {e}")
        check(repeat, f"{name} {mode}: dense kernel outputs differ between two launches")
        check(same_ll, f"{name} {mode}: loglik_sum differs from the H pass's ll")


def check_dense_equals_packed(name, Y, k, card, cs, ds):
    """On binary data the dense instances give K1/K2's outputs bitwise."""
    for mode in MODES:
        o = operands(Y, k, mode, 7, cs)
        kw_h = dict(eps=EPS, m_real=o["m"], n_real=o["n"], bm=o["bm"])
        kw_w = dict(eps=EPS, n_real=o["n"], bm=o["bm"])
        dense_h = ds.hloss_terms(o["W"], o["H"], o["Ym"], o["Yc"], **kw_h)
        packed_h = cs.hloss_terms_packed(o["W"], o["H"], o["words"], o["words2_h"], **kw_h)
        dense_T = ds.w_terms(o["W"], o["H"], o["Ym"], o["Ym2"], **kw_w)
        packed_T = cs.w_terms_packed(o["W"], o["H"], o["words"], o["words2_w"], **kw_w)
        lls = ds.loglik_sum(o["W"], o["H"], o["Ym"], o["Yc"], **kw_h)
        torch.cuda.synchronize()
        same_h = all(map(torch.equal, dense_h, packed_h))
        same_T = torch.equal(dense_T, packed_T)
        same_ll = torch.equal(lls, packed_h[2])
        print(f"dense == packed {name} {mode} k={k}: H pass {same_h}, W pass {same_T}, "
              f"loglik_sum == K1 ll {same_ll} (bitwise) [{card}]", flush=True)
        check(same_h and same_T and same_ll, f"{name} {mode}: dense differs from packed")


def check_fit(name, est, losses, card):
    """The checks every main-path fit passes."""
    check(len(losses) == est.n_iter_ and np.isfinite(losses).all(), f"{name}: losses not finite")
    check(bool(np.all(losses[1:] <= losses[:-1] * (1 + 1e-5))), f"{name}: losses do not descend")
    check(np.abs(est.W_.sum(axis=1) - 1).max() <= 1e-5, f"{name}: rows of W_ do not sum to 1")
    check(bool(((est.components_ > 0) & (est.components_ < 1)).all()),
          f"{name}: components_ outside (0, 1)")


def refit_checks(name, NBMF, params, X, est, card):
    """A same-seed refit is bitwise identical; the first 10 losses agree
    with the plain loop's within 1e-5."""
    losses = np.asarray(est.loss_curve_)
    again = NBMF(**params).fit(X)
    same = (np.array_equal(again.W_, est.W_) and np.array_equal(again.components_,
            est.components_) and again.loss_curve_ == est.loss_curve_)
    check(same, f"{name}: a second fit with the same seed differs")
    plain = NBMF(**dict(params, max_iter=10, backend="plain")).fit(X)
    n_cmp = min(10, len(losses))
    diff = np.abs(np.asarray(plain.loss_curve_[:n_cmp]) - losses[:n_cmp]) / np.abs(losses[:n_cmp])
    print(f"{name}: same-seed refit bitwise identical {same}; first {n_cmp} losses vs the "
          f"plain loop: max rel diff {diff.max():.3e} (bound 1e-5) [{card}]", flush=True)
    check(diff.max() <= 1e-5, f"{name}: fused and plain losses disagree")


def binary_main_path(NBMF, X, card, cs, ds):
    zero_counts(cs, ds)
    params = dict(n_components=HEADLINE["k"], max_iter=FIT_SWEEPS, random_state=0,
                  dtype="float32", device=DEV)
    t0 = time.perf_counter()
    est = NBMF(**params).fit(X)
    wall = time.perf_counter() - t0
    launches = read_counts(cs, ds)
    losses = np.asarray(est.loss_curve_)
    print(f"main path (binary): NBMF.fit {X.shape[0]}x{X.shape[1]} k={HEADLINE['k']} f32: "
          f"n_iter {est.n_iter_}, converged {est.converged_}, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, {wall:.2f} s wall, launches {launches} [{card}]", flush=True)
    extras = est.solver_result_.extras
    check(extras == {"backend": "fused", "packed": True}, f"binary fit took {extras}")
    for name in ("hloss_terms_packed", "w_terms_packed"):
        check(launches[name] >= est.n_iter_ > 0,
              f"{name} launched {launches[name]} times for {est.n_iter_} sweeps")
    check_fit("binary fit", est, losses, card)
    refit_checks("main path (binary)", NBMF, params, X, est, card)
    return launches


def dense_main_path(NBMF, P, card, cs, ds):
    """``NBMF.fit`` on the [0,1]-valued mean matrix.  tol=0: the sweep
    budget runs out, so the post-loop loglik_sum fill runs."""
    zero_counts(cs, ds)
    params = dict(n_components=HEADLINE["k"], max_iter=FIT_SWEEPS, tol=0.0, random_state=0,
                  dtype="float32", device=DEV)
    t0 = time.perf_counter()
    est = NBMF(**params).fit(P)
    wall = time.perf_counter() - t0
    launches = read_counts(cs, ds)
    losses = np.asarray(est.loss_curve_)
    print(f"main path (dense): NBMF.fit {P.shape[0]}x{P.shape[1]} [0,1]-valued "
          f"k={HEADLINE['k']} f32: n_iter {est.n_iter_}, converged {est.converged_}, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, {wall:.2f} s wall, launches {launches} "
          f"[{card}]", flush=True)
    extras = est.solver_result_.extras
    check(extras == {"backend": "fused", "packed": False}, f"dense fit took {extras}")
    check(est.n_iter_ == FIT_SWEEPS, "the dense fit stopped early")
    for name in ("hloss_terms", "w_terms"):
        check(launches[name] >= est.n_iter_, f"{name} launched {launches[name]} times")
    check(launches["loglik_sum"] == 1, f"loglik_sum launched {launches['loglik_sum']} times")
    check(launches["hloss_terms_packed"] == launches["w_terms_packed"] == 0,
          "the dense fit launched packed kernels")
    check_fit("dense fit", est, losses, card)
    refit_checks("main path (dense)", NBMF, params, P, est, card)
    return est, launches


def packed_vs_dense_solve(solve, X, lastfm, card):
    """``solve(packed=False)`` equals ``packed=None`` bitwise on binary data."""
    rng = np.random.default_rng(9)
    mask = (rng.random(lastfm.shape) < 0.8).astype(np.float32)
    runs = [("headline", X, dict(n_components=HEADLINE["k"], max_iter=20, tol=0.0))]
    for mode in ("parity", "corrected"):
        runs.append((f"lastfm {mode}", lastfm,
                     dict(n_components=8, max_iter=60, mask=mask, mask_mode=mode)))
    for name, Y, kw in runs:
        kw = dict(kw, random_state=0, dtype="float32", device=DEV)
        dense, auto = solve(Y, packed=False, **kw), solve(Y, **kw)
        same = (dense.n_iter == auto.n_iter and dense.losses == auto.losses
                and np.array_equal(dense.W, auto.W) and np.array_equal(dense.H, auto.H))
        print(f"solve packed=False vs packed=None ({name}, {dense.n_iter} sweeps): "
              f"extras {dense.extras} / {auto.extras}; bitwise equal {same} [{card}]", flush=True)
        check(dense.extras["packed"] is False and auto.extras["packed"] is True,
              f"{name}: packed routing")
        check(same, f"{name}: packed and dense solves differ")


def serving_requests(H, seed):
    """Binary requests drawn from the model (rows of W from a flat Dirichlet
    over the K components), made on the card from a seed, as host arrays."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    Ht = torch.as_tensor(H, device=DEV, dtype=torch.float32)
    out = []
    for rows in SERVE_ROWS:
        W = -torch.log(torch.rand((rows, Ht.shape[0]), generator=gen, device=DEV))
        W = W / W.sum(dim=1, keepdim=True)
        out.append((torch.rand((rows, Ht.shape[1]), generator=gen, device=DEV) < W @ Ht)
                   .float().cpu().numpy())
    top = SERVE_BUCKETS[-1]
    u = torch.rand((top, Ht.shape[1]), generator=gen, device=DEV)
    weighted_mask = torch.where(u < 0.2, 0.5, 1.0).cpu().numpy()
    X_w = (torch.rand((top, Ht.shape[1]), generator=gen, device=DEV) < 0.3).float().cpu().numpy()
    return out, (X_w, weighted_mask)


def serving_path(FoldInServer, model, card, cs, ds):
    """Path (b): binary requests through K2, a weighted-mask request through
    the dense W pass; W against the plain fold-in's."""
    requests, (X_w, mask_w) = serving_requests(model.components_, 11)
    server = FoldInServer(model, buckets=SERVE_BUCKETS, device=DEV)
    zero_counts(cs, ds)
    t0 = time.perf_counter()
    served = [server.transform(X) for X in requests]
    served_w = server.transform(X_w, mask=mask_w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(cs, ds)
    top = SERVE_BUCKETS[-1]
    n_binary_chunks = sum(-(-rows // top) for rows in SERVE_ROWS)
    print(f"main path (serving): FoldInServer k={server.k} n_features={server.n_features}, "
          f"binary requests {SERVE_ROWS} ({n_binary_chunks} chunks) and one {top}-row "
          f"weighted-mask request: {wall:.2f} s wall, launches {launches} [{card}]", flush=True)
    check(launches["w_terms_packed"] == server.n_iter * n_binary_chunks,
          f"binary chunks launched K2 {launches['w_terms_packed']} times")
    check(launches["w_terms"] == server.n_iter,
          f"the weighted-mask chunk launched the dense W pass {launches['w_terms']} times")
    plain = FoldInServer(model, buckets=SERVE_BUCKETS, device=DEV, backend="plain")
    worst = 0.0
    for (W, s), X in zip(served + [served_w], requests + [X_w]):
        mask = mask_w if X is X_w else None
        W_plain, _ = plain.transform(X, mask=mask)
        check(W.shape == (X.shape[0], server.k) and np.isfinite(W).all()
              and np.isfinite(s).all(), "serving output not finite or of the wrong shape")
        check(np.abs(W.sum(axis=1) - 1).max() <= 1e-5, "served W rows do not sum to 1")
        worst = max(worst, float(np.abs(W - W_plain).max()))
    print(f"serving: W against the plain fold-in: max abs diff {worst:.3e} (bound "
          f"{TOL_FOLD_IN:g}); scores finite [{card}]", flush=True)
    check(worst <= TOL_FOLD_IN, "served W disagrees with the plain fold-in")
    return server, plain, requests, (X_w, mask_w), launches


def time_kernels(X, P, k, card, cs, ds):
    """ms/call of each kernel and its plain version at the headline size:
    K1/K2 on the binary matrix's words, the dense kernels on P (unmasked)."""
    o = operands(X, k, "unmasked", 2, cs)
    d = operands(P, k, "unmasked", 2, cs, weighted=True)
    kw1 = dict(eps=EPS, m_real=o["m"], n_real=o["n"])
    kw2 = dict(eps=EPS, n_real=o["n"])
    W, H, words, Ym, bm = o["W"], o["H"], o["words"], d["Ym"], o["bm"]
    times = {
        "hloss_terms_packed": (
            cuda_ms(lambda: cs.hloss_terms_packed(W, H, words, bm=bm, **kw1)),
            cuda_ms(lambda: cs.hloss_terms_packed_plain(W, H, words, bm=bm, **kw1))),
        "w_terms_packed": (
            cuda_ms(lambda: cs.w_terms_packed(W, H, words, bm=bm, **kw2)),
            cuda_ms(lambda: cs.w_terms_packed_plain(W, H, words, bm=bm, **kw2))),
        "hloss_terms": (
            cuda_ms(lambda: ds.hloss_terms(W, H, Ym, bm=bm, **kw1)),
            cuda_ms(lambda: ds.hloss_terms_plain(W, H, Ym, **kw1))),
        "w_terms": (
            cuda_ms(lambda: ds.w_terms(W, H, Ym, bm=bm, **kw2)),
            cuda_ms(lambda: ds.w_terms_plain(W, H, Ym, **kw2))),
        "loglik_sum": (
            cuda_ms(lambda: ds.loglik_sum(W, H, Ym, bm=bm, **kw1)),
            cuda_ms(lambda: ds.loglik_sum_plain(W, H, Ym, **kw1))),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"timing {name} at {o['m']}x{o['n']} k={k}: kernel {ms:.4f} ms/call, "
              f"plain {plain_ms:.4f} ms/call [{card}]", flush=True)
    return times


def loop_ms_per_sweep(name, Y, k, packed, card, cs):
    """ms/sweep of ``_solve_core_fused`` on operands already staged on the
    card: CUDA events around runs of 5 and 25 sweeps (tol=0), slope."""
    from nbmf_mm_tpu_torch.solver.driver import _solve_core_fused

    m, n = Y.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    Ym = padded(torch.as_tensor(Y, device=DEV), Mp, Np)
    Y1 = cs.pack_bits(Ym, bm) if packed else Ym
    W0, H0 = factors(m, n, k, Mp, Np, 3)
    kw = dict(packed=packed, alpha=1.2, beta=1.2, tol=0.0, eps=EPS, n_obs=float(m * n),
              m_real=m, n_real=n, bm=bm, projection="normalize", verbose=0)
    run = lambda sweeps: _solve_core_fused(Y1, None, None, W0, H0, max_iter=sweeps, **kw)
    run(2)
    ms = {}
    for sweeps in (5, 25):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(sweeps)
        end.record()
        torch.cuda.synchronize()
        check(out[3] == sweeps, f"{name} timing run stopped early")
        ms[sweeps] = start.elapsed_time(end)
    per_sweep = (ms[25] - ms[5]) / 20
    print(f"timing fused loop ({name}, packed={packed}) at {m}x{n} k={k}: {per_sweep:.3f} "
          f"ms/sweep ({1e3 / per_sweep:.2f} sweeps/s); 25 sweeps {ms[25]:.1f} ms [{card}]",
          flush=True)
    return per_sweep


def serving_ms(server, plain, requests, weighted, card):
    """Host wall time per top-bucket request (ends in a host copy): the
    kernel route against the plain fold-in, binary and weighted-mask."""
    top = SERVE_BUCKETS[-1]
    X_bin = next(X for X in requests if X.shape[0] == top)
    X_w, mask_w = weighted
    out = {}
    for label, srv in (("kernels", server), ("plain", plain)):
        for kind, X, mask in (("binary", X_bin, None), ("weighted-mask", X_w, mask_w)):
            srv.transform(X, mask=mask)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                srv.transform(X, mask=mask)
            out[(label, kind)] = (time.perf_counter() - t0) / 3 * 1e3
    for kind in ("binary", "weighted-mask"):
        print(f"timing serving {kind} {top}-row request x {server.n_features} features, "
              f"k={server.k}, {server.n_iter} iterations: kernels {out[('kernels', kind)]:.1f} "
              f"ms/request, plain {out[('plain', kind)]:.1f} ms/request [{card}]", flush=True)
    return out


def probe_cases(m, n, k, cs, ds, pr):
    """Every probe variant and h_terms on the tools' draw at (m, n, k), as
    (kernel, label, kernel call, plain call, FLOPs by the tool's
    CostEstimate or None, bytes of the one operand read or None, the scale
    of a scalar output or None for |plain|), and the data."""
    from nbmf_mm_tpu_torch.tools.bench_stream import configs
    from nbmf_mm_tpu_torch.tools.bench_true import random_problem
    from nbmf_mm_tpu_torch.tools.bench_vpu import RUNS

    rng = np.random.default_rng(0)
    Y, W, H = random_problem(rng, m, n, k, DEV)
    d = dict(Y=Y, W=W, H=H, Yc=torch.tensor(rng.random((m, n)), dtype=torch.float32,
                                             device=DEV))
    Yp, Ypg, Yb = cs.pack_bits(Y, 256), cs.pack_bits(Y, m), Y.to(torch.bfloat16)
    small = m < 1024
    block, block_n = (128, 128) if small else (512, 256)  # make_kernel's; hloss_ngrid's
    mnk = m * n * k
    cases = []
    add = lambda name, label, fn, plain, flops=None, nbytes=None, scale=None: cases.append(
        (name, label, fn, plain, flops, nbytes, scale))
    for Yc, label in ((None, "Yc=None"), (d["Yc"], "Yc explicit")):
        add("h_terms", label, partial(ds.h_terms, W, H, Y, Yc, bm=256),
            partial(ds.h_terms_plain, W, H, Y, Yc, eps=EPS), 6 * mnk)
    for kind, prec in (("hbm_only", None), ("vpu_only", None), ("mxu_only", "DEFAULT"),
                       ("mxu_only", "HIGHEST")):
        fn = pr.make_kernel(kind, k, m, n, block, block, prec)
        plain = pr.make_kernel_plain(kind, k, m, n, block, block, prec)
        add("make_kernel", f"{kind} {prec or ''}".strip(), partial(fn, W, H, Y),
            partial(plain, W, H, Y), nbytes=4 * m * n if prec is None else None)
    for mxu, label in ((None, "f32"), (torch.bfloat16, "bf16")):
        for name, flops, extra in (("hloss_packed", 8, {}), ("w_packed", 4, {"n_real": n}),
                                   ("hloss_packed2", 8, {}), ("w_packed2", 4, {"n_real": n})):
            add(name, label, partial(getattr(pr, name), W, H, Yp, mxu_dtype=mxu, **extra),
                partial(getattr(pr, name + "_plain"), W, H, Yp, mxu_dtype=mxu, **extra),
                flops * mnk)
        for n_mm in (3, 2):
            add("mxu_only", f"n_mm={n_mm} {label}", partial(pr.mxu_only, W, H, n_mm=n_mm,
                                                           mxu_dtype=mxu),
                partial(pr.mxu_only_plain, W, H, n_mm=n_mm, mxu_dtype=mxu), 2 * n_mm * mnk)
        for variant in ("chain3_acc", "chain3_tile"):
            add("mxu_probe", f"{variant} {label}",
                partial(pr.mxu_probe, W, H, variant=variant, mxu_dtype=mxu),
                partial(pr.mxu_probe_plain, W, H, variant=variant, mxu_dtype=mxu), 6 * mnk)
        for packed, data in ((False, Y), (True, Ypg)):
            kw = dict(block_n=block_n, packed=packed, mxu_dtype=mxu)
            add("hloss_ngrid", f"{'packed' if packed else 'dense'} {label}",
                partial(pr.hloss_ngrid, W, H, data, **kw),
                partial(pr.hloss_ngrid_plain, W, H, data, **kw), 8 * mnk)
    stream = ([(256, n, "f32"), (128, 128, "f32"), (256, n, "bf16")] if small
              else configs(n))
    for bm, bn, dt in stream:
        X = Y if dt == "f32" else Yb
        add("stream_kernel", f"tile ({bm},{bn}) {dt}",
            partial(pr.stream_kernel(m, n, bm, bn, dt), X), partial(pr.stream_kernel_plain, X),
            nbytes=X.numel() * X.element_size())
    for frag, packed, label in RUNS:
        X = Yp if packed else Y
        # Words add as signed int32 values: hold the sum to sum |x|.
        scale = X.double().abs().sum() if frag == "stream_sum" and packed else None
        add("frag_kernel", label, partial(pr.frag_kernel, X, frag=frag, packed=packed),
            partial(pr.frag_kernel_plain, X, frag=frag, packed=packed),
            nbytes=X.numel() * X.element_size(), scale=scale)
    return cases, d


def check_probes(m, n, k, card, cs, ds, pr, errors, *, timed):
    """Each probe variant and h_terms against its plain version at
    (m, n, k), launched twice for bitwise repeatability, then the bitwise
    equalities the port promises; with ``timed``, ms/call of kernel and plain.
    Returns {kernel: (ms, plain_ms)} of each kernel's first variant."""
    cases, d = probe_cases(m, n, k, cs, ds, pr)
    outs = {}
    for name, label, fn, plain, _, _, scale in cases:
        got, again = as_tuple(fn()), as_tuple(fn())
        torch.cuda.synchronize()
        want = as_tuple(plain())
        worst_terms = worst_sum = 0.0
        for g, w in zip(got, want):
            if w.numel() == 1:
                worst_sum = max(worst_sum, abs(float(g) - float(w))
                                / (float(scale) if scale is not None else abs(float(w))))
            else:
                worst_terms = max(worst_terms, rel(g, w))
            errors[name] = max(errors[name], abs_err(g, w))
        repeat = all(map(torch.equal, got, again))
        print(f"probe {name} {label} at {m}x{n} k={k}: rel err terms {worst_terms:.3e} (bound "
              f"{TOL_TERMS:g} of max|plain|), sums {worst_sum:.3e} (bound {TOL_LL:g} of "
              f"sum|x|); bitwise repeat {repeat} [{card}]", flush=True)
        check(worst_terms <= TOL_TERMS and worst_sum <= TOL_LL,
              f"probe {name} {label}: kernel disagrees with plain")
        check(repeat, f"probe {name} {label}: outputs differ between two launches")
        outs[(name, label)] = got

    W, H, Y = d["W"], d["H"], d["Y"]
    equal = lambda a, b, count=None: all(map(torch.equal, a[:count], b[:count]))
    same = {"h_terms == hloss_terms Num/Den": all(
        equal(outs[("h_terms", label)],
              ds.hloss_terms(W, H, Y, Yc, eps=EPS, m_real=m, n_real=n, bm=256), 2)
        for Yc, label in ((None, "Yc=None"), (d["Yc"], "Yc explicit")))}
    for label in ("f32", "bf16"):
        same[f"hloss_ngrid packed == dense {label}"] = equal(
            outs[("hloss_ngrid", f"packed {label}")], outs[("hloss_ngrid", f"dense {label}")])
        same[f"hloss_packed == hloss_packed2 Num/Den {label}"] = equal(
            outs[("hloss_packed", label)], outs[("hloss_packed2", label)], 2)
    print(f"probes bitwise at {m}x{n} k={k}: {same} [{card}]", flush=True)
    check(all(same.values()), f"a bitwise equality of the probes failed: {same}")

    times = {}
    for name, label, fn, plain, flops, nbytes, _ in (cases if timed else ()):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
        times.setdefault(name, (ms, plain_ms))
        rate = f", {flops / ms / 1e9:.2f} TFLOP/s by the tool's count" if flops else ""
        rate += f", {nbytes / ms / 1e6:.1f} GB/s" if nbytes else ""
        print(f"timing probe {name} {label} at {m}x{n} k={k}: kernel {ms:.4f} ms/call, plain "
              f"{plain_ms:.4f} ms/call{rate} [{card}]", flush=True)
    return times


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def measurement_path(card, cs, ds, pr) -> dict:
    """The measurement path: each script of nbmf_mm_tpu_torch/tools/ through
    its entry point at its headline size, one slope per timing (--reps 1),
    with the launch counters set to 0 before and read after."""
    zero_counts(cs, ds, pr)
    t0 = time.perf_counter()
    for name in TOOLS:
        print(f"measurement path: python -m nbmf_mm_tpu_torch.tools.{name} --reps 1 [{card}]",
              flush=True)
        importlib.import_module(f"nbmf_mm_tpu_torch.tools.{name}").main(["--reps", "1"])
    torch.cuda.synchronize()
    launches = read_counts(cs, ds, pr)
    print(f"measurement path: {time.perf_counter() - t0:.1f} s, launches {launches} [{card}]",
          flush=True)
    for name in (*MEASUREMENT_KERNELS, "hloss_terms", "w_terms"):
        check(launches[name] > 0, f"{name} was never launched on the measurement path")
    return {name: launches[name] for name in MEASUREMENT_KERNELS}


def main() -> None:
    # ---------------------------------------------------------- 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run(["bash", "-c", "nvcc --version || /usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc.splitlines()[-1] if nvcc else 'not found'}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    from nbmf_mm_tpu_torch import NBMF, FoldInServer, solve
    from nbmf_mm_tpu_torch.ops import _build
    from nbmf_mm_tpu_torch.ops import cuda_sweep as cs
    from nbmf_mm_tpu_torch.ops import dense_sweep as ds
    from nbmf_mm_tpu_torch.ops import probes as pr

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s set-up (nvcc, sm_90a)", flush=True)
    for line in _build.build_log().splitlines():
        if ("registers" in line or "nvcc" in line
                or "spill" in line and "0 bytes spill stores" not in line):
            print("  ptxas:" if "registers" in line or "spill" in line else " ", line.strip())

    # ------------------------------------------- 3. kernels against plain
    X = headline_matrix()
    P = mean_matrix()
    lastfm = lastfm_matrix()
    lastfm_soft = np.random.default_rng(6).random(lastfm.shape).astype(np.float32)
    tiny = (np.random.default_rng(4).random((32, 40)) < 0.3).astype(np.float32)
    errors = {name: 0.0 for name in KERNELS}
    check_packed_kernels("headline", X, HEADLINE["k"], card, cs, errors)
    check_packed_kernels("lastfm", lastfm, 8, card, cs, errors)
    # One word row: the H pass writes Num/Den directly, without the split over m.
    check_packed_kernels("one-word-row", tiny, 4, card, cs, errors)
    check_dense_kernels("headline P", P, HEADLINE["k"], card, cs, ds, errors)
    check_dense_kernels("lastfm-shaped continuous", lastfm_soft, 8, card, cs, ds, errors)
    check_dense_kernels("one-word-row", tiny * 0.5 + 0.25, 4, card, cs, ds, errors)
    check_dense_equals_packed("headline", X, HEADLINE["k"], card, cs, ds)
    check_dense_equals_packed("lastfm", lastfm, 8, card, cs, ds)

    # ------------------------------------------------------ 4. main paths
    # Launches per kernel, summed over the three main-path runs.
    binary_counts = binary_main_path(NBMF, X, card, cs, ds)
    model, dense_counts = dense_main_path(NBMF, P, card, cs, ds)
    packed_vs_dense_solve(solve, X, lastfm, card)
    server, plain_server, requests, weighted, serving_counts = serving_path(
        FoldInServer, model, card, cs, ds)
    launches = {name: binary_counts[name] + dense_counts[name] + serving_counts[name]
                for name in PATH_KERNELS}
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the main paths")

    # ------------------------------------------ 5. masked fit and fold-in
    rng = np.random.default_rng(3)
    rows = rng.permutation(lastfm.shape[0])
    test_rows, train_rows = rows[:120], rows[120:]
    train, test = lastfm[train_rows], lastfm[test_rows]
    mask = (rng.random(train.shape) >= 0.2).astype(np.float32)  # 20% held out
    for orientation in ("beta-dir", "dir-beta"):
        m_est = NBMF(n_components=8, max_iter=200, random_state=1, dtype="float32",
                     device=DEV, orientation=orientation).fit(train, mask=mask)
        W_new = m_est.transform(test)
        ppl = m_est.perplexity(test)
        ok = (np.isfinite(m_est.loss_curve_).all() and np.isfinite(W_new).all()
              and np.isfinite(ppl))
        print(f"lastfm {orientation} parity-masked fit {train.shape}: n_iter {m_est.n_iter_}, "
              f"loss {m_est.loss_:.6f}, extras {m_est.solver_result_.extras}; "
              f"transform {W_new.shape}, held-out perplexity {ppl:.6f}; finite {ok}", flush=True)
        check(ok, f"lastfm {orientation}: non-finite results")

    # ---------------------------------------------------------- 6. timing
    times = time_kernels(X, P, HEADLINE["k"], card, cs, ds)
    loop_ms_per_sweep("binary", X, HEADLINE["k"], True, card, cs)
    loop_ms_per_sweep("dense", P, HEADLINE["k"], False, card, cs)
    serving_ms(server, plain_server, requests, weighted, card)

    # ---------------------------------------------- 7. measurement path
    t7 = time.perf_counter()
    for m, n, k in PROBE_SIZES:
        times.update(check_probes(m, n, k, card, cs, ds, pr, errors,
                                  timed=(m, n, k) == PROBE_SIZES[-1]))
    launches.update(measurement_path(card, cs, ds, pr))
    print(f"measurement path: {time.perf_counter() - t7:.1f} s [{card}]", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s [{card}]", flush=True)

    kernels = [
        {"name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
