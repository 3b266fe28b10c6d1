"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the two bit-packed sweep kernels from ``nbmf_mm_tpu_torch/ops/csrc``,
checks each against its plain PyTorch version on the card, drives the main
path (``NBMF.fit`` on a 10^4 x 10^4 binary matrix at K=128, float32) and
shows through the launch counters that it ran the kernels, runs a masked fit,
a dir-beta fit and a fold-in on the lastfm matrix, and times the kernels and
both solver loops.  Each phase prints one line or more; any failure raises
and the script exits non-zero.  The last line is a JSON object with
``"ok": true`` and the device; the line before it lists the kernels.

Imports torch, numpy and nbmf_mm_tpu_torch only.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

HEADLINE = dict(m=10_000, n=10_000, k=128, density=0.3, seed=0)
LASTFM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "lastfm.npz")
EPS = 1e-8
# Kernel against plain: Num/Den/T within 1e-5 of max |plain| (fp32 sums in
# another order), ll within 1e-6 relative (both add fp32 logs in fp64).
TOL_TERMS = 1e-5
TOL_LL = 1e-6
# The JAX reference package is named as the port without its "_torch".
REFERENCE_KERNELS = "nbmf_mm_tpu_torch".removesuffix("_torch") + "/ops/pallas_sweep.py"
REPLACES = {
    "hloss_terms_packed": f"{REFERENCE_KERNELS}:843",
    "w_terms_packed": f"{REFERENCE_KERNELS}:947",
}
SOURCE = "nbmf_mm_tpu_torch/ops/csrc/sweep_packed.cu"


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


def headline_matrix() -> np.ndarray:
    h = HEADLINE
    rng = np.random.default_rng(h["seed"])
    return (rng.random((h["m"], h["n"])) < h["density"]).astype(np.float32)


def lastfm_matrix() -> np.ndarray:
    with np.load(LASTFM) as d:
        return d["Y"].astype(np.float32)


def kernel_operands(Y, k, mode, seed, cs):
    """Packed words and random (W, H) on the card at the solver's geometry."""
    m, n = Y.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    Yt = torch.tensor(Y, device=dev)
    pad = lambda A: torch.nn.functional.pad(A, (0, Np - n, 0, Mp - m))
    if mode == "unmasked":
        words, words2 = cs.pack_bits(pad(Yt), bm), None
    else:
        mask = torch.tensor(rng.random((m, n)) < 0.8, device=dev, dtype=Yt.dtype)
        words = cs.pack_bits(pad(Yt * mask), bm)
        words2 = cs.pack_bits(pad((1 - Yt) * mask), bm)
    W = np.zeros((k, Mp), np.float32)
    W[:, :m] = rng.uniform(0.1, 0.9, (k, m))
    W[:, :m] /= W[:, :m].sum(axis=0, keepdims=True)
    H = np.zeros((k, Np), np.float32)
    H[:, :n] = rng.uniform(0.1, 0.9, (k, n))
    return dict(W=torch.tensor(W, device=dev), H=torch.tensor(H, device=dev), words=words,
                words2_h=words2 if mode == "corrected" else None, words2_w=words2,
                m=m, n=n, bm=bm)


def check_kernels(name, Y, k, card, cs, errors):
    """K1 and K2 against their plain versions in all three mask modes, and
    launched twice for bitwise repeatability."""
    for mode in ("unmasked", "parity", "corrected"):
        o = kernel_operands(Y, k, mode, 1, cs)
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
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
        e = dict(num=rel(num, pnum), den=rel(den, pden), T=rel(T, pT),
                 ll=abs(float(ll) - float(pll)) / abs(float(pll)))
        errors["hloss_terms_packed"] = max(
            errors["hloss_terms_packed"], float((num - pnum).abs().max()),
            float((den - pden).abs().max()), abs(float(ll) - float(pll)))
        errors["w_terms_packed"] = max(errors["w_terms_packed"], float((T - pT).abs().max()))
        repeat = (torch.equal(num, num2) and torch.equal(den, den2) and torch.equal(ll, ll2)
                  and torch.equal(T, T2))
        print(f"kernels {name} {mode} k={k}: rel err num {e['num']:.3e} den {e['den']:.3e} "
              f"T {e['T']:.3e} (bound {TOL_TERMS:g} of max|plain|), ll {e['ll']:.3e} "
              f"(bound {TOL_LL:g}); bitwise repeat {repeat} [{card}]", flush=True)
        check(max(e["num"], e["den"], e["T"]) <= TOL_TERMS and e["ll"] <= TOL_LL,
              f"{name} {mode}: kernel disagrees with plain {e}")
        check(repeat, f"{name} {mode}: kernel outputs differ between two launches")


def time_kernels(Y, k, card, cs):
    o = kernel_operands(Y, k, "unmasked", 2, cs)
    kw1 = dict(eps=EPS, m_real=o["m"], n_real=o["n"], bm=o["bm"])
    kw2 = dict(eps=EPS, n_real=o["n"], bm=o["bm"])
    times = {
        "hloss_terms_packed": (
            cuda_ms(lambda: cs.hloss_terms_packed(o["W"], o["H"], o["words"], **kw1)),
            cuda_ms(lambda: cs.hloss_terms_packed_plain(o["W"], o["H"], o["words"], **kw1)),
        ),
        "w_terms_packed": (
            cuda_ms(lambda: cs.w_terms_packed(o["W"], o["H"], o["words"], **kw2)),
            cuda_ms(lambda: cs.w_terms_packed_plain(o["W"], o["H"], o["words"], **kw2)),
        ),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"timing {name} at {o['m']}x{o['n']} k={k}: kernel {ms:.4f} ms/call, "
              f"plain {plain_ms:.4f} ms/call [{card}]", flush=True)
    return times


def ms_per_sweep(solve, Y, k, backend, card) -> float:
    """Slope timing of the whole solve: (t(30 sweeps) - t(10 sweeps)) / 20,
    host clock around solves that end in a host copy; tol=0 never stops."""
    kw = dict(n_components=k, tol=0.0, random_state=0, dtype="float32", device="cuda",
              backend=backend)
    solve(Y, max_iter=2, **kw)  # warm-up
    walls = {}
    for sweeps in (10, 30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(Y, max_iter=sweeps, **kw)
        torch.cuda.synchronize()
        walls[sweeps] = time.perf_counter() - t0
        check(res.n_iter == sweeps, f"{backend} timing run stopped early")
    ms = (walls[30] - walls[10]) / 20 * 1e3
    print(f"timing solve loop backend={backend} at {Y.shape[0]}x{Y.shape[1]} k={k}: "
          f"{ms:.3f} ms/sweep ({1e3 / ms:.2f} sweeps/s) [{card}]", flush=True)
    return ms


def main() -> None:
    # ---------------------------------------------------------- 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
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

    from nbmf_mm_tpu_torch import NBMF, solve
    from nbmf_mm_tpu_torch.ops import _build
    from nbmf_mm_tpu_torch.ops import cuda_sweep as cs

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s set-up (nvcc, sm_90a)", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line and "0 bytes spill stores" not in line:
            print("  ptxas:", line.strip())

    # ------------------------------------------- 3. kernels against plain
    X = headline_matrix()
    lastfm = lastfm_matrix()
    errors = {name: 0.0 for name in cs.LAUNCHES}
    check_kernels("headline", X, HEADLINE["k"], card, cs, errors)
    check_kernels("lastfm", lastfm, 8, card, cs, errors)
    # One word row: K1 writes Num/Den directly, without the split over m.
    tiny = (np.random.default_rng(4).random((32, 40)) < 0.3).astype(np.float32)
    check_kernels("one-word-row", tiny, 4, card, cs, errors)

    # ------------------------------------------------------ 4. main path
    for name in cs.LAUNCHES:
        cs.LAUNCHES[name] = 0
    params = dict(n_components=HEADLINE["k"], max_iter=100, random_state=0, dtype="float32",
                  device="cuda")
    t0 = time.perf_counter()
    est = NBMF(**params).fit(X)
    wall = time.perf_counter() - t0
    launches = dict(cs.LAUNCHES)
    losses = np.asarray(est.loss_curve_)
    print(f"main path: NBMF.fit {X.shape[0]}x{X.shape[1]} k={HEADLINE['k']} f32: "
          f"n_iter {est.n_iter_}, converged {est.converged_}, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, {wall:.2f} s wall, launches {launches} [{card}]", flush=True)
    check(est.solver_result_.extras["backend"] == "fused", "fit did not take the fused loop")
    for name, count in launches.items():
        check(count >= est.n_iter_ > 0, f"{name} launched {count} times for {est.n_iter_} sweeps")
    check(len(losses) == est.n_iter_ and np.isfinite(losses).all(), "losses not finite")
    check(bool(np.all(losses[1:] <= losses[:-1] * (1 + 1e-5))), "losses do not descend")
    check(np.abs(est.W_.sum(axis=1) - 1).max() <= 1e-5, "rows of W_ do not sum to 1")
    check(bool(((est.components_ > 0) & (est.components_ < 1)).all()),
          "components_ outside (0, 1)")
    again = NBMF(**params).fit(X)
    same = (np.array_equal(again.W_, est.W_) and np.array_equal(again.components_,
            est.components_) and again.loss_curve_ == est.loss_curve_)
    check(same, "a second fit with the same seed differs")
    plain = NBMF(**dict(params, max_iter=10, backend="plain")).fit(X)
    n_cmp = min(10, len(losses))
    rel = np.abs(np.asarray(plain.loss_curve_[:n_cmp]) - losses[:n_cmp]) / np.abs(losses[:n_cmp])
    print(f"main path: same-seed refit bitwise identical {same}; first {n_cmp} losses vs the "
          f"plain loop: max rel diff {rel.max():.3e} (bound 1e-5)", flush=True)
    check(rel.max() <= 1e-5, "fused and plain losses disagree")

    # ------------------------------------------ 5. masked fit and fold-in
    rng = np.random.default_rng(3)
    rows = rng.permutation(lastfm.shape[0])
    test_rows, train_rows = rows[:120], rows[120:]
    train, test = lastfm[train_rows], lastfm[test_rows]
    mask = (rng.random(train.shape) >= 0.2).astype(np.float32)  # 20% held out
    for orientation in ("beta-dir", "dir-beta"):
        m_est = NBMF(n_components=8, max_iter=200, random_state=1, dtype="float32",
                     device="cuda", orientation=orientation).fit(train, mask=mask)
        W_new = m_est.transform(test)
        ppl = m_est.perplexity(test)
        ok = (np.isfinite(m_est.loss_curve_).all() and np.isfinite(W_new).all()
              and np.isfinite(ppl))
        print(f"lastfm {orientation} parity-masked fit {train.shape}: n_iter {m_est.n_iter_}, "
              f"loss {m_est.loss_:.6f}, backend {m_est.solver_result_.extras['backend']}; "
              f"transform {W_new.shape}, held-out perplexity {ppl:.6f}; finite {ok}", flush=True)
        check(ok, f"lastfm {orientation}: non-finite results")

    # ---------------------------------------------------------- 6. timing
    times = time_kernels(X, HEADLINE["k"], card, cs)
    ms_per_sweep(solve, X, HEADLINE["k"], "fused", card)
    ms_per_sweep(solve, X, HEADLINE["k"], "plain", card)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in cs.LAUNCHES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
