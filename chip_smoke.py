"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the sweep kernels from ``nbmf_mm_tpu_torch/ops/csrc`` (one ``nvcc`` per
source, started together) and checks each against its plain PyTorch version
on the card: the bit-packed pair K1/K2 and the three dense kernels, which on
binary data must equal K1/K2 bitwise, the two W passes again at the
shapes that hit their column split's edges, and the four H passes (K1, the
dense H pass, ``loglik_sum`` and ``h_terms``) at the shapes that hit their
row split's edges and at ranks on both sides of the warp-specialised
``TK = 16`` body's dead k rows, with 16 lanes against one-lane launches.
Then it drives the port's three main
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
two fused loops and the serving requests; each kernel's time is printed
beside its bound (``FP32_PEAK``, ``HBM_RATE``); the H passes' share is
printed against the 6 m n k flops they do and the reference's 8 m n k.

Phase 7 is the measurement path (``nbmf_mm_tpu_torch/tools/``): ``h_terms``
and every variant of the ten probe kernels against their plain versions at
the tools' correctness shape (512 x 640, K=16) and their headline size
(10240^2, K=128), the bitwise equalities (``h_terms`` and ``hloss_terms``;
``hloss_ngrid`` packed and dense; ``hloss_packed`` and ``hloss_packed2``),
a timing line per probe, then every script of the package through its entry
point with the launch counters zeroed before and read after.

Phase 8 is packed and sparse input at the headline size, each run with the
launch counters zeroed before and read after: ``NBMF.fit`` on the headline
matrix as a ``scipy.sparse`` CSR and as a ``PackedMatrix`` (bitwise equal to
the binary main path, K1 and K2 only); the four packers against
``pack_bits`` of the padded matrix; ``solve(PackedMatrix)`` and
``device_results=True`` against the dense-input solve; lastfm as a CSR under
a CSR mask in both mask modes; the contract errors; the scale run (a
10^5 x 10^4 CSR at 3%, packed from its structure and solved for 10 sweeps
with the peak device memory held under half of the dense matrix's); and the
set-up breakdown of a fit from numpy input with the three host stagings.

Phase 9 is restarts and grids, the fourth main path: the five production
kernels with a leading lane axis ``R`` on the factors, lane by lane bitwise
against the unbatched kernels and one lane per shape against the plain
version (the headline with ``R = 4`` and, for the warp-specialised H pass,
at k = 256 with ``R = 16``, lastfm, 1000 x 1234 at k = 17 and 200 and one
word row with ``R`` in 1 and 3, all three mask modes); then, each with
the launch and lane counters zeroed before and read after, ``NBMF.fit`` with
``n_init=16`` on the headline binary matrix (its best lane again as a
standalone ``solve`` from that lane's inits), ``solve(n_init=4,
return_all=True)`` under dir-beta on masked lastfm, a dense restart fit on
the mean matrix, ``grid_solve`` over the 6 x 6 (alpha, beta) grid of the
paper reproduction on masked lastfm (36 cells in one solve, two held against
standalone solves) and a 4-cell zip grid at the headline; and the times of
the batched kernels and loops at ``R = 16`` beside their bounds, with the
peak device memory of the 16-restart fit.

Phase 10 is the precision tiers and the bf16-data mode
(``nbmf_mm_tpu_torch/ops/tiers.py``): every operand form of the production
kernels (``_bf16r`` for ``precision="default"``, ``_tf32r`` for ``"high"``,
``_bf16d`` for ``dtype="bfloat16"``) against its plain version at the
headline, lastfm, one word row and the split edges ``W_EDGES``/``H_EDGES`` in
all three mask modes, with the bitwise ties (two launches, dense == packed,
``loglik_sum`` == the H pass's ll and ``h_terms`` == its Num/Den per tier,
the bf16-data H pass and ``loglik_sum`` == the DEFAULT tier's, the bf16-data
W pass == DEFAULT's where H is bf16-representable, lane == unbatched at
R = 4), and the staged bf16 and TF32 copies against their plain versions;
the build step prints each tensor-core instance's registers and spills, the
HGMMA count of its SASS (every pass, the TF32 ones apart) and each TF32
instance's blocks per SM;
then, each with the counters zeroed before and read after,
``NBMF(dtype="bfloat16").fit`` on the mean matrix (bf16-data launches only,
no ``pack_bits``, peak device memory beside a float32 fit's) and on the binary
matrix (dense, never packed), ``solve(precision="default"/"high")`` packed and
dense (bitwise equal; losses descending within 2e-3; final loss beside the
float32 solve's), ``FoldInServer(precision="default")`` and
``FoldInServer(dtype="bfloat16")`` against the plain fold-in of the same
tier, the 6 x 6 lastfm grid in bf16 and ``NBMF(n_init=4,
precision="default")``; ``bench_kernels`` in each form (where ``h_terms``
runs); and each form's ms beside its float32 instance and its bound, the
fused loops per tier and on bf16 data, and the tier's serving requests beside
float32's.

Phase 11 is checkpoint, utils and baselines, each path with the launch
counters zeroed before and read after: ``fit_checkpointed`` at the headline
in four segments of 25 sweeps (four checkpoint writes) against one
100-sweep fit, at the bars of ``tests/test_torch_checkpoint.py``, with the
wall time of both; ``save_model`` -> ``load_model(device="cuda")`` and the
8192-row request's ``transform``, ``score`` and ``perplexity``, bitwise the
original's; a ``device_results=True`` model saved from its tensors;
``resume_fit`` from a 50-sweep save against the same fit; a headline solve
under ``nan_checks()`` bitwise the one without, with the ms/sweep of both,
and a NaN prior that raises ``FloatingPointError``; the paper's 10-init
protocol of ``NBMFEM`` (K=16) and ``LogisticPCA`` (K=2) on the animals split
in float64 against the stored artifacts (3% and 2%), one seed of each
against the CPU; and the JAX package's option names on the card
(``backend="pallas"`` bitwise ``"fused"``, ``block_m`` ignored,
``pallas_interpret=True`` raising) with ``nbmf_mm_compat_torch.NBMF``.

Phase 12 is the stress driver on the card
(``nbmf_mm_tpu_torch/tools/stress_solve.py``): the geometry planners on
5000 random geometries on the host, of which the first 64 whose operands fit
in 256 MB go through every pass of their operand form against the plain
versions (phase 3's bars: float32 on random factors, the reduced forms on
dyadic factors, on which the kernels and the plain versions form the same
``WH``; the reduced forms' deviations on random factors printed; these
comparison launches are not counted), and a
rank past ``MAX_RANK`` and ``MAX_LANES + 1`` lanes through the wrappers,
which raise ``ValueError`` with nothing allocated; then 100 draws each of
``fused`` (the operand form drawn per draw), ``edge-fused`` and
``estimator-fused`` from fixed seeds, each with the counters zeroed before
and read after, with no failed draw, the fused draws' card loop against the
card's plain loop (``tol=0``, the same inits; float32 in the continuous
regime held to 1e-5 in the losses and 1e-4 in the factors, the other forms'
deviations printed) and the launches per kernel form.

Phase 13 is the experiment runners (``nbmf_mm_tpu_torch/experiments/``),
with the counters zeroed before and read after: Figures 1-3 of the paper
reproduction on animals, lastfm and paleo (the 6 x 6 grids, the fits, the
10-init NBMF-MM protocol within two standard deviations of the JAX round's
``outputs/figure2_results.csv``, the NBMF-EM and logPCA protocols within
phase 11's bars of that file's means, the rank sweeps), each dataset's
Figure 2 fit on the card against the same seed on the CPU (test NLL within
1e-3); the benchmark suite; ``flagship_scale``'s ``headline_1e9`` (converged
within its budget, descent within 5e-4 of the loss, final loss within 1% of
the oracle NLL, peak device memory under the dense matrix's bytes) and
``sparse_3pct_1e9``; and ``validate_implementation`` (exit code 0).  The
CSVs go to ``chiprun_out/experiments/``.

Each phase prints one line or more; any failure raises and the script exits
non-zero.  The last line is a JSON object with ``"ok": true`` and the
device; the line before it lists the kernels.

Imports torch, numpy, scipy.sparse, nbmf_mm_tpu_torch and
nbmf_mm_compat_torch only.  Needs one CUDA card.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import re
import subprocess
import time
from functools import partial
from pathlib import Path

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
# A kernel's bound: the larger of its operations at the fp32 CUDA-core peak and
# its bytes (each input read once, each output written once) at the HBM rate,
# from NVIDIA's H100 SXM data sheet (at the 700 W limit).  Operations are the
# flops each function does: 6 m n k for the H and W passes (three m n k
# products each; the reference estimates its H passes at 8 m n k,
# pallas_sweep.py:321, and h_terms at 6, :192), 2 m n k for loglik_sum, the
# tools/ probes' own counts for the W probes and the matmul chains, or one
# add per element for the reductions, over this run's shapes.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# The tensor-core peaks of the same data sheet (dense): the bound of a form
# whose every product operand is bf16 (precision "default", bf16 data: the
# wgmma kernels of sweep_wgmma.cuh) or TF32 (precision "high"), the rate at
# which the card could do that form's products, whatever its kernel runs on.
BF16_TC_PEAK = 989e12
TF32_TC_PEAK = 495e12
# The kernels of sweep_wgmma.cuh and sweep_wgmma_tf32.cuh (the passes and
# their bf16 and TF32 staging), by name, for printing their registers and
# spills.
WGMMA_KERNELS = r"wgmma_kernel|stage_[wh]_(bf16|tf32)_kernel"
# Phase 3's edge shapes of the W pass's column split (label, (m, n), k): the
# serving chunks, ranks across every instance and on both sides of each
# instance's choice of phase-B body (row by row at k = 33, 96, 112, 129 and
# 200; h held at 1, 17, 64, 113, 128 and 256), n neither a multiple of the
# 32-column tile nor of a chunk (n_real inside the last tile), three word
# rows (the last 64-row block half empty), one word row in a 64-row block
# (stripe bm = 32).  Each also runs W_EDGE_LANES lanes against one-lane
# launches.
W_EDGES = (("serving chunk 8192", (8_192, 10_000), 128),
           ("serving chunk 64", (64, 10_000), 128),
           *((f"ragged k={k}", (1_000, 1_234), k)
             for k in (1, 17, 33, 64, 96, 112, 113, 128, 129, 200, 256)),
           ("three word rows", (90, 1_234), 128),
           ("single stripe bm=32", (20, 1_000), 8))
W_EDGE_LANES = 16
# Phase 3's edge shapes of the H pass's row split (label, (m, n), k): ranks
# across every instance at n neither a multiple of the 64-column block nor
# of 4 (n_real inside the last block) and m_real inside the last word rows
# (chunks of one or two word rows, boundaries inside the stripes of
# bm = 256), one word row (bm = 32, m_real inside it), and bm = Mp (one
# stripe of seven word rows, as the hloss_ngrid probes walk it).  k = 129
# and 240 put the warp-specialised TK = 16 body on both sides of its dead k
# rows (15 a consumer thread at 129, one at 240).  At 1000x1234 its chunks
# hold two word rows, so the last three shapes give it chunks of 3 and 4
# (2600x1000) and of 5 and 6 word rows (1600x1500): its ring then wraps,
# the producers wait for the consumers to free a stage and reuse it.  Each
# also runs H_EDGE_LANES lanes against one-lane launches.
H_EDGES = (*((f"ragged k={k}", (1_000, 1_234), k) for k in (1, 17, 33, 129, 200, 240, 256)),
           ("one word row bm=32", (20, 1_000), 8),
           ("one stripe bm=Mp", (200, 1_000), 8),
           ("chunks of 3-4 word rows k=129", (2_600, 1_000), 129),
           ("chunks of 5-6 word rows k=240", (1_600, 1_500), 240),
           ("chunks of 3-4 word rows k=256", (2_600, 1_000), 256))
H_EDGE_LANES = 16
# The JAX reference package is named as the port without its "_torch".
SWEEP = "nbmf_mm_tpu_torch".removesuffix("_torch") + "/ops/pallas_sweep.py"
# name: (source, file:line of the TPU kernel it replaces).  The kernels of
# the three main paths; the dense H and W kernels also replace the stripe
# forms hloss_terms_stripe (:546) and w_terms_stripe (:650).  Phase 8 (packed
# and sparse input) runs the first two, K1 and K2, and no dense kernel.
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
# Kernels whose every variant the kernels line lists (make_kernel's three
# kinds are three different functions).
VARIANT_KERNELS = ("make_kernel",)
# The measurement path's scripts, driven through their entry points.
TOOLS = ("bench_kernels", "bench_true", "bench_packed", "bench_packed2", "bench_packed3",
         "bench_diag", "bench_stream", "bench_vpu")
# Probe shapes: the tools' correctness shape and their headline size.
PROBE_SIZES = ((512, 640, 16), (10_240, 10_240, 128))
CSRC = "nbmf_mm_tpu_torch/ops/csrc/"
MODES = ("unmasked", "parity", "corrected")
# Phase 8's scale run: the sparse-ingest configuration of the repository's
# experiments/flagship_scale.py (10^9 entries at 3%, K=128), 10 sweeps.
SCALE = dict(m=100_000, n=10_000, k=128, density=0.03, sweeps=10)
SCALE_INGEST_LIMIT_S = 60.0  # the host packing alone must stay under this
# The three ways from host numpy operands to words on the card; solve takes
# the first.
HOST_STAGINGS = ("f32-device", "host", "u8-device")
# Phase 9.  Lanes of the batched kernels checked at the headline, and of the
# timed calls and the restart fit (16 restarts over one packed data stream,
# the n_init16 configuration of the repository's bench.py:276-309).
LANES_CHECKED = 4
LANES_TIMED = 16
RESTART_SWEEPS = 50
# The (alpha, beta) grid of experiments/reproduce_magron2022.py:49-51
# (ALPHA_GRID x BETA_GRID) at its rank for lastfm (FIG1_K["lastfm"]).
PAPER_GRID = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
PAPER_LASTFM_K = 8
# Edge shapes of the lane axis (label, (m, n) or None for lastfm, k), each
# with R in LANE_EDGE_COUNTS.
LANE_EDGES = (("lastfm", None, 8), ("ragged k=17", (1_000, 1_234), 17),
              ("ragged k=200", (1_000, 1_234), 200), ("one-word-row", (32, 40), 4))
LANE_EDGE_COUNTS = (1, 3)
# Phase 10: the operand forms of the production kernels (ops/tiers.py): the
# precision tiers "default" (bf16r) and "high" (tf32r) and the bf16-data mode
# (bf16d), each kernel's counter and entry point named with the form's suffix.
TIER_FORMS = ("bf16r", "tf32r", "bf16d")
FORM_PRECISION = {"bf16r": "default", "tf32r": "high", "bf16d": "default"}
FORM_PEAK = {"bf16r": BF16_TC_PEAK, "tf32r": TF32_TC_PEAK, "bf16d": BF16_TC_PEAK}
TIER_BASES = ("hloss_terms_packed", "w_terms_packed", "hloss_terms", "w_terms", "loglik_sum",
              "h_terms")


def tier_source(base: str, form: str) -> str:
    if form == "tf32r":
        return "sweep_wgmma_tf32_packed.cu" if base.endswith("_packed") else (
            "sweep_wgmma_tf32_dense.cu")
    if base.endswith("_packed"):
        return "sweep_wgmma_packed.cu"
    return "sweep_bf16.cu" if form == "bf16d" else "sweep_tiers_bf16r.cu"


# name: (source, file:line of the TPU kernel): the form replaces the same
# Pallas kernel as its float32 instance, run under that precision or on bf16
# data.  The packed kernels have no bf16-data form (words replace the data).
TIER_KERNELS = {f"{base}_{form}": (tier_source(base, form), KERNELS[base][1])
                for base in TIER_BASES for form in TIER_FORMS
                if not (base.endswith("_packed") and form == "bf16d")}
# A rounded operand rounds the other way where the kernel's fp32 sums (WH,
# the ratios) differ from the plain version's in the last bit: Num/Den/T
# within 1e-4 of max |plain|, ll within 1e-5 of sum |x|.
TOL_TIER_TERMS = 1e-4
TOL_TIER_LL = 1e-5
# The loss of a fit under a reduced tier may rise by this much from one sweep
# to the next (the products carry bf16- or TF32-grade rounding).
TIER_DESCENT = 2e-3
# The 100-sweep headline solve's final loss under a reduced tier against the
# float32 solve's, relative.
TIER_LOSS_REL = 1e-3
# Phase 11: checkpoint, utils and baselines.  A checkpointed fit of
# CKPT_SWEEPS sweeps in segments of CKPT_EVERY, and a resume from half of
# them, against one uninterrupted fit: max |dW|, max |dH| and the largest
# relative loss deviation, the bars of tests/test_torch_checkpoint.py
# (SEGMENT_BARS; float64 there shows that the re-normalization at segment
# starts is the only source of deviation, at 1e-15).
CKPT_SWEEPS = 100
CKPT_EVERY = 25
CKPT_BARS = dict(W=1e-5, H=1e-5, loss=1e-6)
NAN_SWEEPS = 50
# The paper's 10-init test protocol on the committed animals split
# (tests/test_baselines.py::TestArtifactQuality): NBMF-EM at K=16 within 3%
# of the stored mean test NLL in at most 5 iterations, logPCA at K=2 within 2%.
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BASELINE_SEEDS = 10
BASELINES = {"NBMF-EM": dict(k=16, max_iter=500, rel=0.03, max_n_iter=5),
             "logPCA": dict(k=2, max_iter=1000, rel=0.02, max_n_iter=None)}
# One seed of each baseline in float64 on the card against the CPU: the same
# n_iter, the losses within this relative bar (summation orders and the SVD
# differ; the CPU tests hold the cores to the JAX package's at 1e-12).
BASELINE_DEVICE_REL = 1e-10
# Phase 12: the stress driver.  Geometries drawn on the host, those launched
# on the card, and draws per backend, from fixed seeds.
STRESS_PLANNERS = 5000
STRESS_LAUNCHED = 64
STRESS_DRAWS = {"fused": 100, "edge-fused": 100, "estimator-fused": 100}
STRESS_SEED = 12
# Phase 13: the experiment runners.  The JAX round's Figure 2 results
# (mean and standard deviation of the 10-init NBMF-MM test NLL, the
# baselines' means), against which the port's 10-init protocol is held to
# FIG2_SIGMAS standard deviations and the baselines to phase 11's relative
# bars (BASELINES); each dataset's Figure 2 fit on the card against the same
# seed on the CPU, test NLL within CARD_CPU_NLL.
JAX_FIG2 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs",
                        "figure2_results.csv")
FIG2_SIGMAS = 2.0
CARD_CPU_NLL = 1e-3
EXPERIMENTS_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                               "experiments")
# The flagship row's bars: the worst rise of the loss from one sweep to the
# next relative to the final loss, and the final loss against the oracle NLL.
FLAGSHIP_DESCENT = 5e-4
FLAGSHIP_ORACLE_REL = 0.01


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


def bound(flops: float, nbytes: float, peak: float = FP32_PEAK):
    """(bound_ms, bound_by) of work of ``flops`` operations at ``peak`` per
    second moving ``nbytes``."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_resources(log: str, match: str) -> dict:
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"}
    from ptxas -v's lines in a build log, for the kernels whose names match
    the regex ``match`` (demangled by c++filt where it is installed, else
    the mangled names), each instance once."""
    out, name, spills = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), ""
        elif "spill stores" in line:
            spills = ", ".join(part.strip() for part in line.split(",")[1:])
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[name] = f"{regs} registers, {spills}"
    names = list(out)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True, text=True,
                               timeout=60, check=True).stdout.splitlines()
        if len(plain) == len(out):
            names = [re.sub(r"^(void )?\(anonymous namespace\)::", "", n) for n in plain]
            names = [n[:n.rfind(">(") + 1] or n for n in names]
    except (OSError, subprocess.SubprocessError):
        pass
    return {n: used for n, used in zip(names, out.values()) if re.search(match, n)}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def zero_counts(*modules) -> None:
    """Set every launch counter, and every lane counter, of ``modules`` to 0."""
    for module in modules:
        for counts in (module.LAUNCHES, getattr(module, "LANES", {})):
            for name in counts:
                counts[name] = 0


def read_counts(*modules) -> dict:
    return {name: n for module in modules for name, n in module.LAUNCHES.items()}


def read_lanes(*modules) -> dict:
    """Lanes launched per kernel since the counters were zeroed."""
    return {name: n for module in modules for name, n in module.LANES.items()}


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
    """The four dense kernels against their plain versions in all three
    mask modes (weighted masks), each launched twice for bitwise
    repeatability; loglik_sum's ll and h_terms' Num/Den equal the H pass's
    bitwise."""
    for mode in MODES:
        o = operands(Y, k, mode, 5, cs, weighted=True)
        kw_h = dict(eps=EPS, m_real=o["m"], n_real=o["n"])
        kw_w = dict(eps=EPS, n_real=o["n"])
        h = lambda: ds.hloss_terms(o["W"], o["H"], o["Ym"], o["Yc"], bm=o["bm"], **kw_h)
        w = lambda: ds.w_terms(o["W"], o["H"], o["Ym"], o["Ym2"], bm=o["bm"], **kw_w)
        s = lambda: ds.loglik_sum(o["W"], o["H"], o["Ym"], o["Yc"], bm=o["bm"], **kw_h)
        t = lambda: ds.h_terms(o["W"], o["H"], o["Ym"], o["Yc"], eps=EPS, bm=o["bm"])
        (num, den, ll), (num2, den2, ll2) = h(), h()
        T, T2 = w(), w()
        lls, lls2 = s(), s()
        (hn, hd), (hn2, hd2) = t(), t()
        torch.cuda.synchronize()
        pnum, pden, pll = ds.hloss_terms_plain(o["W"], o["H"], o["Ym"], o["Yc"], **kw_h)
        pT = ds.w_terms_plain(o["W"], o["H"], o["Ym"], o["Ym2"], **kw_w)
        plls = ds.loglik_sum_plain(o["W"], o["H"], o["Ym"], o["Yc"], **kw_h)
        e = dict(num=rel(num, pnum), den=rel(den, pden), T=rel(T, pT), ll=rel_ll(ll, pll),
                 loglik=rel_ll(lls, plls), h_terms=max(rel(hn, pnum), rel(hd, pden)))
        errors["hloss_terms"] = max(errors["hloss_terms"], abs_err(num, pnum),
                                    abs_err(den, pden), abs_err(ll, pll))
        errors["w_terms"] = max(errors["w_terms"], abs_err(T, pT))
        errors["loglik_sum"] = max(errors["loglik_sum"], abs_err(lls, plls))
        errors["h_terms"] = max(errors["h_terms"], abs_err(hn, pnum), abs_err(hd, pden))
        repeat = all(map(torch.equal, (num, den, ll, T, lls, hn, hd),
                         (num2, den2, ll2, T2, lls2, hn2, hd2)))
        same_ll = torch.equal(lls, ll)
        same_terms = torch.equal(hn, num) and torch.equal(hd, den)
        print(f"dense kernels {name} {mode} k={k}: rel err num {e['num']:.3e} den "
              f"{e['den']:.3e} T {e['T']:.3e} h_terms {e['h_terms']:.3e} (bound {TOL_TERMS:g} "
              f"of max|plain|), ll {e['ll']:.3e} loglik_sum {e['loglik']:.3e} (bound "
              f"{TOL_LL:g}); bitwise repeat {repeat}; loglik_sum == H-pass ll bitwise {same_ll}; "
              f"h_terms == H-pass Num/Den bitwise {same_terms} [{card}]", flush=True)
        check(max(e["num"], e["den"], e["T"], e["h_terms"]) <= TOL_TERMS
              and max(e["ll"], e["loglik"]) <= TOL_LL,
              f"{name} {mode}: dense kernel disagrees with plain {e}")
        check(repeat, f"{name} {mode}: dense kernel outputs differ between two launches")
        check(same_ll, f"{name} {mode}: loglik_sum differs from the H pass's ll")
        check(same_terms, f"{name} {mode}: h_terms differs from the H pass's Num/Den")


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


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes, to compare outputs across trees."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_wpass_edges(card, cs, ds, errors):
    """K2 and the dense W pass at the shapes that hit the column split's
    edges (W_EDGES): against their plain versions in all three mask modes,
    launched twice for bitwise repeatability, dense == packed bitwise on
    binary data, the dense pass on [0,1] data under a weighted mask, and
    W_EDGE_LANES lanes of both against one-lane launches bitwise.  Returns
    ``{label: digest}`` of every T computed from the fixed draws, for a
    comparison with another tree's kernels on the same draws."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    digests = {}
    for label, (m, n), k in W_EDGES:
        rng = np.random.default_rng(m + n + k)
        Y = (rng.random((m, n)) < 0.3).astype(np.float32)
        soft = rng.random((m, n)).astype(np.float32)
        bm, Mp, Np = cs.plan_packing(m, n)
        plan = cs.plan_w_split(Mp, Np, k, n_sm)
        worst, repeat, same, lanes_same = 0.0, True, True, True
        W, H = lane_factors(m, n, k, Mp, Np, W_EDGE_LANES, 10 + k)
        for mode in MODES:
            o = operands(Y, k, mode, 8, cs)
            s = operands(soft, k, mode, 9, cs, weighted=True)
            k2 = lambda W=o["W"], H=o["H"]: cs.w_terms_packed(W, H, o["words"], o["words2_w"],
                                                              eps=EPS, n_real=n, bm=bm)
            dw = lambda: ds.w_terms(o["W"], o["H"], o["Ym"], o["Ym2"], eps=EPS, n_real=n, bm=bm)
            sw = lambda W=s["W"], H=s["H"]: ds.w_terms(W, H, s["Ym"], s["Ym2"], eps=EPS,
                                                       n_real=n, bm=bm)
            T, T2, D, D2, S, S2 = k2(), k2(), dw(), dw(), sw(), sw()
            TL, SL = k2(W, H), sw(W, H)
            lanes_same &= all(torch.equal(TL[r], k2(W[r], H[r])) and
                              torch.equal(SL[r], sw(W[r], H[r])) for r in range(W_EDGE_LANES))
            torch.cuda.synchronize()
            digests[f"{label} {mode}"] = digest(T, S, TL, SL)
            pT = cs.w_terms_packed_plain(o["W"], o["H"], o["words"], o["words2_w"], eps=EPS,
                                         n_real=n, bm=bm)
            pS = ds.w_terms_plain(s["W"], s["H"], s["Ym"], s["Ym2"], eps=EPS, n_real=n)
            worst = max(worst, rel(T, pT), rel(S, pS))
            errors["w_terms_packed"] = max(errors["w_terms_packed"], abs_err(T, pT))
            errors["w_terms"] = max(errors["w_terms"], abs_err(D, pT), abs_err(S, pS))
            repeat &= all(map(torch.equal, (T, D, S), (T2, D2, S2)))
            same &= torch.equal(T, D)
        print(f"W pass {label} {m}x{n} k={k} (Mp {Mp}, Np {Np}, bm {bm}; {plan.nsplit} column "
              f"chunks, {plan.blocks} blocks): K2 and dense W (binary, weighted [0,1]) in "
              f"{'/'.join(MODES)}: max rel err {worst:.3e} (bound {TOL_TERMS:g} of max|plain|); "
              f"bitwise repeat {repeat}; dense == packed bitwise {same}; {W_EDGE_LANES} lanes == "
              f"one-lane launches bitwise {lanes_same}; T digests "
              f"{' '.join(digests[f'{label} {mode}'] for mode in MODES)} [{card}]", flush=True)
        check(worst <= TOL_TERMS, f"W pass {label}: kernel disagrees with plain")
        check(repeat, f"W pass {label}: outputs differ between two launches")
        check(same, f"W pass {label}: dense differs from packed")
        check(lanes_same, f"W pass {label}: a lane differs from the one-lane launch")
    return digests


def check_hpass_edges(card, cs, ds, errors):
    """The four H passes at the shapes that hit the row split's edges
    (H_EDGES): K1 and the dense pass on binary data, the dense passes again
    on [0,1] data under a weighted mask, against their plain versions in all
    three mask modes, each launched twice for bitwise repeatability; dense
    == packed, loglik_sum's ll == the H pass's and h_terms' Num/Den == the H
    pass's, bitwise; H_EDGE_LANES lanes of K1 and of the dense pass against
    one-lane launches bitwise.  Returns ``{label: digest}`` of the Num/Den
    computed from the fixed draws, for a comparison with another tree's
    kernels on the same draws."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    inside, digests = [], {}
    ring = set()  # chunk lengths of 3 or more word rows the warp-specialised body ran
    for label, (m, n), k in H_EDGES:
        rng = np.random.default_rng(m + n + k)
        Y = (rng.random((m, n)) < 0.3).astype(np.float32)
        soft = rng.random((m, n)).astype(np.float32)
        bm, Mp, Np = cs.plan_packing(m, n)
        plan = cs.plan_h_split(Mp, Np, k, n_sm)
        inside.append(any(b % (bm // 32) for b, _ in plan.chunks))
        if cs.h_warp_specialised(k):
            ring |= {e - b for b, e in plan.chunks if e - b >= 3}
        worst = worst_ll = 0.0
        repeat = same = lanes_same = True
        WL, HL = lane_factors(m, n, k, Mp, Np, H_EDGE_LANES, 20 + k)
        terms = []
        for mode in MODES:
            for o, binary in ((operands(Y, k, mode, 10, cs), True),
                              (operands(soft, k, mode, 11, cs, weighted=True), False)):
                kw = dict(eps=EPS, m_real=m, n_real=n, bm=bm)
                args = (o["W"], o["H"], o["Ym"], o["Yc"])
                runs = {"hloss_terms": lambda: ds.hloss_terms(*args, **kw),
                        "loglik_sum": lambda: (ds.loglik_sum(*args, **kw),),
                        "h_terms": lambda: ds.h_terms(*args, eps=EPS, bm=bm)}
                if binary:
                    runs["hloss_terms_packed"] = lambda: cs.hloss_terms_packed(
                        o["W"], o["H"], o["words"], o["words2_h"], **kw)
                got = {name: (fn(), fn()) for name, fn in runs.items()}
                torch.cuda.synchronize()
                pnum, pden, pll = ds.hloss_terms_plain(*args, eps=EPS, m_real=m, n_real=n)
                want = {"hloss_terms": (pnum, pden, pll), "loglik_sum": (pll,),
                        "h_terms": (pnum, pden), "hloss_terms_packed": (pnum, pden, pll)}
                for name, (out, again) in got.items():
                    for g, w in zip(out, want[name]):
                        if g.numel() == 1:
                            worst_ll = max(worst_ll, rel_ll(g, w))
                        else:
                            worst = max(worst, rel(g, w))
                        errors[name] = max(errors[name], abs_err(g, w))
                    repeat &= all(map(torch.equal, out, again))
                h = got["hloss_terms"][0]
                same &= torch.equal(got["loglik_sum"][0][0], h[2])
                same &= all(map(torch.equal, got["h_terms"][0], h[:2]))
                lane_runs = [lambda W, H: ds.hloss_terms(W, H, o["Ym"], o["Yc"], **kw)]
                if binary:
                    same &= all(map(torch.equal, got["hloss_terms_packed"][0], h))
                    lane_runs.append(lambda W, H: cs.hloss_terms_packed(
                        W, H, o["words"], o["words2_h"], **kw))
                for run in lane_runs:
                    batched = run(WL, HL)
                    lanes_same &= all(all(map(torch.equal, (x[r] for x in batched),
                                              run(WL[r], HL[r])))
                                      for r in range(H_EDGE_LANES))
                    terms += [*batched[:2]]
                terms += [*h[:2]]
        torch.cuda.synchronize()
        digests[label] = digest(*terms)
        print(f"H pass {label} {m}x{n} k={k} (Mp {Mp}, Np {Np}, bm {bm}; {plan.nsplit} row "
              f"chunks, {plan.blocks} blocks, a chunk boundary inside a stripe {inside[-1]}): "
              f"K1, dense H, loglik_sum, h_terms (binary, weighted [0,1]) in {'/'.join(MODES)}: "
              f"max rel err {worst:.3e} (bound {TOL_TERMS:g} of max|plain|), ll {worst_ll:.3e} "
              f"(bound {TOL_LL:g}); bitwise repeat {repeat}; dense == packed, loglik_sum == ll, "
              f"h_terms == Num/Den bitwise {same}; {H_EDGE_LANES} lanes == one-lane launches "
              f"bitwise {lanes_same}; Num/Den digest {digests[label]} [{card}]", flush=True)
        check(worst <= TOL_TERMS and worst_ll <= TOL_LL, f"H pass {label}: kernel disagrees")
        check(repeat, f"H pass {label}: outputs differ between two launches")
        check(same, f"H pass {label}: a bitwise equality of the H passes failed")
        check(lanes_same, f"H pass {label}: a lane differs from the one-lane launch")
    check(any(inside), "no H_EDGES shape puts a row-chunk boundary inside a stripe")
    check(any(r % 2 for r in ring) and not all(r % 2 for r in ring),
          f"no H_EDGES shape gives the warp-specialised H pass chunks of 3 or more word rows, "
          f"odd and even (it gets {sorted(ring)})")
    return digests


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
    return est, params, wall, launches


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
    results = {}
    for name, Y, kw in runs:
        kw = dict(kw, random_state=0, dtype="float32", device=DEV)
        dense, auto = solve(Y, packed=False, **kw), solve(Y, **kw)
        results[name] = (auto, kw)
        same = (dense.n_iter == auto.n_iter and dense.losses == auto.losses
                and np.array_equal(dense.W, auto.W) and np.array_equal(dense.H, auto.H))
        print(f"solve packed=False vs packed=None ({name}, {dense.n_iter} sweeps): "
              f"extras {dense.extras} / {auto.extras}; bitwise equal {same} [{card}]", flush=True)
        check(dense.extras["packed"] is False and auto.extras["packed"] is True,
              f"{name}: packed routing")
        check(same, f"{name}: packed and dense solves differ")
    return results, mask


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
    K1/K2 on the binary matrix's words, the dense kernels on P (unmasked);
    then K2 and the dense W pass on the top serving chunk.  Each with its
    bound; no single PyTorch call computes any of these functions."""
    o = operands(X, k, "unmasked", 2, cs)
    d = operands(P, k, "unmasked", 2, cs, weighted=True)
    m, n = o["m"], o["n"]
    kw1 = dict(eps=EPS, m_real=m, n_real=n)
    kw2 = dict(eps=EPS, n_real=n)
    W, H, words, Ym, bm = o["W"], o["H"], o["words"], d["Ym"], o["bm"]
    mnk = m * n * k
    factors_b = tensor_bytes(W, H)
    num_den_b, T_b = 2 * tensor_bytes(H), tensor_bytes(W)
    entries = {
        "hloss_terms_packed": (
            lambda: cs.hloss_terms_packed(W, H, words, bm=bm, **kw1),
            lambda: cs.hloss_terms_packed_plain(W, H, words, bm=bm, **kw1),
            6 * mnk, factors_b + tensor_bytes(words) + num_den_b + 4),
        "w_terms_packed": (
            lambda: cs.w_terms_packed(W, H, words, bm=bm, **kw2),
            lambda: cs.w_terms_packed_plain(W, H, words, bm=bm, **kw2),
            6 * mnk, factors_b + tensor_bytes(words) + T_b),
        "hloss_terms": (
            lambda: ds.hloss_terms(W, H, Ym, bm=bm, **kw1),
            lambda: ds.hloss_terms_plain(W, H, Ym, **kw1),
            6 * mnk, factors_b + tensor_bytes(Ym) + num_den_b + 4),
        "w_terms": (
            lambda: ds.w_terms(W, H, Ym, bm=bm, **kw2),
            lambda: ds.w_terms_plain(W, H, Ym, **kw2),
            6 * mnk, factors_b + tensor_bytes(Ym) + T_b),
        "loglik_sum": (
            lambda: ds.loglik_sum(W, H, Ym, bm=bm, **kw1),
            lambda: ds.loglik_sum_plain(W, H, Ym, **kw1),
            2 * mnk, factors_b + tensor_bytes(Ym) + 4),
    }
    times = {}
    for name, (fn, plain, flops, nbytes) in entries.items():
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
        bound_ms, bound_by = bound(flops, nbytes)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
        # The H passes also against the reference's estimate, 8 m n k.
        ref = (f"; {100 * bound(8 * mnk, nbytes)[0] / ms:.1f}% of the reference's 8 m n k "
               f"bound" if name in ("hloss_terms_packed", "hloss_terms") else "")
        print(f"timing {name} at {m}x{n} k={k}: kernel {ms:.4f} ms/call, plain {plain_ms:.4f} "
              f"ms/call; {flops / ms / 1e9:.2f} TFLOP/s by the flops it does, "
              f"{100 * bound_ms / ms:.1f}% of its {bound_ms:.4f} ms bound ({bound_by}){ref} "
              f"[{card}]", flush=True)
    del o, d, W, H, words, Ym

    rows = SERVE_BUCKETS[-1]
    o = operands(X[:rows], k, "unmasked", 3, cs)
    d = operands(P[:rows], k, "unmasked", 3, cs, weighted=True)
    W, H, words, Ym, bm = o["W"], o["H"], o["words"], d["Ym"], o["bm"]
    flops = 6 * rows * n * k
    for name, fn, plain, data in (
            ("w_terms_packed", lambda: cs.w_terms_packed(W, H, words, bm=bm, **kw2),
             lambda: cs.w_terms_packed_plain(W, H, words, bm=bm, **kw2), words),
            ("w_terms", lambda: ds.w_terms(W, H, Ym, bm=bm, **kw2),
             lambda: ds.w_terms_plain(W, H, Ym, **kw2), Ym)):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
        bound_ms, bound_by = bound(flops, tensor_bytes(W, H, data) + tensor_bytes(W))
        print(f"timing {name} at the {rows}x{n} serving chunk k={k}: kernel {ms:.4f} ms/call, "
              f"plain {plain_ms:.4f} ms/call; {flops / ms / 1e9:.2f} TFLOP/s, "
              f"{100 * bound_ms / ms:.1f}% of its {bound_ms:.4f} ms bound ({bound_by}) [{card}]",
              flush=True)
    return times


def loop_ms_per_sweep(name, Y, k, packed, card, cs, lanes=None, runs=(5, 25), precision=None,
                      bf16=False):
    """ms/sweep of ``_solve_core_fused`` on operands already staged on the
    card: CUDA events around two runs of ``runs`` sweeps (tol=0), slope.
    With ``lanes`` the batched loop over that many restarts, with
    ``precision`` the loop of that tier, with ``bf16`` over bf16 data."""
    from nbmf_mm_tpu_torch.solver.driver import _solve_core_fused

    m, n = Y.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    Ym = padded(torch.as_tensor(Y, device=DEV), Mp, Np)
    Y1 = cs.pack_bits(Ym, bm) if packed else Ym.to(torch.bfloat16) if bf16 else Ym
    W0, H0 = factors(m, n, k, Mp, Np, 3) if lanes is None else lane_factors(m, n, k, Mp, Np,
                                                                           lanes, 3)
    kw = dict(packed=packed, alpha=1.2, beta=1.2, tol=0.0, eps=EPS, n_obs=float(m * n),
              m_real=m, n_real=n, bm=bm, projection="normalize", verbose=0,
              mxu_precision=precision)
    run = lambda sweeps: _solve_core_fused(Y1, None, None, W0, H0, max_iter=sweeps, **kw)
    run(2)
    ms = {}
    for sweeps in runs:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(sweeps)
        end.record()
        torch.cuda.synchronize()
        check(bool((torch.as_tensor(out[3]) == sweeps).all()), f"{name} timing run stopped early")
        ms[sweeps] = start.elapsed_time(end)
    short, long = runs
    per_sweep = (ms[long] - ms[short]) / (long - short)
    batch = ("" if lanes is None else f", {lanes} lanes") + (
        f", precision {precision}" if precision else "") + (", bf16 data" if bf16 else "")
    print(f"timing fused loop ({name}, packed={packed}{batch}) at {m}x{n} k={k}: "
          f"{per_sweep:.3f} ms/sweep ({1e3 / per_sweep:.2f} sweeps/s); {long} sweeps "
          f"{ms[long]:.1f} ms [{card}]", flush=True)
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
            out[(label, kind)] = request_ms(srv, X, mask)
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
    add = lambda name, label, fn, plain, flops=None, nbytes=None, scale=None, library=None: \
        cases.append((name, label, fn, plain, flops, nbytes, scale, library))
    for Yc, label in ((None, "Yc=None"), (d["Yc"], "Yc explicit")):
        add("h_terms", label, partial(ds.h_terms, W, H, Y, Yc, bm=256),
            partial(ds.h_terms_plain, W, H, Y, Yc, eps=EPS), 6 * mnk)
    for kind, prec in (("hbm_only", None), ("vpu_only", None), ("mxu_only", "DEFAULT"),
                       ("mxu_only", "HIGHEST")):
        fn = pr.make_kernel(kind, k, m, n, block, block, prec)
        plain = pr.make_kernel_plain(kind, k, m, n, block, block, prec)
        # hbm_only's column sums: one torch.sum over the rows.
        add("make_kernel", f"{kind} {prec or ''}".strip(), partial(fn, W, H, Y),
            partial(plain, W, H, Y), 6 * mnk if kind == "mxu_only" else None,
            nbytes=4 * m * n if prec is None else None,
            library=partial(torch.sum, Y, dim=0, dtype=torch.float64) if kind == "hbm_only"
            else None)
    for mxu, label in ((None, "f32"), (torch.bfloat16, "bf16")):
        for name, flops, extra in (("hloss_packed", 6, {}), ("w_packed", 4, {"n_real": n}),
                                   ("hloss_packed2", 6, {}), ("w_packed2", 4, {"n_real": n})):
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
                partial(pr.hloss_ngrid_plain, W, H, data, **kw), 6 * mnk)
    stream = ([(256, n, "f32"), (128, 128, "f32"), (256, n, "bf16")] if small
              else configs(n))
    for bm, bn, dt in stream:
        X = Y if dt == "f32" else Yb
        add("stream_kernel", f"tile ({bm},{bn}) {dt}",
            partial(pr.stream_kernel(m, n, bm, bn, dt), X), partial(pr.stream_kernel_plain, X),
            nbytes=X.numel() * X.element_size(),
            library=partial(torch.sum, X, dtype=torch.float64))
    for frag, packed, label in RUNS:
        X = Yp if packed else Y
        # Words add as signed int32 values: hold the sum to sum |x|.
        scale = X.double().abs().sum() if frag == "stream_sum" and packed else None
        add("frag_kernel", label, partial(pr.frag_kernel, X, frag=frag, packed=packed),
            partial(pr.frag_kernel_plain, X, frag=frag, packed=packed),
            nbytes=X.numel() * X.element_size(), scale=scale,
            library=partial(torch.sum, X, dtype=torch.float64) if frag == "stream_sum" else None)
    return cases, d


def check_probes(m, n, k, card, cs, ds, pr, errors, *, timed):
    """Each probe variant and h_terms against its plain version at
    (m, n, k), launched twice for bitwise repeatability, then the bitwise
    equalities the port promises; with ``timed``, ms/call of kernel and plain.
    Returns {kernel: (ms, plain_ms)} of each kernel's first variant."""
    cases, d = probe_cases(m, n, k, cs, ds, pr)
    outs = {}
    for name, label, fn, plain, _, _, scale, _ in cases:
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
    for name, label, fn, plain, flops, nbytes, _, library in (cases if timed else ()):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
        # The bound: the tool's count, else one add per element of the
        # operand; every tensor argument read once, every output written once.
        operand = next(a for a in reversed(fn.args) if isinstance(a, torch.Tensor))
        bound_ms, bound_by = bound(flops or operand.numel(),
                                   tensor_bytes(*fn.args) + tensor_bytes(*outs[(name, label)]))
        library_ms = cuda_ms(library) if library is not None else None
        entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)
        times.setdefault(name, dict(entry))
        if name in VARIANT_KERNELS:  # every variant in the kernels line, too
            times[name].setdefault("variants", {})[label] = entry
        rate = f", {flops / ms / 1e9:.2f} TFLOP/s by the tool's count" if flops else ""
        rate += f", {nbytes / ms / 1e6:.1f} GB/s" if nbytes else ""
        lib = f", library {library_ms:.4f} ms/call" if library_ms is not None else ""
        print(f"timing probe {name} {label} at {m}x{n} k={k}: kernel {ms:.4f} ms/call, plain "
              f"{plain_ms:.4f} ms/call{lib}{rate}, {100 * bound_ms / ms:.1f}% of its "
              f"{bound_ms:.4f} ms bound ({bound_by}) [{card}]", flush=True)
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


def add_counts(total: dict, *modules) -> None:
    """Add the launch counters read now to ``total``."""
    for name, count in read_counts(*modules).items():
        total[name] = total.get(name, 0) + count


def expect_raises(exc, match: str, fn, what: str) -> None:
    """``fn`` must raise ``exc`` with ``match`` in its message."""
    try:
        fn()
    except exc as e:
        check(match in str(e), f"{what}: raised {e!r}, expected {match!r} in the message")
        return
    raise RuntimeError(f"check failed: {what}: did not raise {exc.__name__}")


def same_result(a, b) -> bool:
    return (a.n_iter == b.n_iter and list(a.losses) == list(b.losses)
            and np.array_equal(a.W, b.W) and np.array_equal(a.H, b.H))


def timed(fn):
    """(result, seconds) of ``fn`` on the host clock, the card drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def input_fits(NBMF, X, S, binary_est, params, binary_wall, total, card, cs, ds):
    """``NBMF.fit`` on the headline matrix as a CSR and as a PackedMatrix:
    bitwise the binary main path's fit, through K1 and K2 only."""
    from nbmf_mm_tpu_torch import pack_matrix

    pm, pack_s = timed(lambda: pack_matrix(X, HEADLINE["k"], device=DEV))
    for kind, data in (("scipy.sparse CSR", S), ("PackedMatrix", pm)):
        zero_counts(cs, ds)
        est, wall = timed(lambda: NBMF(**params).fit(data))
        launches = read_counts(cs, ds)
        add_counts(total, cs, ds)
        same = (np.array_equal(est.W_, binary_est.W_)
                and np.array_equal(est.components_, binary_est.components_)
                and est.loss_curve_ == binary_est.loss_curve_)
        extra = f" (after pack_matrix on the host {pack_s:.2f} s)" if data is pm else ""
        print(f"input: NBMF.fit on the headline matrix as {kind}: n_iter {est.n_iter_}, "
              f"{wall:.2f} s wall{extra} against {binary_wall:.2f} s from the numpy matrix; "
              f"W_, components_, loss_curve_ bitwise equal to that fit {same}; extras "
              f"{est.solver_result_.extras}; launches {launches} [{card}]", flush=True)
        check(same, f"fit on {kind} differs from the dense-input fit")
        check(est.solver_result_.extras == {"backend": "fused", "packed": True},
              f"fit on {kind} took {est.solver_result_.extras}")
        for name in ("hloss_terms_packed", "w_terms_packed"):
            check(launches[name] >= est.n_iter_ > 0, f"fit on {kind}: {name} launched "
                  f"{launches[name]} times for {est.n_iter_} sweeps")
        check(launches["hloss_terms"] == launches["w_terms"] == launches["loglik_sum"] == 0,
              f"fit on {kind} launched a dense kernel")
    return pm


def input_packers(solve, X, S, pm, dense_solve, total, card, cs, ds):
    """The four packers give the words of ``pack_bits`` on the padded matrix;
    a solve on them, and its device results, equal the dense-input solve."""
    from nbmf_mm_tpu_torch import pack_matrix_chunked, pack_matrix_sparse

    m, n = X.shape
    k = HEADLINE["k"]
    bm, Mp, Np = cs.plan_packing(m, n)
    Xd = torch.as_tensor(X, device=DEV)
    want = cs.pack_bits(padded(Xd, Mp, Np), bm)
    packs = {"pack_matrix": (pm, None)}
    packs["pack_matrix_sparse"] = timed(lambda: pack_matrix_sparse(S, k, device=DEV))
    packs["pack_matrix_chunked (host chunks of 2048 rows)"] = timed(
        lambda: pack_matrix_chunked(lambda a, b: X[a:b], m, n, k, chunk_rows=2048, device=DEV))
    packs["pack_matrix_chunked (tensor chunks on the card)"] = timed(
        lambda: pack_matrix_chunked(lambda a, b: Xd[a:b], m, n, k, chunk_rows=2048, device=DEV))
    for name, (p, seconds) in packs.items():
        same = torch.equal(p.words, want) and p.block_m == bm and p.padded_shape == (Mp, Np)
        round_trip = torch.equal(p.unpack(), Xd)
        took = "" if seconds is None else f" in {seconds:.2f} s"
        print(f"input: {name}{took}: {p.nbytes / 1e6:.1f} MB of words on {p.words.device}, "
              f"bitwise equal to pack_bits of the padded matrix {same}; unpack() equals the "
              f"matrix {round_trip} [{card}]", flush=True)
        check(same and round_trip, f"{name}: wrong words")
        check(p.words.is_cuda and p.words.is_contiguous() and p.words.data_ptr() % 16 == 0,
              f"{name}: words not contiguous, aligned and on the card")
    del want, Xd

    auto, kw = dense_solve
    zero_counts(cs, ds)
    host = solve(pm, **kw)
    dev = solve(pm, device_results=True, **kw)
    launches = read_counts(cs, ds)
    add_counts(total, cs, ds)
    on_card = all(isinstance(t, torch.Tensor) and t.is_cuda for t in (dev.W, dev.H, dev.losses))
    dev_same = (on_card and np.array_equal(dev.W.cpu().numpy(), auto.W)
                and np.array_equal(dev.H.cpu().numpy(), auto.H)
                and [float(x) for x in dev.losses.cpu()] == auto.losses)
    print(f"input: solve(PackedMatrix), {host.n_iter} sweeps at tol=0: bitwise equal to the "
          f"dense-input solve {same_result(host, auto)}; device_results=True returns CUDA "
          f"tensors {on_card} equal to those arrays {dev_same}; launches {launches} [{card}]",
          flush=True)
    check(same_result(host, auto), "solve(PackedMatrix) differs from the dense-input solve")
    check(dev_same, "device_results=True differs from the numpy results")
    check(launches["hloss_terms_packed"] == 2 * (host.n_iter + 1)
          and launches["w_terms_packed"] == 2 * host.n_iter, "solve(PackedMatrix): launches")


def input_sparse_masked(solve, lastfm, mask, dense_solves, total, card, cs, ds):
    """lastfm as a CSR under a CSR mask (80% observed): bitwise the
    dense-input masked solves, in both mask modes."""
    import scipy.sparse as sp

    S, M = sp.csr_matrix(lastfm), sp.csr_matrix(mask)
    for mode in ("parity", "corrected"):
        auto, kw = dense_solves[f"lastfm {mode}"]
        zero_counts(cs, ds)
        res = solve(S, **dict(kw, mask=M))
        launches = read_counts(cs, ds)
        add_counts(total, cs, ds)
        print(f"input: solve(csr, mask=csr) lastfm {mode}, {res.n_iter} sweeps: extras "
              f"{res.extras}; bitwise equal to the dense-input masked solve "
              f"{same_result(res, auto)}; launches {launches} [{card}]", flush=True)
        check(res.extras == {"backend": "fused", "packed": True}, f"sparse {mode}: routing")
        check(same_result(res, auto), f"sparse masked {mode} differs from dense input")
        check(launches["hloss_terms"] == launches["w_terms"] == 0,
              f"sparse masked {mode} launched a dense kernel")


def input_contract_errors(solve, X, S, pm, card):
    """The contract errors of packed and sparse input, raised on the card."""
    from nbmf_mm_tpu_torch import PackedMatrix

    kw = dict(max_iter=2, device=DEV)
    k = HEADLINE["k"]
    cases = (
        ("dir-beta", "beta-dir", lambda: solve(pm, k, orientation="dir-beta", **kw)),
        ("a mask", "mask", lambda: solve(pm, k, mask=np.ones(X.shape, np.float32), **kw)),
        ("packed=False", "packed=False", lambda: solve(pm, k, packed=False, **kw)),
        ("float64", "float32", lambda: solve(pm, k, dtype="float64", **kw)),
        ("a foreign block_m", "PackedMatrix", lambda: solve(
            PackedMatrix(words=pm.words, shape=pm.shape, block_m=128), k, **kw)),
        ("the plain loop", "fused loop", lambda: solve(pm, k, backend="plain", **kw)),
        ("a rank above the cap", "fused loop", lambda: solve(pm, 257, **kw)),
        ("3 * csr with packed=True", "binary", lambda: solve(S * 3.0, k, packed=True, **kw)),
    )
    for what, match, fn in cases:
        expect_raises(ValueError, match, fn, what)
    print(f"input: contract errors raised for {', '.join(c[0] for c in cases)} [{card}]",
          flush=True)


def scale_run(solve, total, card, cs, ds, errors):
    """The sparse-ingest scale run: a CSR at 3% packed straight from its
    structure, then solved from the words with device results.  The dense
    float32 matrix would take 4 m n bytes on the card; the peak must stay
    under half of that.  K1 and K2 plan other splits at this geometry than at
    any earlier phase's, so both are then held against their plain versions
    on the run's words and final factors."""
    import scipy.sparse as sp

    from nbmf_mm_tpu_torch import pack_matrix_sparse

    m, n, k, sweeps = SCALE["m"], SCALE["n"], SCALE["k"], SCALE["sweeps"]

    def build():
        rng = np.random.default_rng(0)
        nnz = int(SCALE["density"] * m * n)
        S = sp.csr_matrix((np.ones(nnz, dtype=np.float32),
                           (rng.integers(0, m, nnz), rng.integers(0, n, nnz))), shape=(m, n))
        S.data[:] = 1.0  # collisions summed at construction; binary again
        return S

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    S, build_s = timed(build)
    pm, ingest_s = timed(lambda: pack_matrix_sparse(S, k, device=DEV))
    check(ingest_s <= SCALE_INGEST_LIMIT_S, f"scale: packing {m} rows on the host took "
          f"{ingest_s:.1f} s, over {SCALE_INGEST_LIMIT_S:g} s")
    zero_counts(cs, ds)
    res, solve_s = timed(lambda: solve(pm, k, max_iter=sweeps, tol=0.0, random_state=0,
                                       device_results=True, device=DEV))
    # The second run is warm; its time over the sweeps is the ms/sweep.
    res, solve_s = timed(lambda: solve(pm, k, max_iter=sweeps, tol=0.0, random_state=0,
                                       device_results=True, device=DEV))
    launches = read_counts(cs, ds)
    add_counts(total, cs, ds)
    peak = torch.cuda.max_memory_allocated()
    dense_bytes = 4 * m * n
    losses = res.losses.cpu().numpy()
    row_sums = res.W.sum(dim=1)
    drift = float((row_sums - 1).abs().max())
    print(f"scale: {m}x{n} CSR at {S.nnz / (m * n):.2%} ({S.nnz} stored, built in "
          f"{build_s:.1f} s): pack_matrix_sparse {pm.nbytes / 1e6:.1f} MB of words in "
          f"{ingest_s:.2f} s ({m * n / ingest_s / 1e6:.0f} Mentries/s); solve(PackedMatrix, "
          f"k={k}, {sweeps} sweeps, device_results=True) {solve_s:.3f} s = "
          f"{1e3 * solve_s / sweeps:.2f} ms/sweep set-up included; loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; max |row sum of W - 1| {drift:.2e}; peak device memory "
          f"{peak / 1e6:.1f} MB ({held / 1e6:.1f} MB held before the run) against "
          f"{dense_bytes / 1e6:.0f} MB for the dense float32 matrix; "
          f"launches {launches} [{card}]", flush=True)
    check(all(isinstance(t, torch.Tensor) and t.is_cuda for t in (res.W, res.H, res.losses)),
          "scale: results are not CUDA tensors")
    check(res.n_iter == sweeps and np.isfinite(losses).all(), "scale: losses not finite")
    check(bool(np.all(losses[1:] <= losses[:-1] * (1 + 1e-5))), "scale: losses do not descend")
    check(drift <= 1e-5, "scale: rows of W do not sum to 1")
    check(tuple(res.W.shape) == (m, k) and tuple(res.H.shape) == (k, n), "scale: shapes")
    check(peak < dense_bytes / 2, f"scale: peak device memory {peak} is not under half of the "
          f"dense matrix's {dense_bytes}")
    check(launches["hloss_terms_packed"] == 2 * (sweeps + 1)
          and launches["w_terms_packed"] == 2 * sweeps, "scale: launches")

    # After the peak reading: the plain versions hold the dense product.  With
    # one column chunk the W pass adds each output's columns in order, as the
    # plain version's matmuls do here, so T may agree to the last bit.
    bm, Mp, Np = cs.plan_packing(m, n)
    check(pm.block_m == bm and tuple(pm.words.shape) == (Mp // 32, Np), "scale: geometry")
    W, H = padded(res.W.T, k, Mp), padded(res.H, k, Np)
    del res
    num, den, ll = cs.hloss_terms_packed(W, H, pm.words, eps=EPS, m_real=m, n_real=n, bm=bm)
    T = cs.w_terms_packed(W, H, pm.words, eps=EPS, n_real=n, bm=bm)
    torch.cuda.synchronize()
    pnum, pden, pll = cs.hloss_terms_packed_plain(W, H, pm.words, eps=EPS, m_real=m, n_real=n,
                                                  bm=bm)
    pT = cs.w_terms_packed_plain(W, H, pm.words, eps=EPS, n_real=n, bm=bm)
    e = dict(num=rel(num, pnum), den=rel(den, pden), T=rel(T, pT), ll=rel_ll(ll, pll))
    errors["hloss_terms_packed"] = max(errors["hloss_terms_packed"], abs_err(num, pnum),
                                       abs_err(den, pden), abs_err(ll, pll))
    errors["w_terms_packed"] = max(errors["w_terms_packed"], abs_err(T, pT))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"scale: kernels at {Mp}x{Np} k={k} ({Mp // bm} stripes), H split "
          f"{cs.plan_h_split(Mp, Np, k, n_sm)}, W split {cs.plan_w_split(Mp, Np, k, n_sm)}: "
          f"rel err num {e['num']:.3e} den {e['den']:.3e} T {e['T']:.3e} (bound {TOL_TERMS:g} "
          f"of max|plain|), ll {e['ll']:.3e} (bound {TOL_LL:g}); T bitwise equal to plain "
          f"{torch.equal(T, pT)} [{card}]", flush=True)
    check(max(e["num"], e["den"], e["T"]) <= TOL_TERMS and e["ll"] <= TOL_LL,
          f"scale: kernel disagrees with plain {e}")


def setup_breakdown(solve, X, pm, card, cs):
    """Where the set-up of a headline fit from numpy input goes, unmasked and
    parity-masked: the estimator's checks, the scans, the three stagings that
    give the same words (seconds and peak device memory each), and the loop."""
    from nbmf_mm_tpu_torch.ops.packed import _pack_host, _pack_tensor, binary_as_uint8
    from nbmf_mm_tpu_torch.solver import driver

    def stage(Y, mask, how):
        """Words (Y1, Y2) on the card of host operands: the float32 operands
        through solve's own staging; or scanned and packed on the host, the
        words copied; or scanned on the host, copied as uint8 and packed on
        the card."""
        if how == "f32-device":
            Y1, Y2, binary = driver._stage_dense(
                torch.from_numpy(Y).to(DEV),
                None if mask is None else torch.from_numpy(mask).to(DEV),
                Mp=Mp, Np=Np, bm=bm, packed=None)
            check(binary, "staging f32-device declined binary operands")
            return Y1, Y2
        operands = [binary_as_uint8(A) for A in driver._masked_operands(Y, mask)
                    if A is not None]
        check(all(U is not None for U in operands), f"staging {how} declined binary operands")
        if how == "host":
            out = [torch.from_numpy(_pack_host(U, Mp, Np, bm)).to(DEV) for U in operands]
        else:
            out = [_pack_tensor(torch.from_numpy(U).to(DEV), Mp, Np, bm) for U in operands]
        return out[0], out[1] if mask is not None else None
    from nbmf_mm_tpu_torch.utils.validation import check_array

    m, n = X.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    X64, check_s = timed(lambda: check_array(X, accept_sparse="csr", dtype=np.float64))
    _, range_s = timed(lambda: bool(np.all((X64 >= 0) & (X64 <= 1))))
    _, cast_s = timed(lambda: np.asarray(X64, dtype=np.float32))
    del X64
    _, host_scan_s = timed(lambda: binary_as_uint8(X))
    Xd, copy_s = timed(lambda: torch.from_numpy(X).to(DEV))
    _, dev_scan_s = timed(lambda: driver._exactly_binary(Xd))
    del Xd
    _, loop_s = timed(lambda: solve(pm, HEADLINE["k"], max_iter=FIT_SWEEPS, tol=0.0,
                                    random_state=0, device_results=True, device=DEV))
    print(f"set-up: NBMF.fit's check_array to float64 {check_s:.3f} s, its [0,1] range check "
          f"{range_s:.3f} s, solve's cast back to float32 {cast_s:.3f} s; binary scan on the "
          f"host (binary_as_uint8) {host_scan_s:.3f} s, on the card {dev_scan_s:.4f} s; the "
          f"{X.nbytes / 1e6:.0f} MB pageable float32 copy {copy_s:.3f} s; {FIT_SWEEPS}-sweep "
          f"solve on words already on the card (inits, loop, safeguard) {loop_s:.3f} s "
          f"[{card}]", flush=True)
    mask = (np.random.default_rng(12).random((m, n)) < 0.8).astype(np.float32)
    for label, mk in (("unmasked", None), ("parity-masked", mask)):
        words, lines = {}, []
        for how in HOST_STAGINGS:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, seconds = timed(lambda: stage(X, mk, how))
            peak = torch.cuda.max_memory_allocated() - base
            words[how] = out
            lines.append(f"{how} {seconds:.3f} s, peak {peak / 1e6:.1f} MB")
        first = words[HOST_STAGINGS[0]]
        same = all(torch.equal(a, b) for w in words.values() for a, b in zip(w, first)
                   if a is not None)
        print(f"set-up: staging the {label} headline matrix from host numpy to words on the "
              f"card: {'; '.join(lines)}; identical words {same}; solve uses "
              f"{HOST_STAGINGS[0]!r} [{card}]", flush=True)
        check(same, f"the {label} stagings give different words")
        del words, first


def packed_input_phase(NBMF, solve, X, lastfm, lastfm_mask, binary_est, binary_params,
                       binary_wall, dense_solves, card, cs, ds, errors) -> dict:
    """Phase 8.  Returns the launches per kernel, summed over its runs, each
    counted with the counters set to 0 just before and read just after."""
    import scipy.sparse as sp

    total = {}
    S, csr_s = timed(lambda: sp.csr_matrix(X))
    print(f"input: the headline matrix as scipy.sparse CSR: {S.nnz} stored entries, built in "
          f"{csr_s:.2f} s [{card}]", flush=True)
    pm = input_fits(NBMF, X, S, binary_est, binary_params, binary_wall, total, card, cs, ds)
    input_packers(solve, X, S, pm, dense_solves["headline"], total, card, cs, ds)
    input_sparse_masked(solve, lastfm, lastfm_mask, dense_solves, total, card, cs, ds)
    input_contract_errors(solve, X, S, pm, card)
    del S
    setup_breakdown(solve, X, pm, card, cs)
    del pm
    scale_run(solve, total, card, cs, ds, errors)
    return total


def lane_factors(m, n, k, Mp, Np, lanes, seed):
    """``lanes`` random pairs (W, H) on the card at the solver's padded
    geometry, stacked: ``W (lanes, k, Mp)``, ``H (lanes, k, Np)``."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    W = torch.zeros((lanes, k, Mp), device=DEV)
    W[:, :, :m] = torch.rand((lanes, k, m), generator=gen, device=DEV) * 0.8 + 0.1
    W[:, :, :m] /= W[:, :, :m].sum(dim=1, keepdim=True)
    H = torch.zeros((lanes, k, Np), device=DEV)
    H[:, :, :n] = torch.rand((lanes, k, n), generator=gen, device=DEV) * 0.8 + 0.1
    return W, H


def batched_calls(o, d, cs, ds):
    """The five production wrappers on the binary operands ``o`` (K1, K2) and
    the dense operands ``d``, each as (call on (W, H), plain version on one
    pair)."""
    kh = dict(eps=EPS, m_real=o["m"], n_real=o["n"])
    kw = dict(eps=EPS, n_real=o["n"])
    bm = o["bm"]
    return {
        "hloss_terms_packed": (
            lambda W, H: cs.hloss_terms_packed(W, H, o["words"], o["words2_h"], bm=bm, **kh),
            lambda W, H: cs.hloss_terms_packed_plain(W, H, o["words"], o["words2_h"], bm=bm,
                                                     **kh)),
        "w_terms_packed": (
            lambda W, H: cs.w_terms_packed(W, H, o["words"], o["words2_w"], bm=bm, **kw),
            lambda W, H: cs.w_terms_packed_plain(W, H, o["words"], o["words2_w"], bm=bm, **kw)),
        "hloss_terms": (
            lambda W, H: ds.hloss_terms(W, H, d["Ym"], d["Yc"], bm=bm, **kh),
            lambda W, H: ds.hloss_terms_plain(W, H, d["Ym"], d["Yc"], **kh)),
        "w_terms": (
            lambda W, H: ds.w_terms(W, H, d["Ym"], d["Ym2"], bm=bm, **kw),
            lambda W, H: ds.w_terms_plain(W, H, d["Ym"], d["Ym2"], **kw)),
        "loglik_sum": (
            lambda W, H: ds.loglik_sum(W, H, d["Ym"], d["Yc"], bm=bm, **kh),
            lambda W, H: ds.loglik_sum_plain(W, H, d["Ym"], d["Yc"], **kh)),
    }


def check_batched_kernels(label, Y, soft, k, lane_counts, card, cs, ds, errors):
    """The five production kernels with a lane axis, in all three mask modes:
    lane ``r`` of a batched call equals the unbatched kernel on
    ``(W[r], H[r])`` bitwise, and the last lane is held against the plain
    version.  K1 and K2 on the binary ``Y``, the dense kernels on the
    [0,1]-valued ``soft`` under a weighted mask."""
    m, n = Y.shape
    for mode in MODES:
        o = operands(Y, k, mode, 20, cs)
        d = operands(soft, k, mode, 21, cs, weighted=True)
        bm, Mp, Np = cs.plan_packing(m, n)
        for lanes in lane_counts:
            W, H = lane_factors(m, n, k, Mp, Np, lanes, 22 + lanes)
            same, worst, worst_ll = True, 0.0, 0.0
            for name, (call, plain) in batched_calls(o, d, cs, ds).items():
                got = as_tuple(call(W, H))
                torch.cuda.synchronize()
                for out in got:
                    check(out.shape[0] == lanes, f"{name}: output without the lane axis")
                for r in range(lanes):
                    one = as_tuple(call(W[r], H[r]))
                    same &= all(torch.equal(g[r], u) for g, u in zip(got, one))
                for g, w in zip(got, as_tuple(plain(W[-1], H[-1]))):
                    if w.numel() == 1:
                        worst_ll = max(worst_ll, rel_ll(g[-1], w))
                    else:
                        worst = max(worst, rel(g[-1], w))
                    errors[name] = max(errors[name], abs_err(g[-1], w))
            print(f"lanes {label} {m}x{n} k={k} {mode} R={lanes}: K1, K2, dense H, dense W, "
                  f"loglik_sum: every lane == the unbatched kernel bitwise {same}; last lane "
                  f"against plain: max rel err {worst:.3e} (bound {TOL_TERMS:g} of "
                  f"max|plain|), ll {worst_ll:.3e} (bound {TOL_LL:g}) [{card}]", flush=True)
            check(same, f"lanes {label} {mode} R={lanes}: a lane differs from the unbatched kernel")
            check(worst <= TOL_TERMS and worst_ll <= TOL_LL,
                  f"lanes {label} {mode} R={lanes}: a batched kernel disagrees with plain")


def restart_main_path(NBMF, solve, X, card, cs, ds):
    """The restart path at full width: ``NBMF.fit`` with 16 restarts on the
    headline binary matrix as one batched solve, then the best lane again as
    a standalone solve from that lane's inits."""
    from nbmf_mm_tpu_torch.solver.driver import _random_uniform_inits

    k, R, sweeps = HEADLINE["k"], LANES_TIMED, RESTART_SWEEPS
    m, n = X.shape
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(cs, ds)
    est, wall = timed(lambda: NBMF(n_components=k, n_init=R, max_iter=sweeps, tol=0.0,
                                   random_state=0, dtype="float32", device=DEV).fit(X))
    launches, lanes = read_counts(cs, ds), read_lanes(cs, ds)
    peak = torch.cuda.max_memory_allocated()
    res = est.solver_result_
    finals = res.all_final_losses
    bm, Mp, Np = cs.plan_packing(m, n)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    split = cs.plan_h_split(Mp, Np, k, n_sm)
    scratch = 2 * R * int(np.prod(split.scratch)) * 4 + R * k * Mp * 4
    print(f"main path (restarts): NBMF.fit n_init={R} {m}x{n} k={k} f32, {sweeps} sweeps at "
          f"tol=0: {wall:.2f} s wall, {R * est.n_iter_ / wall:.1f} restart-sweeps/s set-up "
          f"included; best restart {res.best_restart}, final losses {finals.min():.6f} to "
          f"{finals.max():.6f}; launches {launches}, lanes {lanes}; peak device memory "
          f"{peak / 1e6:.1f} MB ({held / 1e6:.1f} MB held before), of which the H pass's "
          f"scratch of one call (two partial buffers over {split.nsplit} chunks and W's "
          f"bit-plane copies) is {scratch / 1e6:.1f} MB [{card}]", flush=True)
    check(res.extras == {"backend": "fused", "packed": True}, f"restart fit took {res.extras}")
    check(launches["hloss_terms_packed"] == sweeps + 1 and launches["w_terms_packed"] == sweeps,
          f"restart fit: launches {launches}")
    check(lanes["hloss_terms_packed"] == R * (sweeps + 1)
          and lanes["w_terms_packed"] == R * sweeps, f"restart fit: lanes {lanes}")
    check(launches["hloss_terms"] == launches["w_terms"] == launches["loglik_sum"] == 0,
          "the restart fit launched a dense kernel")
    check(finals.shape == (R,) and np.isfinite(finals).all(), "restart fit: final losses")
    check(res.best_restart == int(np.argmin(finals)), "restart fit: best_restart is not argmin")
    check(est.n_iter_ == sweeps and est.loss_curve_[-1] == finals.min(),
          "restart fit: loss_curve_ does not end at the lowest final loss")
    check_fit("restart fit", est, np.asarray(est.loss_curve_), card)

    best = res.best_restart
    W0, H0 = _random_uniform_inits(0, R, m, n, k, torch.float32)
    zero_counts(cs, ds)
    one = solve(X, k, W_init=W0[best].numpy(), H_init=H0[best].numpy(), max_iter=sweeps, tol=0.0,
                dtype="float32", device=DEV)
    add = read_counts(cs, ds)
    del W0, H0
    loss_diff = float(np.max(np.abs(np.asarray(one.losses) - np.asarray(est.loss_curve_))
                             / np.abs(np.asarray(one.losses))))
    w_diff = float(np.abs(one.W - est.W_).max())
    h_diff = float(np.abs(one.H - est.components_).max())
    bitwise = (one.losses == list(est.loss_curve_) and np.array_equal(one.W, est.W_)
               and np.array_equal(one.H, est.components_))
    print(f"restarts: lane {best} again as a standalone solve from its inits: n_iter "
          f"{one.n_iter} / {est.n_iter_}, losses max rel diff {loss_diff:.3e} (bound 1e-6), "
          f"max |W diff| {w_diff:.3e}, max |H diff| {h_diff:.3e} (bound 1e-5); bitwise equal "
          f"{bitwise} [{card}]", flush=True)
    check(one.n_iter == est.n_iter_, "restart lane: n_iter differs from the standalone solve")
    check(loss_diff <= 1e-6 and max(w_diff, h_diff) <= 1e-5,
          "restart lane differs from its standalone solve")
    return ({name: launches[name] + add[name] for name in launches}, lanes, wall, peak)


def return_all_dir_beta(solve, lastfm, mask, card, cs, ds):
    """``return_all`` under dir-beta on masked lastfm: every restart's factors
    in external notation."""
    R, k = 4, PAPER_LASTFM_K
    m, n = lastfm.shape
    zero_counts(cs, ds)
    res = solve(lastfm, k, n_init=R, return_all=True, orientation="dir-beta", mask=mask,
                max_iter=200, random_state=0, dtype="float32", device=DEV)
    launches, lanes = read_counts(cs, ds), read_lanes(cs, ds)
    ex = res.extras
    shapes = {name: ex[name].shape for name in ("all_W", "all_H", "all_n_iter", "all_losses",
                                                "all_converged")}
    sums = float(np.abs(ex["all_H"].sum(axis=1) - 1).max())
    print(f"restarts: solve(lastfm, {k}, n_init={R}, return_all=True, dir-beta, parity mask): "
          f"n_iter {res.n_iter}, all_n_iter {ex['all_n_iter'].tolist()}, best "
          f"{res.best_restart}, extras {shapes}; max |column sum of all_H - 1| {sums:.2e}; "
          f"all_W[best] == W {np.array_equal(ex['all_W'][res.best_restart], res.W)}; launches "
          f"{launches}, lanes {lanes} [{card}]", flush=True)
    check(shapes == {"all_W": (R, m, k), "all_H": (R, k, n), "all_n_iter": (R,),
                     "all_losses": (R, 200), "all_converged": (R,)}, f"return_all: {shapes}")
    check(all(isinstance(ex[name], np.ndarray) for name in shapes), "return_all: not numpy")
    check(sums <= 1e-5, "return_all dir-beta: columns of all_H do not sum to 1")
    check(np.array_equal(ex["all_W"][res.best_restart], res.W), "return_all: all_W[best] != W")
    check(res.n_iter == ex["all_n_iter"][res.best_restart], "return_all: n_iter of the best")
    check(lanes["hloss_terms_packed"] == R * launches["hloss_terms_packed"] > 0,
          "return_all: K1 lanes")
    return launches, lanes


def dense_restart_fit(NBMF, P, card, cs, ds):
    """A restart fit on the [0,1]-valued mean matrix: the dense H and W
    kernels and the ``loglik_sum`` fill with 4 lanes."""
    R, sweeps = 4, 20
    zero_counts(cs, ds)
    est, wall = timed(lambda: NBMF(n_components=HEADLINE["k"], n_init=R, max_iter=sweeps,
                                   tol=0.0, random_state=0, dtype="float32", device=DEV).fit(P))
    launches, lanes = read_counts(cs, ds), read_lanes(cs, ds)
    finals = est.solver_result_.all_final_losses
    print(f"main path (dense restarts): NBMF.fit n_init={R} on the mean matrix, {sweeps} "
          f"sweeps: {wall:.2f} s wall; best restart {est.solver_result_.best_restart}, final "
          f"losses {finals.min():.6f} to {finals.max():.6f}; launches {launches}, lanes "
          f"{lanes} [{card}]", flush=True)
    check(est.solver_result_.extras == {"backend": "fused", "packed": False},
          f"dense restart fit took {est.solver_result_.extras}")
    check(launches["hloss_terms"] == sweeps and launches["w_terms"] == sweeps
          and launches["loglik_sum"] == 1, f"dense restart fit: launches {launches}")
    check(lanes["hloss_terms"] == R * sweeps and lanes["w_terms"] == R * sweeps
          and lanes["loglik_sum"] == R, f"dense restart fit: lanes {lanes}")
    check(launches["hloss_terms_packed"] == launches["w_terms_packed"] == 0,
          "the dense restart fit launched packed kernels")
    check(np.isfinite(finals).all() and est.loss_curve_[-1] == finals.min(),
          "dense restart fit: final losses")
    check_fit("dense restart fit", est, np.asarray(est.loss_curve_), card)
    return launches, lanes


def grid_phase(grid_solve, solve, lastfm, mask, X, card, cs, ds):
    """The paper reproduction's 6 x 6 grid on masked lastfm as one 36-lane
    solve, two cells held against standalone solves; then a 4-cell zip grid
    at the headline."""
    k, sweeps = PAPER_LASTFM_K, 200
    zero_counts(cs, ds)
    g, wall = timed(lambda: grid_solve(lastfm, k, PAPER_GRID, PAPER_GRID, mask=mask,
                                       max_iter=sweeps, dtype="float32", device=DEV))
    launches, lanes = read_counts(cs, ds), read_lanes(cs, ds)
    cells = len(PAPER_GRID) ** 2
    m, n = lastfm.shape
    rises = max(float(np.max(np.diff(g["losses"][c, :g["n_iter"][c]])
                             / np.abs(g["losses"][c, :g["n_iter"][c] - 1])))
                for c in range(cells))
    print(f"grid: grid_solve(lastfm, {k}, 6 x 6 of {PAPER_GRID}, parity mask, max_iter "
          f"{sweeps}): {cells} cells in one solve, {wall:.2f} s wall; n_iter "
          f"{int(g['n_iter'].min())} to {int(g['n_iter'].max())}, converged "
          f"{int(g['converged'].sum())} of {cells}, final losses {g['final_loss'].min():.6f} to "
          f"{g['final_loss'].max():.6f}; largest relative rise of a cell's loss {rises:.2e} "
          f"(bound 1e-6); launches {launches}, lanes {lanes} [{card}]", flush=True)
    check(g["W"].shape == (cells, m, k) and g["H"].shape == (cells, k, n)
          and g["losses"].shape == (cells, sweeps) and g["alpha"].shape == (cells,),
          "grid: shapes")
    check(all(np.isfinite(g[name]).all() for name in ("W", "H", "final_loss")), "grid: finite")
    check(rises <= 1e-6, "grid: a cell's losses rise")
    check(lanes["hloss_terms_packed"] == cells * launches["hloss_terms_packed"] > 0
          and lanes["w_terms_packed"] == cells * launches["w_terms_packed"] > 0,
          f"grid: lanes {lanes} for launches {launches}")
    for c in (1, cells - 2):  # (0.5, 1.0) and (3.0, 2.5)
        one = solve(lastfm, k, alpha=float(g["alpha"][c]), beta=float(g["beta"][c]), mask=mask,
                    max_iter=sweeps, random_state=0, dtype="float32", device=DEV)
        w_diff = float(np.abs(g["W"][c] - one.W).max())
        print(f"grid: cell {c} (alpha {g['alpha'][c]}, beta {g['beta'][c]}) against the "
              f"standalone solve with the same seed: n_iter {int(g['n_iter'][c])} / "
              f"{one.n_iter}, max |W diff| {w_diff:.3e} (bound 1e-5), H bitwise equal "
              f"{np.array_equal(g['H'][c], one.H)} [{card}]", flush=True)
        check(int(g["n_iter"][c]) == one.n_iter, f"grid cell {c}: n_iter")
        check(w_diff <= 1e-5, f"grid cell {c}: W differs from the standalone solve")
    total = dict(launches)

    zips, steps = (0.8, 1.2, 1.6, 2.0), 10
    zero_counts(cs, ds)
    z, wall = timed(lambda: grid_solve(X, HEADLINE["k"], zips, zips[::-1], pair_mode="zip",
                                       max_iter=steps, tol=0.0, dtype="float32", device=DEV))
    launches, zlanes = read_counts(cs, ds), read_lanes(cs, ds)
    print(f"grid: grid_solve(headline, {HEADLINE['k']}, zip of {zips} with {zips[::-1]}, "
          f"{steps} sweeps): {wall:.2f} s wall, final losses {z['final_loss'].tolist()}; "
          f"launches {launches}, lanes {zlanes} [{card}]", flush=True)
    check(z["W"].shape == (4, X.shape[0], HEADLINE["k"]) and (z["n_iter"] == steps).all()
          and np.isfinite(z["final_loss"]).all(), "zip grid at the headline")
    check(launches["hloss_terms_packed"] == steps + 1 and launches["w_terms_packed"] == steps
          and zlanes["hloss_terms_packed"] == 4 * (steps + 1), "zip grid: launches")
    for name in total:
        total[name] += launches[name]
    return total, {name: lanes[name] + zlanes[name] for name in lanes}


def time_batched(X, P, k, times, loops, card, cs, ds):
    """ms per call and per lane of the five batched kernels at the headline
    with 16 lanes, beside the unbatched ms and the batched bound (16 times
    the unbatched operations; bytes with the data counted once); then the
    batched fused loops beside 16 unbatched sweeps."""
    R = LANES_TIMED
    o = operands(X, k, "unmasked", 2, cs)
    d = operands(P, k, "unmasked", 2, cs, weighted=True)
    m, n, bm = o["m"], o["n"], o["bm"]
    _, Mp, Np = cs.plan_packing(m, n)
    W, H = lane_factors(m, n, k, Mp, Np, R, 4)
    mnk = m * n * k
    factors_b, num_den_b, T_b = tensor_bytes(W, H), 2 * tensor_bytes(H), tensor_bytes(W)
    work = {"hloss_terms_packed": (6, o["words"], num_den_b + 4 * R),
            "w_terms_packed": (6, o["words"], T_b),
            "hloss_terms": (6, d["Ym"], num_den_b + 4 * R),
            "w_terms": (6, d["Ym"], T_b),
            "loglik_sum": (2, d["Ym"], 4 * R)}
    calls = batched_calls(o, d, cs, ds)
    for name, (products, data, out_bytes) in work.items():
        ms = cuda_ms(lambda: calls[name][0](W, H), reps=3)
        bound_ms, bound_by = bound(R * products * mnk, factors_b + tensor_bytes(data) + out_bytes)
        times[name].update(batched_ms=ms, batched_bound_ms=bound_ms)
        one = times[name]["ms"]
        print(f"timing {name} at {m}x{n} k={k} with {R} lanes: {ms:.4f} ms/call, "
              f"{ms / R:.4f} ms/lane beside {one:.4f} ms unbatched ({100 * ms / R / one:.1f}%); "
              f"{R * products * mnk / ms / 1e9:.2f} TFLOP/s, {100 * bound_ms / ms:.1f}% of its "
              f"{bound_ms:.4f} ms bound ({bound_by}) [{card}]", flush=True)
    del o, d, W, H
    for name, Y, packed in (("binary", X, True), ("dense", P, False)):
        per = loop_ms_per_sweep(name, Y, k, packed, card, cs, lanes=R, runs=(3, 13))
        print(f"timing batched fused loop ({name}): {per:.3f} ms/sweep for {R} lanes = "
              f"{per / R:.3f} ms per lane-sweep beside {loops[name]:.3f} ms/sweep unbatched "
              f"({R} x = {R * loops[name]:.3f}); {1e3 * R / per:.1f} restart-sweeps/s "
              f"[{card}]", flush=True)


def restarts_and_grids_phase(NBMF, solve, grid_solve, X, P, lastfm, lastfm_soft, tiny,
                             lastfm_mask, times, loops, card, cs, ds, errors):
    """Phase 9.  Returns (launches, lanes) per kernel, summed over its runs,
    each counted with the counters set to 0 just before and read just after."""
    k = HEADLINE["k"]
    check_batched_kernels("headline", X, P, k, (LANES_CHECKED,), card, cs, ds, errors)
    # The warp-specialised H pass at the shape the K=256 restart cell gives it.
    check_batched_kernels("headline k=256", X, P, 256, (LANES_TIMED,), card, cs, ds, errors)
    for label, shape, rank in LANE_EDGES:
        if shape is None:
            Y, soft = lastfm, lastfm_soft
        elif shape == tiny.shape:
            Y, soft = tiny, tiny * 0.5 + 0.25
        else:
            rng = np.random.default_rng(sum(shape) + rank)
            Y = (rng.random(shape) < 0.3).astype(np.float32)
            soft = rng.random(shape).astype(np.float32)
        check_batched_kernels(label, Y, soft, rank, LANE_EDGE_COUNTS, card, cs, ds, errors)
    runs = [restart_main_path(NBMF, solve, X, card, cs, ds)[:2],
            return_all_dir_beta(solve, lastfm, lastfm_mask, card, cs, ds),
            dense_restart_fit(NBMF, P, card, cs, ds),
            grid_phase(grid_solve, solve, lastfm, lastfm_mask, X, card, cs, ds)]
    launches = {name: sum(run[0][name] for run in runs) for name in PATH_KERNELS}
    lanes = {name: sum(run[1][name] for run in runs) for name in PATH_KERNELS}
    for name in PATH_KERNELS:
        check(lanes[name] > launches[name] > 0,
              f"{name}: phase 9 launched it {launches[name]} times with {lanes[name]} lanes")
    time_batched(X, P, k, times, loops, card, cs, ds)
    return launches, lanes


def tier_calls(o, form, cs, ds):
    """The production wrappers under ``form`` on the operands ``o`` (its
    dense operands cast to bf16 for the bf16-data form; K1 and K2 where ``o``
    has words and the form packs), each as ``(call on (W, H), plain version
    on (W, H))``, keyed by the form's counter name."""
    prec, bm = FORM_PRECISION[form], o["bm"]
    kh = dict(eps=EPS, m_real=o["m"], n_real=o["n"], precision=prec)
    kw = dict(eps=EPS, n_real=o["n"], precision=prec)
    cast = (lambda A: None if A is None else A.to(torch.bfloat16)) if form == "bf16d" else (
        lambda A: A)
    Ym, Yc, Ym2 = cast(o["Ym"]), cast(o["Yc"]), cast(o["Ym2"])
    calls = {}
    if "words" in o and form != "bf16d":
        w, w2h, w2w = o["words"], o["words2_h"], o["words2_w"]
        calls[f"hloss_terms_packed_{form}"] = (
            lambda W, H: cs.hloss_terms_packed(W, H, w, w2h, bm=bm, **kh),
            lambda W, H: cs.hloss_terms_packed_plain(W, H, w, w2h, bm=bm, **kh))
        calls[f"w_terms_packed_{form}"] = (
            lambda W, H: cs.w_terms_packed(W, H, w, w2w, bm=bm, **kw),
            lambda W, H: cs.w_terms_packed_plain(W, H, w, w2w, bm=bm, **kw))
    calls[f"hloss_terms_{form}"] = (lambda W, H: ds.hloss_terms(W, H, Ym, Yc, bm=bm, **kh),
                                    lambda W, H: ds.hloss_terms_plain(W, H, Ym, Yc, **kh))
    calls[f"w_terms_{form}"] = (lambda W, H: ds.w_terms(W, H, Ym, Ym2, bm=bm, **kw),
                                lambda W, H: ds.w_terms_plain(W, H, Ym, Ym2, **kw))
    calls[f"loglik_sum_{form}"] = (lambda W, H: ds.loglik_sum(W, H, Ym, Yc, bm=bm, **kh),
                                   lambda W, H: ds.loglik_sum_plain(W, H, Ym, Yc, **kh))
    calls[f"h_terms_{form}"] = (
        lambda W, H: ds.h_terms(W, H, Ym, Yc, eps=EPS, bm=bm, precision=prec),
        lambda W, H: ds.h_terms_plain(W, H, Ym, Yc, eps=EPS, precision=prec))
    return calls


def check_tier_kernels(label, Y, soft, k, card, cs, ds, errors):
    """Every operand form of the production kernels at one shape, in all
    three mask modes, on the binary ``Y`` and on the [0,1]-valued ``soft``
    under a weighted mask: against the plain versions, launched twice for
    bitwise repeatability; on binary data dense == packed in each tier, the
    bf16-data H pass and loglik_sum == the DEFAULT tier's over f32 data, and
    the bf16-data W pass == the DEFAULT tier's where H is bf16-representable
    (the two rules for 1 - h then agree), all bitwise."""
    m, n = Y.shape
    worst = {form: [0.0, 0.0] for form in TIER_FORMS}
    repeat = same = True
    for mode in MODES:
        o = operands(Y, k, mode, 30, cs)
        d = operands(soft, k, mode, 31, cs, weighted=True)
        for form in TIER_FORMS:
            for ops in (o, d):
                for name, (call, plain) in tier_calls(ops, form, cs, ds).items():
                    got, again = as_tuple(call(ops["W"], ops["H"])), as_tuple(call(ops["W"],
                                                                                   ops["H"]))
                    torch.cuda.synchronize()
                    for g, w in zip(got, as_tuple(plain(ops["W"], ops["H"]))):
                        if w.numel() == 1:
                            worst[form][1] = max(worst[form][1], rel_ll(g, w))
                        else:
                            worst[form][0] = max(worst[form][0], rel(g, w))
                        errors[name] = max(errors[name], abs_err(g, w))
                    repeat &= all(map(torch.equal, got, again))
            if form != "bf16d":
                c = {name.removesuffix("_" + form): call(o["W"], o["H"])
                     for name, (call, _) in tier_calls(o, form, cs, ds).items()}
                same &= all(map(torch.equal, c["hloss_terms"], c["hloss_terms_packed"]))
                same &= torch.equal(c["w_terms"], c["w_terms_packed"])
                same &= torch.equal(c["loglik_sum"], c["hloss_terms_packed"][2])
                same &= all(map(torch.equal, c["h_terms"], c["hloss_terms"][:2]))
        r = tier_calls(o, "bf16r", cs, ds)
        b = tier_calls(o, "bf16d", cs, ds)
        for base in ("hloss_terms", "loglik_sum", "h_terms"):
            same &= all(map(torch.equal, as_tuple(b[f"{base}_bf16d"][0](o["W"], o["H"])),
                            as_tuple(r[f"{base}_bf16r"][0](o["W"], o["H"]))))
        Hb = o["H"].to(torch.bfloat16).float()
        same &= torch.equal(b["w_terms_bf16d"][0](o["W"], Hb), r["w_terms_bf16r"][0](o["W"], Hb))
    bars = ", ".join(f"{form} {worst[form][0]:.3e} / ll {worst[form][1]:.3e}" for form in TIER_FORMS)
    print(f"tiers {label} {m}x{n} k={k}: the forms' kernels (binary, weighted [0,1]) in "
          f"{'/'.join(MODES)} against plain: max rel err {bars} (bounds {TOL_TIER_TERMS:g} of "
          f"max|plain|, ll {TOL_TIER_LL:g}); bitwise repeat {repeat}; dense == packed, "
          f"loglik_sum == the H pass's ll, h_terms == its Num/Den per tier, bf16-data "
          f"H/loglik_sum/h_terms == DEFAULT's, bf16-data W == DEFAULT's at bf16-representable "
          f"H, bitwise {same} [{card}]", flush=True)
    check(all(t <= TOL_TIER_TERMS and ll <= TOL_TIER_LL for t, ll in worst.values()),
          f"tiers {label}: a form's kernel disagrees with plain {worst}")
    check(repeat, f"tiers {label}: outputs differ between two launches")
    check(same, f"tiers {label}: a bitwise equality of the forms failed")


def check_wgmma_staging(card, cs):
    """The copies the tensor-core forms stage against their plain versions
    on the same values, bitwise: the bf16 copies (W in bit-plane order, H,
    and 1 - H by each form's rule; ``cs.stage_bf16``) and the TF32 copies
    in both orders (W^T, W's phase-B copy, H^T, H's and 1 - H's phase-B
    copies; ``cs.stage_tf32``), at the headline, at lastfm, at ranks that
    pad k (17, 200, 256) and at one word row, with H spread over [-0.3, 1.4]
    so that 1 - h needs rounding, and with 4 lanes."""
    h = HEADLINE
    shapes = [((h["m"], h["n"]), h["k"], 1), ((1226, 285), PAPER_LASTFM_K, 1),
              ((1000, 1234), 17, 1), ((1000, 1234), 200, 1), ((1000, 1234), 256, 4),
              ((20, 1000), 8, 1)]
    same = same_tf32 = True
    for (m, n), k, lanes in shapes:
        bm, Mp, Np = cs.plan_packing(m, n)
        pairs = [factors(m, n, k, Mp, Np, 40 + r) for r in range(lanes)]
        W = torch.stack([w for w, _ in pairs]) if lanes > 1 else pairs[0][0]
        H = (torch.stack([x for _, x in pairs]) if lanes > 1 else pairs[0][1]) * 1.7 - 0.3
        for form in cs.WGMMA_FORMS:
            got = cs.stage_bf16(W, H, bm, form)
            want = cs.stage_bf16(W.cpu(), H.cpu(), bm, form)
            same &= all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        got, want = cs.stage_tf32(W, H, bm), cs.stage_tf32(W.cpu(), H.cpu(), bm)
        same_tf32 &= all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    print(f"tiers: the staging of the tensor-core forms at {len(shapes)} shapes, k 8 to 256, "
          f"lanes 1 and 4, == plain bitwise: bf16 (W bit-plane, H, 1 - H by each form's rule) "
          f"{same}, TF32 (W^T, W, H^T, H, 1 - H; the phase-B copies in slot8 order) {same_tf32} "
          f"[{card}]", flush=True)
    check(same, "tiers: a bf16 staging copy differs from its plain version")
    check(same_tf32, "tiers: a TF32 staging copy differs from its plain version")


def check_tier_lanes(X, P, k, card, cs, ds, errors):
    """Each form's five production kernels with ``LANES_CHECKED`` lanes at the
    headline, in all three mask modes: every lane == the unbatched kernel
    bitwise, the last lane against the plain version."""
    m, n = X.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    W, H = lane_factors(m, n, k, Mp, Np, LANES_CHECKED, 32)
    same, worst, worst_ll = True, 0.0, 0.0
    for mode in MODES:
        o = operands(X, k, mode, 33, cs)
        d = operands(P, k, mode, 34, cs, weighted=True)
        for form in TIER_FORMS:
            calls = {**tier_calls(o, form, cs, ds), **{
                name: c for name, c in tier_calls(d, form, cs, ds).items() if "packed" not in name}}
            for name, (call, plain) in calls.items():
                if name.startswith("h_terms"):  # no lane axis
                    continue
                got = as_tuple(call(W, H))
                for r in range(LANES_CHECKED):
                    same &= all(torch.equal(g[r], u) for g, u in zip(got, as_tuple(call(W[r], H[r]))))
                for g, w in zip(got, as_tuple(plain(W[-1], H[-1]))):
                    if w.numel() == 1:
                        worst_ll = max(worst_ll, rel_ll(g[-1], w))
                    else:
                        worst = max(worst, rel(g[-1], w))
                    errors[name] = max(errors[name], abs_err(g[-1], w))
    print(f"tiers: lanes at {m}x{n} k={k} R={LANES_CHECKED} in {'/'.join(MODES)}, forms "
          f"{TIER_FORMS}: every lane == the unbatched kernel bitwise {same}; last lane against "
          f"plain: max rel err {worst:.3e} (bound {TOL_TIER_TERMS:g}), ll {worst_ll:.3e} (bound "
          f"{TOL_TIER_LL:g}) [{card}]", flush=True)
    check(same, "tiers: a lane differs from the unbatched kernel")
    check(worst <= TOL_TIER_TERMS and worst_ll <= TOL_TIER_LL, "tiers: a batched form disagrees")


def descends(losses, rel_rise: float) -> bool:
    """Finite losses, none above the one before by more than ``rel_rise`` of
    its size (a loss may be negative under a prior with alpha or beta < 1)."""
    losses = np.asarray(losses, dtype=np.float64)
    return bool(np.isfinite(losses).all()
                and np.all(np.diff(losses) <= rel_rise * np.abs(losses[:-1])))


def tier_count_check(what, launches, expected):
    """``expected`` {counter: launches}; every other counter must read 0."""
    wrong = {name: n for name, n in launches.items() if n != expected.get(name, 0)}
    check(not wrong, f"{what}: launches {wrong} against {expected}")


class CountingPackBits:
    """``cs.pack_bits`` wrapped to count its calls while the context is open."""

    def __init__(self, cs):
        self.cs, self.calls = cs, 0

    def __enter__(self):
        self.real = self.cs.pack_bits

        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        self.cs.pack_bits = counted
        return self

    def __exit__(self, *exc):
        self.cs.pack_bits = self.real


def bf16_fits(NBMF, X, P, model, card, cs, ds):
    """``NBMF(dtype="bfloat16").fit`` on the mean matrix (the dense bf16-data
    kernels and the loglik_sum fill, with the peak device memory beside a
    float32 fit's) and on the binary matrix (dense bf16 too, never packed)."""
    k = HEADLINE["k"]
    total = {}
    peaks = {}
    for dtype, sweeps in (("float32", 5), ("bfloat16", FIT_SWEEPS)):
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(cs, ds)
        with CountingPackBits(cs) as packs:
            est, wall = timed(lambda: NBMF(n_components=k, max_iter=sweeps, tol=0.0,
                                           random_state=0, dtype=dtype, device=DEV).fit(P))
        peaks[dtype] = torch.cuda.max_memory_allocated() - held
        if dtype == "float32":
            continue
        launches = read_counts(cs, ds)
        add_counts(total, cs, ds)
        losses = np.asarray(est.loss_curve_)
        print(f"tiers: NBMF(dtype='bfloat16').fit on the mean matrix {P.shape} k={k}, {sweeps} "
              f"sweeps at tol=0: {wall:.2f} s wall, loss {losses[0]:.9g} -> {losses[-1]:.9g} "
              f"(float32 fit: {model.loss_:.9g}, rel diff "
              f"{abs(losses[-1] - model.loss_) / abs(model.loss_):.3e}; max |W_ - W_ float32| "
              f"{np.abs(est.W_ - model.W_).max():.3e}); extras "
              f"{est.solver_result_.extras}; pack_bits calls {packs.calls}; peak device memory "
              f"{peaks['bfloat16'] / 1e6:.1f} MB beside {peaks['float32'] / 1e6:.1f} MB for the "
              f"float32 fit ({(peaks['float32'] - peaks['bfloat16']) / 1e6:.1f} MB less) "
              f"[{card}]", flush=True)
        check(est.solver_result_.extras == {"backend": "fused", "packed": False,
                                            "precision": "default", "data_dtype": "bfloat16"},
              f"bf16 dense fit took {est.solver_result_.extras}")
        tier_count_check("bf16 dense fit", launches, {"hloss_terms_bf16d": sweeps,
                                                      "w_terms_bf16d": sweeps,
                                                      "loglik_sum_bf16d": 1})
        check(packs.calls == 0, "the bf16 fit called pack_bits")
        check(est.n_iter_ == sweeps and descends(losses, TIER_DESCENT), "bf16 fit: losses")
        check(np.abs(est.W_.sum(axis=1) - 1).max() <= 1e-5
              and bool(((est.components_ > 0) & (est.components_ < 1)).all()), "bf16 fit: factors")
        check(peaks["bfloat16"] < peaks["float32"], "the bf16 fit peaks above the float32 fit")
        check(not np.array_equal(est.W_, model.W_), "the bf16 fit computed the float32 fit")

    zero_counts(cs, ds)
    with CountingPackBits(cs) as packs:
        est, wall = timed(lambda: NBMF(n_components=k, max_iter=FIT_SWEEPS, random_state=0,
                                       dtype="bfloat16", device=DEV).fit(X))
    launches = read_counts(cs, ds)
    add_counts(total, cs, ds)
    losses = np.asarray(est.loss_curve_)
    print(f"tiers: NBMF(dtype='bfloat16').fit on the binary matrix {X.shape} k={k}: n_iter "
          f"{est.n_iter_}, loss {losses[0]:.6f} -> {losses[-1]:.6f}, {wall:.2f} s wall; extras "
          f"{est.solver_result_.extras}; pack_bits calls {packs.calls}; launches "
          f"{ {n: c for n, c in launches.items() if c} } [{card}]", flush=True)
    check(est.solver_result_.extras["packed"] is False and packs.calls == 0,
          "the binary bf16 fit packed its data")
    n = est.n_iter_
    tier_count_check("bf16 binary fit", launches, {
        "hloss_terms_bf16d": launches["hloss_terms_bf16d"], "w_terms_bf16d": n,
        "loglik_sum_bf16d": launches["loglik_sum_bf16d"]})
    check(launches["hloss_terms_bf16d"] >= n > 0 and descends(losses, TIER_DESCENT),
          "bf16 binary fit: launches or losses")
    return total, peaks


def tier_solves(solve, X, card, cs, ds):
    """``solve(X, 128, precision=...)`` in the two reduced tiers, packed and
    dense, 100 sweeps at tol=0: the losses finite and descending within
    ``TIER_DESCENT``, packed == dense bitwise, the final loss beside the
    float32 solve's."""
    k, sweeps = HEADLINE["k"], FIT_SWEEPS
    kw = dict(max_iter=sweeps, tol=0.0, random_state=0, dtype="float32", device=DEV)
    ref = solve(X, k, **kw)
    total = {}
    for precision, form in (("default", "bf16r"), ("high", "tf32r")):
        runs = {}
        for packed in (None, False):
            zero_counts(cs, ds)
            res, wall = timed(lambda: solve(X, k, precision=precision, packed=packed, **kw))
            launches = read_counts(cs, ds)
            add_counts(total, cs, ds)
            runs[packed] = res
            loss = res.losses[-1]
            print(f"tiers: solve(headline, {k}, precision={precision!r}, packed={packed}), "
                  f"{sweeps} sweeps: {wall:.2f} s wall, final loss {loss:.9g} beside float32's "
                  f"{ref.losses[-1]:.9g} (rel diff {abs(loss - ref.losses[-1]) / ref.losses[-1]:.3e}; "
                  f"max |W - W float32| {np.abs(res.W - ref.W).max():.3e}); "
                  f"losses descend within {TIER_DESCENT:g} {descends(res.losses, TIER_DESCENT)}; "
                  f"extras {res.extras} [{card}]", flush=True)
            check(descends(res.losses, TIER_DESCENT) and res.n_iter == sweeps,
                  f"precision {precision}: losses")
            check(abs(loss - ref.losses[-1]) <= TIER_LOSS_REL * abs(ref.losses[-1]),
                  f"precision {precision}: the final loss is off float32's")
            check(res.extras.get("precision") == precision, f"precision {precision}: extras")
            check(not np.array_equal(res.W, ref.W), f"precision {precision}: the float32 solve")
            if packed is None:
                expected = {f"hloss_terms_packed_{form}": sweeps + 1,
                            f"w_terms_packed_{form}": sweeps}
            else:
                expected = {f"hloss_terms_{form}": sweeps, f"w_terms_{form}": sweeps,
                            f"loglik_sum_{form}": 1}
            tier_count_check(f"solve precision={precision} packed={packed}", launches, expected)
        a, b = runs[None], runs[False]
        same = a.losses == b.losses and np.array_equal(a.W, b.W) and np.array_equal(a.H, b.H)
        print(f"tiers: precision={precision!r} packed == dense bitwise {same} [{card}]", flush=True)
        check(same, f"precision {precision}: packed and dense solves differ")
    return total


class PlainDenseWPass:
    """``ds.w_terms`` replaced by its plain version while the context is
    open: the fold-in of a server whose kernel route has no plain route of
    the same numbers (the bf16-data W pass forms 1 - h from the bf16 h,
    where the plain fold-in keeps the data float32)."""

    def __init__(self, ds):
        self.ds = ds

    def __enter__(self):
        self.real = self.ds.w_terms
        self.ds.w_terms = lambda W, H, Ym, Ym2=None, *, eps, n_real, bm, precision=None: (
            self.ds.w_terms_plain(W, H, Ym, Ym2, eps=eps, n_real=n_real, precision=precision))
        return self

    def __exit__(self, *exc):
        self.ds.w_terms = self.real


def tier_serving(FoldInServer, model, requests, weighted, card, cs, ds):
    """``FoldInServer(model, precision="default")`` on the 8192-row binary
    request (K2 in the DEFAULT tier) and the weighted-mask request (the
    dense W pass in it), W against the plain fold-in of that tier; then
    ``dtype="bfloat16"`` on the weighted-mask request (the bf16-data W
    pass), W against the same server with the W pass's plain version."""
    top = SERVE_BUCKETS[-1]
    X_bin = next(X for X in requests if X.shape[0] == top)
    X_w, mask_w = weighted
    total = {}
    for kw, runs, expected in (
            (dict(precision="default"), ((X_bin, None), (X_w, mask_w)),
             {"w_terms_packed_bf16r": 50, "w_terms_bf16r": 50}),
            (dict(dtype="bfloat16"), ((X_w, mask_w),), {"w_terms_bf16d": 50})):
        server = FoldInServer(model, buckets=SERVE_BUCKETS, device=DEV, **kw)
        plain = FoldInServer(model, buckets=SERVE_BUCKETS, device=DEV, backend="plain", **kw)
        worst = 0.0
        zero_counts(cs, ds)
        served = [server.transform(X, mask=mask) for X, mask in runs]
        torch.cuda.synchronize()
        launches = read_counts(cs, ds)
        add_counts(total, cs, ds)
        tier_count_check(f"FoldInServer {kw}", launches, expected)
        for (W, sc), (X, mask) in zip(served, runs):
            if "dtype" in kw:
                with PlainDenseWPass(ds):
                    W_plain, _ = server.transform(X, mask=mask)
            else:
                W_plain, _ = plain.transform(X, mask=mask)
            check(np.isfinite(W).all() and np.isfinite(sc).all()
                  and np.abs(W.sum(axis=1) - 1).max() <= 1e-5, f"FoldInServer {kw}: output")
            worst = max(worst, float(np.abs(W - W_plain).max()))
        against = ("the same server on the W pass's plain version" if "dtype" in kw
                   else "the plain fold-in of the same tier")
        print(f"tiers: FoldInServer(model, {kw}) on {len(runs)} {top}-row request(s): launches "
              f"{ {n: c for n, c in launches.items() if c} }; W against {against}: max abs diff "
              f"{worst:.3e} (bound {TOL_FOLD_IN:g}) [{card}]", flush=True)
        check(worst <= TOL_FOLD_IN, f"FoldInServer {kw}: W disagrees with the plain fold-in")
        f32 = FoldInServer(model, buckets=SERVE_BUCKETS, device=DEV)
        for X, mask in runs:
            kind = "binary" if mask is None else "weighted-mask"
            ms = {label: request_ms(srv, X, mask) for label, srv in (("tier", server),
                                                                      ("float32", f32))}
            print(f"timing serving {kind} {top}-row request, FoldInServer({kw}): "
                  f"{ms['tier']:.1f} ms/request beside {ms['float32']:.1f} for float32 "
                  f"({100 * (ms['tier'] / ms['float32'] - 1):+.1f}%) [{card}]", flush=True)
    return total


def request_ms(server, X, mask, reps: int = 3) -> float:
    """Host wall time of one request (ends in a host copy), mean of ``reps``
    after a warm-up."""
    server.transform(X, mask=mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        server.transform(X, mask=mask)
    return (time.perf_counter() - t0) / reps * 1e3


def tier_grid_and_restarts(NBMF, grid_solve, X, lastfm, mask, card, cs, ds):
    """The 6 x 6 lastfm grid in the bf16-data mode (36 lanes on the bf16
    kernels) and under ``precision="high"`` (36 lanes on the TF32 kernels,
    every cell descending within ``TIER_DESCENT``), and ``NBMF(n_init=4,
    precision=...)`` at the headline under ``"default"`` and ``"high"`` (4
    lanes on K1/K2 in that tier)."""
    k, sweeps = PAPER_LASTFM_K, 200
    total = {}
    zero_counts(cs, ds)
    g, wall = timed(lambda: grid_solve(lastfm, k, PAPER_GRID, PAPER_GRID, mask=mask,
                                       max_iter=sweeps, dtype="bfloat16", device=DEV))
    launches, lanes = read_counts(cs, ds), read_lanes(cs, ds)
    add_counts(total, cs, ds)
    cells = len(PAPER_GRID) ** 2
    # Cells with beta < 1 push H to the clip, where bf16-rounded products let
    # the loss wobble: the largest rise is printed, not held to a bar.
    rises = max(float(np.max(np.diff(g["losses"][c, :g["n_iter"][c]].astype(np.float64))
                             / np.abs(g["losses"][c, :g["n_iter"][c] - 1]))) for c in range(cells))
    print(f"tiers: grid_solve(lastfm, {k}, 6 x 6, parity mask, dtype='bfloat16'): {wall:.2f} s "
          f"wall, n_iter {int(g['n_iter'].min())} to {int(g['n_iter'].max())}, final losses "
          f"{g['final_loss'].min():.6f} to {g['final_loss'].max():.6f}; largest relative rise of a "
          f"cell's loss {rises:.2e}; launches { {n: c for n, c in launches.items() if c} }, lanes "
          f"{ {n: c for n, c in lanes.items() if c} } [{card}]", flush=True)
    check(all(np.isfinite(g[name]).all() for name in ("W", "H", "final_loss"))
          and g["losses"].dtype == np.float32 and g["W"].shape[0] == cells, "bf16 grid")
    check(lanes["hloss_terms_bf16d"] == cells * launches["hloss_terms_bf16d"] > 0
          and lanes["w_terms_bf16d"] == cells * launches["w_terms_bf16d"] > 0
          and sum(launches.values()) == launches["hloss_terms_bf16d"]
          + launches["w_terms_bf16d"] + launches["loglik_sum_bf16d"], "bf16 grid: launches")

    zero_counts(cs, ds)
    g, wall = timed(lambda: grid_solve(lastfm, k, PAPER_GRID, PAPER_GRID, mask=mask,
                                       max_iter=sweeps, precision="high", dtype="float32",
                                       device=DEV))
    launches, lanes = read_counts(cs, ds), read_lanes(cs, ds)
    add_counts(total, cs, ds)
    curves = [g["losses"][c, :g["n_iter"][c]] for c in range(cells)]
    rises = max(float(np.max(np.diff(c.astype(np.float64)) / np.abs(c[:-1]))) for c in curves)
    used = {name: n for name, n in launches.items() if n}
    print(f"tiers: grid_solve(lastfm, {k}, 6 x 6, parity mask, precision='high'): {wall:.2f} s "
          f"wall, n_iter {int(g['n_iter'].min())} to {int(g['n_iter'].max())}, final losses "
          f"{g['final_loss'].min():.6f} to {g['final_loss'].max():.6f}; largest relative rise of a "
          f"cell's loss {rises:.2e} (bound {TIER_DESCENT:g}); launches {used}, lanes "
          f"{ {n: c for n, c in lanes.items() if c} } [{card}]", flush=True)
    check(all(np.isfinite(g[name]).all() for name in ("W", "H", "final_loss"))
          and all(descends(c, TIER_DESCENT) for c in curves), "TF32 grid: losses")
    check(used and all(name.endswith("_tf32r") for name in used)
          and all(lanes[name] == cells * n for name, n in used.items()
                  if name.startswith(("hloss_terms", "w_terms"))),
          "TF32 grid: launches")

    R, steps = 4, 20
    for precision, form in (("default", "bf16r"), ("high", "tf32r")):
        zero_counts(cs, ds)
        est, wall = timed(lambda: NBMF(n_components=HEADLINE["k"], n_init=R, max_iter=steps,
                                       tol=0.0, random_state=0, precision=precision,
                                       dtype="float32", device=DEV).fit(X))
        launches, lanes = read_counts(cs, ds), read_lanes(cs, ds)
        add_counts(total, cs, ds)
        finals = est.solver_result_.all_final_losses
        print(f"tiers: NBMF(n_init={R}, precision={precision!r}).fit(headline), {steps} sweeps: "
              f"{wall:.2f} s wall, final losses {finals.min():.6f} to {finals.max():.6f}, best "
              f"{est.solver_result_.best_restart}; launches "
              f"{ {n: c for n, c in launches.items() if c} }, lanes "
              f"{ {n: c for n, c in lanes.items() if c} } [{card}]", flush=True)
        tier_count_check(f"n_init=4 {precision}", launches,
                         {f"hloss_terms_packed_{form}": steps + 1, f"w_terms_packed_{form}": steps})
        check(lanes[f"hloss_terms_packed_{form}"] == R * (steps + 1)
              and lanes[f"w_terms_packed_{form}"] == R * steps and np.isfinite(finals).all()
              and descends(est.loss_curve_, TIER_DESCENT), f"n_init=4 {precision}: lanes or losses")
    return total


def tier_measurement_path(card, cs, ds):
    """``bench_kernels`` in each form (the measurement path, where h_terms
    runs), with the counters set to 0 before and read after."""
    zero_counts(cs, ds)
    mod = importlib.import_module("nbmf_mm_tpu_torch.tools.bench_kernels")
    for args in (["--precision", "default"], ["--precision", "high"], ["--dtype", "bfloat16"]):
        print(f"tiers: python -m nbmf_mm_tpu_torch.tools.bench_kernels --reps 1 {' '.join(args)} "
              f"[{card}]", flush=True)
        mod.main(["--reps", "1", *args])
    torch.cuda.synchronize()
    return read_counts(cs, ds)


def time_tier_kernels(X, P, k, times, card, cs, ds):
    """ms/call of each form at the headline beside its float32 instance and
    its bound at the form's tensor-core peak (``FORM_PEAK``: the float32
    instance's operations at 989 TFLOP/s for the bf16 forms, 495 for TF32;
    bf16 data halves the data bytes), with phase 7's time of the vpu_only
    probe (the ratio and log chain alone at 10240^2) beside it as the floor
    of the elementwise work: K1/K2 forms on the binary matrix's words, the
    dense forms on ``P`` (unmasked)."""
    o = operands(X, k, "unmasked", 2, cs)
    d = operands(P, k, "unmasked", 2, cs, weighted=True)
    m, n = o["m"], o["n"]
    W, H = o["W"], o["H"]
    mnk = m * n * k
    factors_b, num_den_b, T_b = tensor_bytes(W, H), 2 * tensor_bytes(H), tensor_bytes(W)
    out_b = {"hloss_terms": num_den_b + 4, "w_terms": T_b, "loglik_sum": 4, "h_terms": num_den_b}
    products = {"hloss_terms": 6, "w_terms": 6, "loglik_sum": 2, "h_terms": 6}
    f32 = {**{name: times[name]["ms"] for name in PATH_KERNELS},
           "h_terms": cuda_ms(lambda: ds.h_terms(W, H, d["Ym"], eps=EPS, bm=o["bm"]))}
    vpu_ms = times["make_kernel"]["variants"]["vpu_only"]["ms"]
    out = {}
    for form in TIER_FORMS:
        calls = {**tier_calls(o, form, cs, ds),
                 **{name: c for name, c in tier_calls(d, form, cs, ds).items()
                    if "packed" not in name}}
        for name, (fn, plain) in calls.items():
            base = name.removesuffix("_" + form)
            kind = base.removesuffix("_packed")
            data = o["words"] if base.endswith("_packed") else (
                d["Ym"].to(torch.bfloat16) if form == "bf16d" else d["Ym"])
            ms, plain_ms = cuda_ms(lambda: fn(W, H)), cuda_ms(lambda: plain(W, H))
            bound_ms, bound_by = bound(products[kind] * mnk,
                                       factors_b + tensor_bytes(data) + out_b[kind], FORM_PEAK[form])
            out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
            print(f"timing {name} at {m}x{n} k={k}: kernel {ms:.4f} ms/call beside "
                  f"{f32[base]:.4f} for the float32 instance ({100 * (ms / f32[base] - 1):+.1f}%), "
                  f"plain {plain_ms:.4f} ms/call; {100 * bound_ms / ms:.1f}% of its "
                  f"{bound_ms:.4f} ms bound ({bound_by}, {FORM_PEAK[form] / 1e12:g} TFLOP/s); "
                  f"the elementwise chain alone (vpu_only probe) {vpu_ms:.4f} ms [{card}]",
                  flush=True)
    return out


def tiers_phase(NBMF, solve, FoldInServer, grid_solve, X, P, lastfm, lastfm_soft, tiny,
                lastfm_mask, model, requests, weighted, times, loops, card, cs, ds, errors):
    """Phase 10: the precision tiers and the bf16-data mode.  Returns
    (launches, times) of each form in ``TIER_KERNELS``, the launches counted
    over the phase's paths with the counters set to 0 before each and read
    after it (h_terms' on the measurement path)."""
    k = HEADLINE["k"]
    check_wgmma_staging(card, cs)
    check_tier_kernels("headline", X, P, k, card, cs, ds, errors)
    check_tier_kernels("lastfm", lastfm, lastfm_soft, PAPER_LASTFM_K, card, cs, ds, errors)
    check_tier_kernels("one-word-row", tiny, tiny * 0.5 + 0.25, 4, card, cs, ds, errors)
    for label, (m, n), rank in (*W_EDGES, *H_EDGES):
        rng = np.random.default_rng(m + n + rank)
        check_tier_kernels(label, (rng.random((m, n)) < 0.3).astype(np.float32),
                           rng.random((m, n)).astype(np.float32), rank, card, cs, ds, errors)
    check_tier_lanes(X, P, k, card, cs, ds, errors)

    launches = {name: 0 for name in TIER_KERNELS}
    fits, peaks = bf16_fits(NBMF, X, P, model, card, cs, ds)
    for total in (fits, tier_solves(solve, X, card, cs, ds),
                  tier_serving(FoldInServer, model, requests, weighted, card, cs, ds),
                  tier_grid_and_restarts(NBMF, grid_solve, X, lastfm, lastfm_mask, card, cs, ds)):
        for name in launches:
            launches[name] += total.get(name, 0)
    measured = tier_measurement_path(card, cs, ds)
    for form in TIER_FORMS:
        launches[f"h_terms_{form}"] = measured[f"h_terms_{form}"]
    print(f"tiers: launches over phase 10's paths {launches} [{card}]", flush=True)
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched in phase 10")

    tier_times = time_tier_kernels(X, P, k, times, card, cs, ds)
    for precision in ("default", "high"):
        for name, Y, packed in (("binary", X, True), ("dense", P, False)):
            per = loop_ms_per_sweep(name, Y, k, packed, card, cs, precision=precision)
            print(f"timing fused loop ({name}) precision={precision!r}: {per:.3f} ms/sweep beside "
                  f"{loops[name]:.3f} for float32 ({100 * (per / loops[name] - 1):+.1f}%) "
                  f"[{card}]", flush=True)
    per = loop_ms_per_sweep("dense", P, k, False, card, cs, bf16=True)
    print(f"timing fused loop (dense) on bf16 data: {per:.3f} ms/sweep beside {loops['dense']:.3f} "
          f"for float32 data ({100 * (per / loops['dense'] - 1):+.1f}%) [{card}]", flush=True)
    return launches, tier_times


def nonzero(counts: dict) -> dict:
    return {name: n for name, n in counts.items() if n}


def deviation(a, b) -> dict:
    """max |dW|, max |dH| and the largest relative loss deviation of two
    fitted estimators with host attributes."""
    la, lb = np.asarray(a.loss_curve_), np.asarray(b.loss_curve_)
    return {"W": float(np.abs(np.asarray(a.W_) - np.asarray(b.W_)).max()),
            "H": float(np.abs(np.asarray(a.components_) - np.asarray(b.components_)).max()),
            "loss": float((np.abs(la - lb) / np.abs(lb)).max())}


def within_bars(dev: dict) -> bool:
    return all(dev[key] <= CKPT_BARS[key] for key in CKPT_BARS)


def checkpoint_paths(NBMF, X, request, workdir, total, card, cs, ds):
    """Phase 11 (a)-(d): ``fit_checkpointed``, ``save_model`` ->
    ``load_model`` -> ``transform``/``score``/``perplexity``, a
    ``device_results=True`` model saved and loaded, and ``resume_fit``, each
    with the counters zeroed before and added to ``total`` after."""
    from nbmf_mm_tpu_torch.utils import checkpoint as ckpt

    k = HEADLINE["k"]
    params = dict(n_components=k, max_iter=CKPT_SWEEPS, tol=0.0, random_state=0,
                  dtype="float32", device=DEV)
    writes = []
    real_save = ckpt.save_checkpoint

    def counting_save(*args, **kwargs):
        writes.append(int(args[4]))
        return real_save(*args, **kwargs)

    path = workdir / "segments.npz"
    zero_counts(cs, ds)
    ckpt.save_checkpoint = counting_save
    try:
        seg, seg_s = timed(lambda: ckpt.fit_checkpointed(NBMF(**params), X, path,
                                                         every=CKPT_EVERY))
    finally:
        ckpt.save_checkpoint = real_save
    seg_counts = read_counts(cs, ds)
    add_counts(total, cs, ds)
    zero_counts(cs, ds)
    ref, ref_s = timed(lambda: NBMF(**params).fit(X))
    add_counts(total, cs, ds)
    dev = deviation(seg, ref)
    stored = ckpt.load_checkpoint(path)
    n_seg = CKPT_SWEEPS // CKPT_EVERY
    print(f"checkpointed fit: fit_checkpointed(NBMF(max_iter={CKPT_SWEEPS}, tol=0), every="
          f"{CKPT_EVERY}) {X.shape[0]}x{X.shape[1]} k={k}: n_iter {seg.n_iter_}, "
          f"{len(seg.loss_curve_)} losses, checkpoint writes at {writes}; against one "
          f"uninterrupted fit: max |dW| {dev['W']:.3e}, max |dH| {dev['H']:.3e}, loss rel "
          f"{dev['loss']:.3e} (bars {CKPT_BARS}); wall {seg_s:.2f} s segmented against "
          f"{ref_s:.2f} s ({1e3 * (seg_s - ref_s) / n_seg:.1f} ms of re-staging per segment); "
          f"launches {nonzero(seg_counts)} [{card}]", flush=True)
    check(seg.n_iter_ == CKPT_SWEEPS and len(seg.loss_curve_) == CKPT_SWEEPS,
          f"the checkpointed fit ran {seg.n_iter_} sweeps")
    check(writes == [CKPT_EVERY * (i + 1) for i in range(n_seg)],
          f"checkpoint writes at {writes}")
    check(stored["n_iter"] == CKPT_SWEEPS and len(stored["losses"]) == CKPT_SWEEPS,
          "the last checkpoint does not hold the whole fit")
    check(within_bars(dev), f"the checkpointed fit deviates from the uninterrupted one: {dev}")
    for name in ("hloss_terms_packed", "w_terms_packed"):
        check(seg_counts[name] >= CKPT_SWEEPS, f"{name} launched {seg_counts[name]} times")

    # (b) save_model -> load_model(device="cuda"): serving is bitwise the
    # original's.
    path = workdir / "model.npz"
    ckpt.save_model(path, ref)
    loaded = ckpt.load_model(path, device=DEV)
    zero_counts(cs, ds)
    served = []
    for est in (ref, loaded):
        W, W_s = timed(lambda: est.transform(request))
        score = est.score(request)
        served.append((W, score, est.perplexity(request), W_s))
    serve_counts = read_counts(cs, ds)
    add_counts(total, cs, ds)
    (W0, s0, p0, t0), (W1, s1, p1, t1) = served
    same = np.array_equal(W0, W1) and s0 == s1 and p0 == p1
    print(f"save and load: save_model -> load_model(device={DEV!r}); {request.shape[0]}-row "
          f"transform {t0:.3f} s / {t1:.3f} s, score {s0:.9f} / {s1:.9f}, perplexity "
          f"{p0:.9f} / {p1:.9f}; bitwise equal {same}; launches {nonzero(serve_counts)} "
          f"[{card}]",
          flush=True)
    check(same, "the loaded model serves differently from the original")
    check(np.array_equal(loaded.components_, ref.components_) and loaded.n_iter_ == ref.n_iter_
          and loaded.loss_curve_ == list(ref.loss_curve_), "the loaded model's state differs")
    check(serve_counts["w_terms_packed"] >= 6 * 50,
          f"transform launched K2 {serve_counts['w_terms_packed']} times")

    # (c) device_results=True: tensors on the card are saved from the host.
    zero_counts(cs, ds)
    dev_est = NBMF(**dict(params, max_iter=10), solver_options={"device_results": True}).fit(X)
    add_counts(total, cs, ds)
    path = workdir / "device_results.npz"
    ckpt.save_model(path, dev_est)
    stored = ckpt.load_checkpoint(path)
    dev_loaded = ckpt.load_model(path, device=DEV)
    on_card = all(isinstance(t, torch.Tensor) and t.is_cuda
                  for t in (dev_est.W_, dev_est.components_, dev_est.loss_curve_))
    same = (np.array_equal(stored["W"], dev_est.W_.cpu().numpy())
            and np.array_equal(stored["H"], dev_est.components_.cpu().numpy())
            and stored["losses"] == [float(x) for x in dev_est.loss_curve_.cpu().numpy()]
            and np.array_equal(dev_loaded.components_, stored["H"]))
    print(f"device_results=True: fitted attributes on the card {on_card}; saved arrays equal "
          f".cpu().numpy() of its tensors {same} [{card}]", flush=True)
    check(on_card and same, "the device_results model did not save its tensors")

    # (d) resume_fit from a half-way save_model.
    half = CKPT_SWEEPS // 2
    zero_counts(cs, ds)
    first = NBMF(**dict(params, max_iter=half)).fit(X)
    path = workdir / "half.npz"
    ckpt.save_model(path, first)
    resumed, resume_s = timed(lambda: ckpt.resume_fit(path, X, max_iter=half, device=DEV))
    add_counts(total, cs, ds)
    dev = deviation(resumed, ref)
    print(f"resume: resume_fit from a {half}-sweep save_model with max_iter={half}: n_iter "
          f"{resumed.n_iter_}, {len(resumed.loss_curve_)} losses, {resume_s:.2f} s; against "
          f"the uninterrupted fit: max |dW| {dev['W']:.3e}, max |dH| {dev['H']:.3e}, loss rel "
          f"{dev['loss']:.3e} [{card}]", flush=True)
    check(resumed.n_iter_ == CKPT_SWEEPS and len(resumed.loss_curve_) == CKPT_SWEEPS,
          f"the resumed fit counts {resumed.n_iter_} sweeps")
    check(within_bars(dev), f"the resumed fit deviates from the uninterrupted one: {dev}")


def nan_check_paths(solve, X, total, card, cs, ds):
    """Phase 11 (e): a headline solve under ``nan_checks()`` equals the one
    without, bitwise; a NaN prior raises ``FloatingPointError`` on the card.
    The ms/sweep of both is the slope between solves of ``NAN_SWEEPS / 5``
    and ``NAN_SWEEPS`` sweeps on the host clock (set-up cancels)."""
    from nbmf_mm_tpu_torch.utils import nan_checks

    kw = dict(n_components=HEADLINE["k"], tol=0.0, random_state=0, dtype="float32",
              device=DEV)
    short = NAN_SWEEPS // 5
    zero_counts(cs, ds)
    solve(X, max_iter=2, **kw)  # warm-up
    runs = {}
    for flag in (False, True):
        for sweeps in (short, NAN_SWEEPS):
            if flag:
                with nan_checks():
                    runs[flag, sweeps] = timed(lambda: solve(X, max_iter=sweeps, **kw))
            else:
                runs[flag, sweeps] = timed(lambda: solve(X, max_iter=sweeps, **kw))
    add_counts(total, cs, ds)
    per = {flag: 1e3 * (runs[flag, NAN_SWEEPS][1] - runs[flag, short][1]) / (NAN_SWEEPS - short)
           for flag in (False, True)}
    same = same_result(runs[True, NAN_SWEEPS][0], runs[False, NAN_SWEEPS][0])
    raised = ""
    zero_counts(cs, ds)
    with nan_checks():
        try:
            solve(X, max_iter=3, alpha=float("nan"), **kw)
        except FloatingPointError as e:
            raised = str(e)
    add_counts(total, cs, ds)
    print(f"nan_checks: headline solve: {per[False]:.3f} ms/sweep off, {per[True]:.3f} on "
          f"({100 * (per[True] / per[False] - 1):+.1f}%; slope of {short} and {NAN_SWEEPS} "
          f"sweeps, host clock); bitwise equal {same}; a NaN prior raised FloatingPointError: "
          f"{raised!r} [{card}]", flush=True)
    check(same, "a solve under nan_checks differs from the one without")
    check("fused loop" in raised and "sweep 0" in raised, "the NaN solve did not raise")


def obs_nll(Y, P, mask) -> float:
    P = np.clip(P, 1e-12, 1 - 1e-12)
    return float(-np.sum(mask * (Y * np.log(P) + (1 - Y) * np.log(1 - P))) / mask.sum())


def baselines_phase(card):
    """Phase 11 (f): the paper's 10-init protocol on the animals split with
    both baselines on the card (float64), against the stored artifacts; one
    seed of each on the card against the CPU."""
    from nbmf_mm_tpu_torch.models import NBMFEM, LogisticPCA

    Y = np.load(os.path.join(DATA_DIR, "animals.npz"))["Y"].astype(float)
    split = np.load(os.path.join(DATA_DIR, "magron2022", "animals_split.npz"))
    train, test = split["train_mask"].astype(float), split["test_mask"].astype(float)
    classes = {"NBMF-EM": NBMFEM, "logPCA": LogisticPCA}
    artifacts = {"NBMF-EM": "NBMF-EM_test_init.npz", "logPCA": "logPCA_test_init.npz"}
    for name, spec in BASELINES.items():
        ref_mean = float(np.load(os.path.join(DATA_DIR, "magron2022", "animals",
                                              artifacts[name]))["test_pplx"].mean())
        make = lambda seed, device: classes[name](
            n_components=spec["k"], max_iter=spec["max_iter"], tol=1e-5, random_state=seed,
            dtype="float64", device=device)
        nlls, iters = [], []
        t0 = time.perf_counter()
        for seed in range(BASELINE_SEEDS):
            est = make(seed, DEV).fit(Y, mask=train)
            P = est.reconstruction()
            nlls.append(obs_nll(Y, P, test))
            iters.append(est.n_iter_)
        wall = time.perf_counter() - t0
        ours = float(np.mean(nlls))
        rel_err = abs(ours - ref_mean) / ref_mean
        card_est, cpu_est = make(0, DEV).fit(Y, mask=train), make(0, "cpu").fit(Y, mask=train)
        lc, lh = np.asarray(card_est.loss_curve_), np.asarray(cpu_est.loss_curve_)
        loss_dev = (float((np.abs(lc - lh) / np.abs(lh)).max())
                    if lc.shape == lh.shape else float("inf"))
        print(f"baseline {name}: {BASELINE_SEEDS}-init protocol on the animals split, K="
              f"{spec['k']}, float64 on the card: mean test NLL {ours:.6f} against the "
              f"artifact's {ref_mean:.6f} ({100 * rel_err:.2f}%, bar {100 * spec['rel']:g}%), "
              f"n_iter {iters}, {wall:.2f} s ({1e3 * wall / sum(iters):.2f} ms/iteration); seed "
              f"0 on the card against the CPU: n_iter {card_est.n_iter_} / {cpu_est.n_iter_}, "
              f"losses rel {loss_dev:.3e} (bar {BASELINE_DEVICE_REL:g}) [{card}]", flush=True)
        check(rel_err < spec["rel"], f"{name}: the protocol misses the artifact by {rel_err:.4f}")
        if spec["max_n_iter"] is not None:
            check(max(iters) <= spec["max_n_iter"], f"{name}: n_iter {iters}")
        check(card_est.n_iter_ == cpu_est.n_iter_ and loss_dev <= BASELINE_DEVICE_REL,
              f"{name}: the card and the CPU disagree")


def p7_on_the_card(solve, X, lastfm, total, card, cs, ds):
    """Phase 11 (g): the JAX package's option names on the card."""
    import nbmf_mm_compat_torch

    kw = dict(n_components=HEADLINE["k"], max_iter=20, tol=0.0, random_state=0,
              dtype="float32", device=DEV)
    zero_counts(cs, ds)
    pallas = solve(X, backend="pallas", **kw)
    pallas_counts = read_counts(cs, ds)
    add_counts(total, cs, ds)
    zero_counts(cs, ds)
    fused = solve(X, backend="fused", **kw)
    tiles = solve(X, block_m=256, block_n=256, **kw)
    add_counts(total, cs, ds)
    raised = ""
    try:
        solve(X, pallas_interpret=True, **kw)
    except ValueError as e:
        raised = str(e)
    zero_counts(cs, ds)
    est = nbmf_mm_compat_torch.NBMF(n_components=8, max_iter=50, random_state=0).fit(lastfm)
    compat_counts = read_counts(cs, ds)
    add_counts(total, cs, ds)
    print(f"P7 on the card: backend='pallas' equals 'fused' bitwise {same_result(pallas, fused)} "
          f"(extras {pallas.extras}, launches {nonzero(pallas_counts)}); block_m=256 changes "
          f"nothing "
          f"{same_result(tiles, fused)}; pallas_interpret=True on cuda raised: {raised!r}; "
          f"nbmf_mm_compat_torch.NBMF on lastfm: n_iter {est.n_iter_}, extras "
          f"{est.solver_result_.extras} [{card}]", flush=True)
    check(same_result(pallas, fused) and pallas.extras == fused.extras,
          "backend='pallas' differs from 'fused'")
    check(min(pallas_counts["hloss_terms_packed"], pallas_counts["w_terms_packed"]) >= 20,
          f"backend='pallas' launched {pallas_counts}")
    check(same_result(tiles, fused), "block_m changed the solve")
    check("pallas_interpret=True" in raised, "pallas_interpret=True on cuda did not raise")
    check(est.solver_result_.extras["backend"] == "fused" and np.isfinite(est.loss_)
          and compat_counts["hloss_terms_packed"] > 0, "the compat shim's NBMF did not fit")


def host_surface_phase(NBMF, solve, X, lastfm, request, card, cs, ds):
    """Phase 11: checkpoint, utils and baselines.  Returns the launches of
    the production kernels over the phase's paths."""
    import shutil

    total = {}
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_phase11"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        checkpoint_paths(NBMF, X, request, workdir, total, card, cs, ds)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    nan_check_paths(solve, X, total, card, cs, ds)
    baselines_phase(card)
    p7_on_the_card(solve, X, lastfm, total, card, cs, ds)
    print(f"checkpoint, utils and baselines: launches over phase 11's paths "
          f"{ {name: total.get(name, 0) for name in PATH_KERNELS} } [{card}]", flush=True)
    for name in ("hloss_terms_packed", "w_terms_packed"):
        check(total.get(name, 0) > 0, f"{name} was never launched in phase 11")
    return total


def stress_phase(card, cs, ds):
    """Phase 12: the stress driver on the card.  Returns the launches per
    kernel form over the draws (the planner's comparison launches apart)."""
    from nbmf_mm_tpu_torch.tools import stress_solve as st

    total = {}
    t0 = time.perf_counter()
    planners = st.planner_sweep(STRESS_PLANNERS, seed=STRESS_SEED, launch=STRESS_LAUNCHED,
                                device=DEV, quiet=True)
    print(f"stress planners: {planners['drawn']} geometries drawn, {planners['planned']} "
          f"planned within the kernels' preconditions, {planners['refused']} refused up front; "
          f"{planners['launched']} launched (forms {planners['forms']}) against the plain "
          f"versions: worst rel err Num/Den/T {planners['worst']['terms']:.3e}, ll "
          f"{planners['worst']['ll']:.3e} (bars {st.LAUNCH_BARS[0]:g} of max|plain| and "
          f"{st.LAUNCH_BARS[1]:g}; the reduced forms on dyadic factors, where WH is exact); the "
          f"reduced forms on random factors, reported: Num/Den/T "
          f"{planners['reported']['terms']:.3e}, ll {planners['reported']['ll']:.3e}; "
          f"{planners.get('refusals', 0)} refusals through the wrappers allocated nothing; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    check(planners["drawn"] == STRESS_PLANNERS == planners["planned"] + planners["refused"],
          f"planner sweep {planners}")
    check(planners["launched"] >= 60 and set(planners["forms"]) == set(st.FORMS),
          f"planner sweep launched {planners['forms']}")
    check(planners.get("refusals", 0) > 0, "no refusal was checked on the card")
    for i, (backend, draws) in enumerate(STRESS_DRAWS.items()):
        t0 = time.perf_counter()
        zero_counts(cs, ds)
        out = st.stress(backend, draws, seed=STRESS_SEED + i, precision="draw", device=DEV,
                        quiet=True)
        counts = read_counts(cs, ds)
        add_counts(total, cs, ds)
        print(f"stress {backend} (seed {STRESS_SEED + i}, operand form drawn per draw): "
              f"{out['draws']} draws, {len(out['failures'])} failed {out['failures'][:3]}; "
              f"forms {out['forms']}; card loop against the card's plain loop (tol=0, same "
              f"inits), draws compared {out['compared']}, worst {out['worst']} (float32 bars "
              f"{st.CARD_LOSS_REL:g} loss rel, {st.CARD_FACTOR_ABS:g} factors); launches per "
              f"kernel form {nonzero(counts)}; {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)
        check(not out["failures"], f"stress {backend}: failed draws {out['failures']}")
    return total


def jax_figure2() -> dict:
    """The JAX round's Figure 2 rows by dataset."""
    import csv

    with open(JAX_FIG2, newline="") as f:
        return {row["dataset"]: {k: float(v) if k != "dataset" and v not in ("True", "False")
                                 else v for k, v in row.items()} for row in csv.DictReader(f)}


def figures_phase(card):
    """Phase 13, Figures 1-3 on the three datasets (the runner's float32
    default: the fused loop over packed words), against the JAX round's
    Figure 2 and the CPU."""
    from nbmf_mm_tpu_torch import NBMF
    from nbmf_mm_tpu_torch.experiments import reproduce_magron2022 as rep
    from nbmf_mm_tpu_torch.experiments.data import load_dataset_and_splits

    out_dir = Path(EXPERIMENTS_OUT)
    ref = jax_figure2()
    for ds in rep.FIG1_K:
        t0 = time.perf_counter()
        rows = rep.figure1_rows(ds, None, DEV)
        rep.write_csv(out_dir / f"figure1_{ds}_results.csv", rows)
        best = min(rows, key=lambda r: r["val_perplexity"])
        ok = len(rows) == 36 and all(np.isfinite(r["val_perplexity"]) and r["n_iter"] <= 500
                                     for r in rows)
        print(f"figure 1 {ds}: 36 cells in one grid_solve, best a={best['alpha']} "
              f"b={best['beta']} val perplexity {best['val_perplexity']:.4f}, sweeps "
              f"{min(r['n_iter'] for r in rows)}-{max(r['n_iter'] for r in rows)}, "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        check(ok, f"figure 1 {ds}: {rows}")
    fig2 = []
    for ds in rep.FIG1_K:
        t0 = time.perf_counter()
        row, model, nlls = rep.figure2_row(ds, None, DEV)
        fig2.append(row)
        j = ref[ds]
        mm_dev = abs(row["mm10_test_nll_mean"] - j["mm10_test_nll_mean"])
        em_rel = (abs(row["nbmf_em_test_nll_mean"] - j["nbmf_em_test_nll_mean"])
                  / j["nbmf_em_test_nll_mean"])
        lp_rel = (abs(row["logpca_test_nll_mean"] - j["logpca_test_nll_mean"])
                  / j["logpca_test_nll_mean"])
        p = rep.FIG2_PARAMS[ds]
        Y, train, _, test = load_dataset_and_splits(ds)
        on_cpu = NBMF(n_components=p["k"], alpha=p["alpha"], beta=p["beta"],
                      max_iter=rep.FIG2_MAX_ITER[ds], tol=1e-5, random_state=rep.SEED,
                      device="cpu").fit(Y, mask=train)
        nll_card = float(np.log(row["test_perplexity"]))
        nll_cpu = rep._obs_nll(Y, on_cpu.W_.astype(np.float64)
                               @ on_cpu.components_.astype(np.float64), test)
        print(f"figure 2 {ds}: fit test perplexity {row['test_perplexity']:.4f} (JAX round "
              f"{j['test_perplexity']:.4f}), n_iter {row['n_iter']}, converged "
              f"{row['converged']}; 10-init NBMF-MM test NLL {row['mm10_test_nll_mean']:.4f} +- "
              f"{row['mm10_test_nll_std']:.4f} against the JAX round's "
              f"{j['mm10_test_nll_mean']:.4f} +- {j['mm10_test_nll_std']:.4f} (off by "
              f"{mm_dev / j['mm10_test_nll_std']:.2f} sd, bar {FIG2_SIGMAS:g}; artifact "
              f"{row['magron_mm_test_nll_mean']:.4f}), sweeps ~{row['mm10_iters_mean']:.0f}, "
              f"{row['mm10_batch_time']:.2f} s; NBMF-EM {row['nbmf_em_test_nll_mean']:.4f} "
              f"({100 * em_rel:.2f}% off the JAX round, bar "
              f"{100 * BASELINES['NBMF-EM']['rel']:g}%; artifact "
              f"{row['magron_nbmf_em_test_nll_mean']:.4f}), logPCA "
              f"{row['logpca_test_nll_mean']:.4f} ({100 * lp_rel:.2f}%, bar "
              f"{100 * BASELINES['logPCA']['rel']:g}%; artifact "
              f"{row['magron_logpca_test_nll_mean']:.4f}); card against CPU (seed {rep.SEED}): "
              f"test NLL {nll_card:.6f} / {nll_cpu:.6f}, n_iter {row['n_iter']} / "
              f"{on_cpu.n_iter_}; {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        check(mm_dev <= FIG2_SIGMAS * j["mm10_test_nll_std"],
              f"figure 2 {ds}: the 10-init protocol is {mm_dev:.4f} off the JAX round")
        check(em_rel < BASELINES["NBMF-EM"]["rel"] and lp_rel < BASELINES["logPCA"]["rel"],
              f"figure 2 {ds}: baselines off the JAX round by {em_rel:.4f} / {lp_rel:.4f}")
        check(abs(nll_card - nll_cpu) <= CARD_CPU_NLL,
              f"figure 2 {ds}: card and CPU test NLL differ by {abs(nll_card - nll_cpu)}")
    rep.write_csv(out_dir / "figure2_results.csv", fig2)
    for ds in rep.FIG1_K:
        t0 = time.perf_counter()
        rows = rep.figure3_rows(ds, None, DEV)
        rep.write_csv(out_dir / f"figure3_{ds}_results.csv", rows)
        print(f"figure 3 {ds}: " + ", ".join(
            f"K={r['k']} test perplexity {r['test_perplexity']:.4f} ({r['n_iter']} sweeps)"
            for r in rows) + f"; {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        check(all(np.isfinite(r["test_perplexity"]) and r["n_iter"] <= 1000 for r in rows),
              f"figure 3 {ds}: {rows}")


def flagship_phase(card, loops):
    """Phase 13, ``flagship_scale``'s ``headline_1e9`` and
    ``sparse_3pct_1e9``."""
    from nbmf_mm_tpu_torch.experiments import flagship_scale as flag

    rows = flag.run(flag.CONFIGS, flag.SPARSE, DEV, Path(EXPERIMENTS_OUT))
    for row in rows:
        rel_rise = float(row["worst_descent_violation"]) / abs(row["final_loss"])
        oracle_rel = abs(row["final_loss"] - row["oracle_nll"]) / row["oracle_nll"]
        dense_gb = row["M"] * row["N"] * 4 / 2**30
        print(f"flagship {row['config']}: {row['M']}x{row['N']} K={row['K']}, "
              f"{row['packed_mb']} MB of words made in {row['gen_pack_s']:.2f} s; n_iter "
              f"{row['n_iter']}, converged {row['converged']}; final loss "
              f"{row['final_loss']:.6f} against the oracle NLL {row['oracle_nll']:.6f} "
              f"({100 * oracle_rel:.2f}%); worst rise {rel_rise:.2e} of the loss; "
              f"{row['ms_per_sweep']:.3f} ms/sweep (the headline loop {loops['binary']:.3f} "
              f"ms/sweep at 10^8 entries), factor pull {row['retrieve_s']:.3f} s, peak device "
              f"memory {row['peak_hbm_gb']} GB against {dense_gb:.2f} GB dense [{card}]",
              flush=True)
        check(np.isfinite(row["final_loss"]) and rel_rise <= FLAGSHIP_DESCENT,
              f"flagship {row['config']}: descent {rel_rise}")
        check(row["peak_hbm_gb"] < dense_gb, f"flagship {row['config']}: a dense copy's memory")
        if row["config"] == "headline_1e9":
            check(row["converged"] and oracle_rel <= FLAGSHIP_ORACLE_REL,
                  f"flagship headline: converged {row['converged']}, {oracle_rel:.4f} off")
    return rows


def experiments_phase(card, loops, cs, ds):
    """Phase 13: the experiment runners on the card.  Returns the launches
    per kernel over the phase."""
    from nbmf_mm_tpu_torch.experiments import benchmark_suite as bench
    from nbmf_mm_tpu_torch.experiments import validate_implementation as valid

    zero_counts(cs, ds)
    total = {}
    t0 = time.perf_counter()
    figures_phase(card)
    print(f"figures 1-3: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    t0 = time.perf_counter()
    rows = (bench.dataset_rows(None, DEV) + bench.quickstart_row(None, DEV)
            + bench.throughput_row(HEADLINE["m"], HEADLINE["k"], 40, DEV))
    bench_ms = 1e3 / rows[-1]["sweeps_per_sec"]
    print(f"benchmark suite: {len(rows)} rows; throughput {bench_ms:.3f} ms/sweep at the "
          f"headline (phase 6's loop {loops['binary']:.3f}); {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    check(all(r["n_iter"] for r in rows) and np.isfinite(bench_ms) and bench_ms > 0,
          f"benchmark suite rows {rows}")
    t0 = time.perf_counter()
    flagship_phase(card, loops)
    print(f"flagship: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    t0 = time.perf_counter()
    code = valid.main(["--device", DEV])
    print(f"validate_implementation on the card: exit code {code}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    check(code == 0, "validate_implementation failed on the card")
    add_counts(total, cs, ds)
    print(f"experiments: launches over phase 13's paths {nonzero(total)} [{card}]", flush=True)
    for name in ("hloss_terms_packed", "w_terms_packed"):
        check(total.get(name, 0) > 0, f"{name} was never launched in phase 13")
    return total


def main() -> None:
    # ---------------------------------------------------------- 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run(["bash", "-c", "nvcc --version || /usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    from nbmf_mm_tpu_torch import NBMF, FoldInServer, grid_solve, solve

    # A solve turns TF32 off for its own duration and leaves the process's
    # switches as it found them; the script's own comparisons then run with
    # them off.
    tf32 = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    before = tf32()
    solve(np.eye(8, dtype=np.float32), 2, max_iter=2, backend="plain", device=DEV)
    after = tf32()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc.splitlines()[-1] if nvcc else 'not found'}; "
          f"allow_tf32 (matmul, cudnn) before a solve {before}, after it {after}, "
          f"for the rest of this run {tf32()}", flush=True)
    check(before == after == (True, True), "a solve did not restore the TF32 switches")
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
    for name, used in kernel_resources(_build.build_log(), WGMMA_KERNELS).items():
        print(f"  ptxas, tensor-core kernel {name}: {used}", flush=True)
    from nbmf_mm_tpu_torch.tools.sass_diff import kernels_sass

    hgmma = {name: code.count("HGMMA") for name, code in
             kernels_sass(Path(_build.load_library()._name)).items() if "wgmma_kernel" in name}
    print(f"  SASS: {len(hgmma)} tensor-core pass instances, HGMMA instructions in each "
          f"{min(hgmma.values(), default=0)} to {max(hgmma.values(), default=0)}", flush=True)
    check(len(hgmma) > 0 and min(hgmma.values()) > 0,
          "a tensor-core pass has no HGMMA instruction in its SASS")
    tf32_hgmma = {name: count for name, count in hgmma.items() if "tf32" in name}
    print(f"  SASS: {len(tf32_hgmma)} TF32 pass instances, HGMMA instructions in each "
          f"{min(tf32_hgmma.values(), default=0)} to {max(tf32_hgmma.values(), default=0)}",
          flush=True)
    check(len(tf32_hgmma) > 0 and min(tf32_hgmma.values()) > 0,
          "a TF32 pass has no HGMMA instruction in its SASS")
    # Two blocks of a TF32 pass share an SM up to k = 128 (the tensor cores and
    # the CUDA cores overlap across them); one above.
    occupancy = cs.tf32_occupancy()
    for (name, rank, second), (blocks, smem) in occupancy.items():
        print(f"  occupancy, TF32 {name} k={rank}{' with its second operand' if second else ''}: "
              f"{blocks} blocks/SM at {smem} bytes of shared memory", flush=True)
    check(all(blocks >= (2 if rank <= 128 else 1)
              for (_, rank, _), (blocks, _) in occupancy.items()),
          "a TF32 pass instance holds fewer blocks per SM than planned")

    # ------------------------------------------- 3. kernels against plain
    X = headline_matrix()
    P = mean_matrix()
    lastfm = lastfm_matrix()
    lastfm_soft = np.random.default_rng(6).random(lastfm.shape).astype(np.float32)
    tiny = (np.random.default_rng(4).random((32, 40)) < 0.3).astype(np.float32)
    errors = {name: 0.0 for name in {**KERNELS, **TIER_KERNELS}}
    check_packed_kernels("headline", X, HEADLINE["k"], card, cs, errors)
    check_packed_kernels("lastfm", lastfm, 8, card, cs, errors)
    # One word row: the H pass writes Num/Den directly, without the split over m.
    check_packed_kernels("one-word-row", tiny, 4, card, cs, errors)
    check_dense_kernels("headline P", P, HEADLINE["k"], card, cs, ds, errors)
    check_dense_kernels("lastfm-shaped continuous", lastfm_soft, 8, card, cs, ds, errors)
    check_dense_kernels("one-word-row", tiny * 0.5 + 0.25, 4, card, cs, ds, errors)
    check_dense_equals_packed("headline", X, HEADLINE["k"], card, cs, ds)
    check_dense_equals_packed("lastfm", lastfm, 8, card, cs, ds)
    check_wpass_edges(card, cs, ds, errors)
    check_hpass_edges(card, cs, ds, errors)

    # ------------------------------------------------------ 4. main paths
    # Launches per kernel, summed over the three main-path runs.
    binary_est, binary_params, binary_wall, binary_counts = binary_main_path(NBMF, X, card, cs,
                                                                            ds)
    model, dense_counts = dense_main_path(NBMF, P, card, cs, ds)
    dense_input_solves, lastfm_mask = packed_vs_dense_solve(solve, X, lastfm, card)
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
    loops = {"binary": loop_ms_per_sweep("binary", X, HEADLINE["k"], True, card, cs),
             "dense": loop_ms_per_sweep("dense", P, HEADLINE["k"], False, card, cs)}
    serving_ms(server, plain_server, requests, weighted, card)

    # ---------------------------------------------- 7. measurement path
    t7 = time.perf_counter()
    for m, n, k in PROBE_SIZES:
        times.update(check_probes(m, n, k, card, cs, ds, pr, errors,
                                  timed=(m, n, k) == PROBE_SIZES[-1]))
    launches.update(measurement_path(card, cs, ds, pr))
    print(f"measurement path: {time.perf_counter() - t7:.1f} s [{card}]", flush=True)

    # ------------------------------------------ 8. packed and sparse input
    t8 = time.perf_counter()
    input_counts = packed_input_phase(NBMF, solve, X, lastfm, lastfm_mask, binary_est,
                                      binary_params, binary_wall, dense_input_solves, card, cs,
                                      ds, errors)
    for name in PATH_KERNELS:
        launches[name] += input_counts[name]
    print(f"packed and sparse input: {time.perf_counter() - t8:.1f} s [{card}]", flush=True)

    # ------------------------------------------------ 9. restarts and grids
    t9 = time.perf_counter()
    lane_launches, lanes = restarts_and_grids_phase(
        NBMF, solve, grid_solve, X, P, lastfm, lastfm_soft, tiny, lastfm_mask, times, loops,
        card, cs, ds, errors)
    for name in PATH_KERNELS:
        launches[name] += lane_launches[name]
        times[name]["lanes"] = lanes[name]
    print(f"restarts and grids: {time.perf_counter() - t9:.1f} s [{card}]", flush=True)

    # ------------------------------- 10. precision tiers and bf16 data
    t10 = time.perf_counter()
    tier_launches, tier_times = tiers_phase(
        NBMF, solve, FoldInServer, grid_solve, X, P, lastfm, lastfm_soft, tiny, lastfm_mask,
        model, requests, weighted, times, loops, card, cs, ds, errors)
    launches.update(tier_launches)
    times.update(tier_times)
    print(f"precision tiers and bf16 data: {time.perf_counter() - t10:.1f} s [{card}]",
          flush=True)

    # ------------------------------- 11. checkpoint, utils and baselines
    t11 = time.perf_counter()
    host_counts = host_surface_phase(NBMF, solve, X, lastfm, requests[SERVE_ROWS.index(8_192)],
                                     card, cs, ds)
    for name in PATH_KERNELS:
        launches[name] += host_counts.get(name, 0)
    print(f"phase 11: checkpoint, utils and baselines: {time.perf_counter() - t11:.1f} s "
          f"[{card}]", flush=True)

    # ------------------------------------------------ 12. stress driver
    t12 = time.perf_counter()
    stress_counts = stress_phase(card, cs, ds)
    print(f"phase 12: stress driver: {time.perf_counter() - t12:.1f} s [{card}]", flush=True)

    # ------------------------------------------- 13. experiment runners
    t13 = time.perf_counter()
    experiment_counts = experiments_phase(card, loops, cs, ds)
    print(f"phase 13: experiment runners: {time.perf_counter() - t13:.1f} s [{card}]",
          flush=True)
    for name in launches:
        launches[name] += stress_counts.get(name, 0) + experiment_counts.get(name, 0)
    print(f"total: {time.perf_counter() - t_start:.1f} s [{card}]", flush=True)

    kernels = [
        {"name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name], **times[name]}
        for name, (source, replaces) in {**KERNELS, **TIER_KERNELS}.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
