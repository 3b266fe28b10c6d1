"""Where the W pass's time goes: variants of its kernel, timed in turns.

    python -m nbmf_mm_tpu_torch.tools.wpass_tune [--mn 10240] [--m M --n N] [--k 128] [--reps 3]

Each variant is a text edit of a copy of ``ops/csrc/sweep_kernels.cuh``;
``sweep_packed.cu`` is built once per variant (all ``nvcc`` runs started
together, with the flags of :mod:`~nbmf_mm_tpu_torch.ops._build`), and K2
(``nbmf_w_terms_packed``) is timed with CUDA events on the tools' draw,
every variant once per round:

- ``production``  the kernel as built, at the planner's split S;
- ``one_group``   the k = 128 instance without its producer and consumer
  warps: one group of 8 warps runs both phases in turn, two blocks per SM
  (128 registers a thread), at the split the planner gives that occupancy:
  what the warp-specialised pipeline buys;
- ``phase_a_x0``  phase A's WH loop left out (its output is wrong):
  production's time less its time is what the WH loop costs;
- ``phase_b_x0``  phase B left out (likewise): the accumulation's cost.
  (Run twice, as the tool once did, phase B no longer fits the registers
  of the warp-specialised block.)  In a pipeline the phases overlap, so
  the two costs and "the rest" are each what the kernel saves without that
  part, not shares that add up;
- ``hold_h``, ``row_by_row``  phase B's two bodies, each taken at every
  ``k`` (production holds h where every k row a thread holds is live and
  goes row by row elsewhere): at a ``--k`` with dead rows, what the choice
  buys;
- ``production`` again at S/2, 2S and S = 1 column chunks.

``--m``/``--n`` time an ``m x n`` problem in place of ``mn x mn`` (the
flagship: ``--m 100000 --n 10000``).  Prints ptxas's registers and spills
for the k = 128 instances, one line per variant, and the two phase costs.
Needs a CUDA card and ``nvcc``; a source the edits no longer match raises.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import cuda_sweep as cs
from .bench_true import arg_parser, device_of, random_problem

_A_LOOP = "#pragma unroll 2\n        for (int k8 = 0; k8 < kw; k8 += 8) {"
_B_LOOP = "for (int c4 = 0; c4 < kQ; ++c4) {"


def _wrap_twice(text: str, start: str, end: str) -> str:
    """``text`` with the block from ``start`` to ``end`` run twice."""
    i, j = text.index(start), text.index(end)
    return text[:i] + "for (int rep = 0; rep < 2; ++rep) {\n" + text[i:j] + "}\n" + text[j:]


def _skip(text: str, loop: str, bound: str, none: str) -> str:
    """``text`` with the one loop ``loop`` run zero times."""
    if text.count(loop) != 1:
        raise ValueError(f"wpass_tune: {loop!r} no longer matches once")
    return text.replace(loop, loop.replace(bound, none))


def variants(header: str) -> dict:
    """{name: header text} of the timed variants."""
    bounds, split = "kMinBlocks = TK <= 4 ? 2 : 1;", "kSplit = TK == 8;"
    body = "const bool all_rows = 16 * (TK - 1) < k;"
    if bounds not in header or split not in header or header.count(body) != 1:
        raise ValueError("wpass_tune: the block geometry no longer matches")
    return {
        "production": header,
        "one_group": header.replace(bounds, "kMinBlocks = TK <= 8 ? 2 : 1;").replace(
            split, "kSplit = false;"),
        "phase_a_x0": _skip(header, _A_LOOP, "k8 < kw", "k8 < 0"),
        "phase_b_x0": _skip(header, _B_LOOP, "c4 < kQ", "c4 < 0"),
        "hold_h": header.replace(body, "const bool all_rows = true;"),
        "row_by_row": header.replace(body, "const bool all_rows = false;"),
    }


def _build_variants(texts: dict, out_dir: Path, entry: str = "nbmf_w_terms_packed",
                    kernel: str = "wpass_kernelILi8E", label: str = "TK=8") -> dict:
    """Build ``sweep_packed.cu`` against each header text (all ``nvcc`` runs
    started together) and return ``{name: the C entry point}``; prints
    ptxas's registers and spills of the instances whose names hold
    ``kernel``."""
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = {}
    for name, text in texts.items():
        d = out_dir / name
        shutil.copytree(_build.CSRC, d)
        (d / "sweep_kernels.cuh").write_text(text)
        so = d / "lib.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(d / "sweep_packed.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    entries = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} does not build\n{log}")
        compiling = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                compiling = line
            elif compiling and kernel in compiling and ("registers" in line or "spill" in line):
                print(f"  {name} {label}{' SECOND' if kernel + 'Lb1E' in compiling else ''}: "
                      f"{line.strip()}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None):
    parser = arg_parser(__doc__.splitlines()[0])
    parser.add_argument("--m", type=int, help="rows of the data (default --mn)")
    parser.add_argument("--n", type=int, help="columns of the data (default --mn)")
    parser.set_defaults(reps=3)
    args = parser.parse_args(argv)
    m, n = args.m or args.mn, args.n or args.mn
    dev = device_of(args)
    if dev.type != "cuda":
        raise RuntimeError("wpass_tune times kernel builds on the card; it has no host form")
    t0 = time.perf_counter()
    header = (_build.CSRC / "sweep_kernels.cuh").read_text()
    entries = _build_variants(variants(header), _build.BUILD_DIR / "wpass_tune")
    print(f"built {len(entries)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    bm, Mp, Np = cs.plan_packing(m, n)
    Y, W, H = random_problem(rng, m, n, args.k, dev)
    words = cs.pack_bits(torch.nn.functional.pad(Y, (0, Np - n, 0, Mp - m)), bm)
    del Y
    W = torch.nn.functional.pad(W, (0, Mp - m)).contiguous()
    H = torch.nn.functional.pad(H, (0, Np - n)).contiguous()
    k = args.k
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    S = cs.plan_w_split(Mp, Np, k, n_sm).nsplit
    # one_group's occupancy, two blocks per SM, is the one the tensor-core
    # forms plan with
    S2 = cs.plan_w_split(Mp, Np, k, n_sm, tensor_cores=True).nsplit
    part = torch.empty((max(2 * S, S2, 1), k, Mp), device=dev)
    T = torch.empty((k, Mp), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, nsplit):
        err = fn(W.data_ptr(), H.data_ptr(), words.data_ptr(), None, T.data_ptr(),
                 part.data_ptr(), k, Mp, Np, bm, n, nsplit, 1, 1e-8, dev.index or 0, stream)
        if err:
            raise RuntimeError(f"wpass_tune: CUDA error {err}")

    runs = [(name, fn, S2 if name == "one_group" else S) for name, fn in entries.items()]
    runs += [("production", entries["production"], s)
             for s in sorted({max(1, S // 2), 2 * S, 1} - {S})]
    times = {}
    for _ in range(args.reps):
        for name, fn, nsplit in runs:
            call(fn, nsplit)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call(fn, nsplit)
            end.record()
            torch.cuda.synchronize()
            times.setdefault((name, nsplit), []).append(start.elapsed_time(end) / 20)
    flops = 6 * m * n * k
    med = {key: statistics.median(v) for key, v in times.items()}
    for (name, nsplit), v in times.items():
        print(f"{name:12s} S={nsplit:4d}: {med[(name, nsplit)]:.4f} ms/call "
              f"({flops / med[(name, nsplit)] / 1e9:.2f} TFLOP/s by 6 m n k; rounds "
              f"{' '.join(f'{x:.4f}' for x in v)})", flush=True)
    base = med[("production", S)]
    a, b = base - med[("phase_a_x0", S)], base - med[("phase_b_x0", S)]
    print(f"phase A (WH loop) {a:.4f} ms, phase B (accumulation) {b:.4f} ms, the rest "
          f"{base - a - b:.4f} ms of production's {base:.4f} ms at {m}x{n} k={k}, S={S}; "
          f"bound {flops / 67e12 * 1e3:.4f} ms at the 67 TFLOP/s fp32 peak", flush=True)
    return med


if __name__ == "__main__":
    main()
