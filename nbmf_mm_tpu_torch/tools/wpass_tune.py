"""Where the W pass's time goes: variants of its kernel, timed in turns.

    python -m nbmf_mm_tpu_torch.tools.wpass_tune [--mn 10240] [--k 128] [--reps 3]

Each variant is a text edit of a copy of ``ops/csrc/sweep_kernels.cuh``;
``sweep_packed.cu`` is built once per variant (all ``nvcc`` runs started
together, with the flags of :mod:`~nbmf_mm_tpu_torch.ops._build`), and K2
(``nbmf_w_terms_packed``) is timed with CUDA events on the tools' draw,
every variant once per round:

- ``production``  the kernel as built, at the planner's split S;
- ``one_block``   launch bounds for one block per SM (up to 255 registers);
- ``phase_a_x2``  phase A's WH loop run twice (its output is wrong): its
  time less production's is what the WH loop costs;
- ``phase_b_x2``  phase B run twice (likewise): the accumulation's cost;
- ``production`` again at S/2, 2S and S = 1 column chunks.

Prints ptxas's registers and spills for the k = 128 instances, one line
per variant, and the two phase costs.  Needs a CUDA card and ``nvcc``; a
source the edits no longer match raises.
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
_A_END = "        const int c0 = t * kWCols + 4 * cq;"
_B_LOOP = "#pragma unroll\n        for (int c4 = 0; c4 < kWCols / 4; ++c4) {"
_B_END = "    float* out = dst + (z * gridDim.y + blockIdx.y)"


def _wrap_twice(text: str, start: str, end: str, closing: str = "") -> str:
    """``text`` with the block from ``start`` to ``end`` run twice."""
    i, j = text.index(start), text.index(end)
    block = text[i:j]
    if closing:  # the block ends with the enclosing loop's brace: keep it outside
        block = block.rstrip()
        assert block.endswith(closing)
        block = block[: -len(closing)]
        return text[:i] + "for (int rep = 0; rep < 2; ++rep) {\n" + block + "}\n" + closing + \
            "\n\n" + text[j:]
    return text[:i] + "for (int rep = 0; rep < 2; ++rep) {\n" + block + "}\n" + text[j:]


def variants(header: str) -> dict:
    """{name: header text} of the timed variants."""
    bounds = "kMinBlocks = TK <= 8 ? 2 : 1;"
    if bounds not in header:
        raise ValueError("wpass_tune: the launch bounds no longer match")
    return {
        "production": header,
        "one_block": header.replace(bounds, "kMinBlocks = 1;"),
        "phase_a_x2": _wrap_twice(header, _A_LOOP, _A_END),
        "phase_b_x2": _wrap_twice(header, _B_LOOP, _B_END, closing="}\n    }"),
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
    parser.set_defaults(reps=3)
    args = parser.parse_args(argv)
    dev = device_of(args)
    if dev.type != "cuda":
        raise RuntimeError("wpass_tune times kernel builds on the card; it has no host form")
    t0 = time.perf_counter()
    header = (_build.CSRC / "sweep_kernels.cuh").read_text()
    entries = _build_variants(variants(header), _build.BUILD_DIR / "wpass_tune")
    print(f"built {len(entries)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    Y, W, H = random_problem(rng, args.mn, args.mn, args.k, dev)
    words = cs.pack_bits(Y, 256)
    k, Mp = W.shape
    Np = H.shape[1]
    plan = cs.plan_w_split(Mp, Np, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    S = plan.nsplit
    part = torch.empty((max(2 * S, 1), k, Mp), device=dev)
    T = torch.empty((k, Mp), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, nsplit):
        err = fn(W.data_ptr(), H.data_ptr(), words.data_ptr(), None, T.data_ptr(),
                 part.data_ptr(), k, Mp, Np, 256, Np, nsplit, 1, 1e-8, dev.index or 0, stream)
        if err:
            raise RuntimeError(f"wpass_tune: CUDA error {err}")

    runs = [(name, fn, S) for name, fn in entries.items()]
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
    flops = 6 * args.mn * args.mn * args.k
    med = {key: statistics.median(v) for key, v in times.items()}
    for (name, nsplit), v in times.items():
        print(f"{name:12s} S={nsplit:4d}: {med[(name, nsplit)]:.4f} ms/call "
              f"({flops / med[(name, nsplit)] / 1e9:.2f} TFLOP/s by 6 m n k; rounds "
              f"{' '.join(f'{x:.4f}' for x in v)})", flush=True)
    base = med[("production", S)]
    print(f"phase A (WH loop) {med[('phase_a_x2', S)] - base:.4f} ms, phase B (accumulation) "
          f"{med[('phase_b_x2', S)] - base:.4f} ms of production's {base:.4f} ms at "
          f"{args.mn}^2 k={args.k}, S={S}", flush=True)
    return med


if __name__ == "__main__":
    main()
