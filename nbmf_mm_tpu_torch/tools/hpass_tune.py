"""Where the H pass's time goes: variants of its kernel, timed in turns.

    python -m nbmf_mm_tpu_torch.tools.hpass_tune [--mn 10240] [--k 128] [--reps 3]

Each variant is a text edit of a copy of ``ops/csrc/sweep_kernels.cuh``;
``sweep_packed.cu`` is built once per variant (all ``nvcc`` runs started
together, with the flags of :mod:`~nbmf_mm_tpu_torch.ops._build`), and K1
(``nbmf_hloss_terms_packed``) is timed with CUDA events on the tools' draw,
every variant once per round:

- ``production``  the kernel as built, at the planner's split S;
- ``one_block``   launch bounds for one block per SM (up to 255 registers);
- ``phase_a_x2``  phase A's WH loop run twice (its output is wrong): its
  time less production's is what the WH loop costs;
- ``phase_b_x2``  phase B run twice (likewise): the accumulation's cost;
- ``production`` again at S/2, 2S and S = 1 row chunks.

Prints ptxas's registers and spills for the k = 128 instances, one line
per variant, and the two phase costs.  Needs a CUDA card and ``nvcc``; a
source the edits no longer match raises.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import cuda_sweep as cs
from .bench_true import arg_parser, device_of, random_problem
from .wpass_tune import _build_variants, _wrap_twice

_KERNEL = "hpass_kernel("
_BOUNDS = "kMinBlocks = TK <= 8 ? 2 : 1;"
_A_LOOP = "#pragma unroll 4\n        for (int k8 = 0; k8 < kw; k8 += 8) {"
_A_END = "        const int stripe = w / bmw;"
_B_LOOP = "#pragma unroll\n            for (int r4 = 0; r4 < kHRows / 4; ++r4) {"
_B_END = "\n        }\n    }\n\n    if constexpr (TERMS) {\n        const size_t base"


def variants(header: str) -> dict:
    """{name: header text} of the timed variants (edits of the H pass only)."""
    start = header.index("struct HPass {")
    at = header.index(_BOUNDS, start)
    body = header.index(_KERNEL)
    if header.index(_A_LOOP, body) > header.index(_A_END) or _B_LOOP not in header[body:]:
        raise ValueError("hpass_tune: the H-pass source no longer matches")
    head, tail = header[:body], header[body:]
    return {
        "production": header,
        "one_block": header[:at] + "kMinBlocks = 1;" + header[at + len(_BOUNDS):],
        "phase_a_x2": head + _wrap_twice(tail, _A_LOOP, _A_END),
        "phase_b_x2": head + _wrap_twice(tail, _B_LOOP, _B_END),
    }


def main(argv=None):
    parser = arg_parser(__doc__.splitlines()[0])
    parser.set_defaults(reps=3)
    args = parser.parse_args(argv)
    dev = device_of(args)
    if dev.type != "cuda":
        raise RuntimeError("hpass_tune times kernel builds on the card; it has no host form")
    t0 = time.perf_counter()
    header = (_build.CSRC / "sweep_kernels.cuh").read_text()
    entries = _build_variants(variants(header), _build.BUILD_DIR / "hpass_tune",
                              entry="nbmf_hloss_terms_packed", kernel="hpass_kernelILi8E")
    print(f"built {len(entries)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    Y, W, H = random_problem(rng, args.mn, args.mn, args.k, dev)
    words = cs.pack_bits(Y, 256)
    k, Mp = W.shape
    Np = H.shape[1]
    plan = cs.plan_h_split(Mp, Np, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    S = plan.nsplit
    splits = sorted({max(1, S // 2), min(2 * S, Mp // 32), 1} - {S})
    f32 = dict(dtype=torch.float32, device=dev)
    num, den, ll = torch.empty((k, Np), **f32), torch.empty((k, Np), **f32), torch.empty((), **f32)
    parts = [torch.empty((max(splits + [S]), k, Np), **f32) for _ in range(2)]
    ll_part = torch.empty(-(-Np // cs.H_COLS) * max(splits + [S]), dtype=torch.float64,
                          device=dev)
    wperm = torch.empty((k, Mp), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, nsplit):
        err = fn(W.data_ptr(), H.data_ptr(), words.data_ptr(), None, num.data_ptr(),
                 den.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), ll_part.data_ptr(),
                 ll.data_ptr(), wperm.data_ptr(), k, Mp, Np, 256, Mp, Np, nsplit, 1, 1e-8,
                 dev.index or 0, stream)
        if err:
            raise RuntimeError(f"hpass_tune: CUDA error {err}")

    runs = [(name, fn, S) for name, fn in entries.items()]
    runs += [("production", entries["production"], s) for s in splits]
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
