"""Where the H pass's time goes: variants of its kernel, timed in turns.

    python -m nbmf_mm_tpu_torch.tools.hpass_tune [--mn 10240] [--k 128] [--lanes 1] [--reps 3]

Each variant is a text edit of a copy of ``ops/csrc/sweep_kernels.cuh``;
``sweep_packed.cu`` is built once per variant (all ``nvcc`` runs started
together, with the flags of :mod:`~nbmf_mm_tpu_torch.ops._build`), and K1
(``nbmf_hloss_terms_packed``) is timed with CUDA events on the tools' draw
(``--lanes`` copies of its factors in one launch), every variant once per
round.  At ``k <= 128`` (the turn-taking body, ``TK <= 8``):

- ``production``  the kernel as built, at the planner's split S;
- ``one_block``   launch bounds for one block per SM (up to 255 registers);
- ``phase_a_x2``  phase A's WH loop run twice (its output is wrong): its
  time less production's is what the WH loop costs;
- ``phase_b_x2``  phase B run twice (likewise): the accumulation's cost.

At ``k > 128`` (``TK = 16``, the warp-specialised body):

- ``production``  the kernel as built, at the planner's split S;
- ``turn_taking``  the turn-taking body at TK = 16, one 256-thread block an
  SM, the design the warp-specialised one replaced;
- ``two_block``   the turn-taking body on 32-column blocks, two an SM (128
  registers a thread), at the split that fills two rounds of them: the
  design measured against, not shipped;
- ``no_setmaxnreg``  the warp-specialised body with every role held to the
  registers a thread its launch gives (at most 168);
- ``phase_a_x0``, ``phase_b_x0``  the producers' WH loop or the consumers'
  accumulation left out (the output is wrong): production's time less a
  variant's is what the kernel saves without that part; in a pipeline the
  two overlap, so they do not add up.

Then ``production`` again at S/2, 2S and S = 1 row chunks.  Prints
ptxas's registers and spills for the ``--k`` instances, one line per
variant (at TK = 16 with the registers setmaxnreg gives each role), and
the phase costs.  Needs a CUDA card and ``nvcc``; a source the edits no
longer match raises.
"""

from __future__ import annotations

import re
import statistics
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import cuda_sweep as cs
from .bench_true import arg_parser, device_of, random_problem
from .wpass_tune import _build_variants, _skip, _wrap_twice

_KERNEL = "hpass_kernel("
_BOUNDS = "kMinBlocks = TK <= 8 ? 2 : 1;"
_SPLIT = "kSplit = TK == 16 && TERMS && std::is_same<E, Sweep>::value;"
_ROLES = re.compile(r"kProducerRegs = (\d+), kConsumerRegs = (\d+);")
# The turn-taking body (hpass_kernel's else branch).
_A_LOOP = "#pragma unroll 4\n            for (int k8 = 0; k8 < kw; k8 += 8) {"
_A_END = "            const int stripe = w / bmw;"
# Phase B, one call of the shared step a word row in either body.
_B_CALL = "hpass_accumulate<TK, false>("
# The warp-specialised body (hpass_split).
_SPLIT_BODY = "void hpass_split("
_SPLIT_A = "#pragma unroll 1\n            for (int k8 = 0; k8 < kw; k8 += 8) {"
_SPLIT_B = "hpass_accumulate<TK, true>("
_SETMAXNREG = re.compile(r"\n *asm volatile\(\"setmaxnreg\.(?:inc|dec)[^\n]*\n")
# The turn-taking body on 32-column blocks: its per-thread column counts
# follow kHCols (phase A 1 column a thread, phase B 2), and its operand
# copies take kHCols / 4 chunks a row.
_TWO_BLOCK = (
    ("constexpr int kHCols = 64;", "constexpr int kHCols = 32;"),
    (_BOUNDS, "kMinBlocks = 2;"),
    ("for (int j = 0; j < 2; ++j)", "for (int j = 0; j < kHCols / 32; ++j)"),
    ("for (int c = 0; c < 4; ++c)", "for (int c = 0; c < kHCols / 16; ++c)"),
    ("kRowsY * 16", "kRowsY * (kHCols / 4)"),
    ("b = rem >> 4, ch = rem & 15", "b = rem / (kHCols / 4), ch = rem % (kHCols / 4)"),
)


def _repeat(text: str, call: str, times: int) -> str:
    """``text`` with the one statement that starts with ``call`` run
    ``times`` times."""
    if text.count(call) != 1:
        raise ValueError(f"hpass_tune: {call!r} no longer matches once")
    return text.replace(call, f"for (int rep = 0; rep < {times}; ++rep) {call}")


def _h_pass(header: str) -> int:
    """Where the H pass's text starts: nothing before it is edited."""
    return header.index("constexpr int kHCols = 64;")


def variants(header: str, k: int = 128) -> dict:
    """{name: header text} of the timed variants at rank ``k`` (edits of the
    H pass only)."""
    start = _h_pass(header)
    body = header.index(_KERNEL)
    head, tail = header[:body], header[body:]
    if header.index(_A_LOOP, body) > header.index(_A_END, body) or _B_CALL not in tail:
        raise ValueError("hpass_tune: the H-pass source no longer matches")
    if k <= 128:
        at = header.index(_BOUNDS, start)
        return {
            "production": header,
            "one_block": header[:at] + "kMinBlocks = 1;" + header[at + len(_BOUNDS):],
            "phase_a_x2": head + _wrap_twice(tail, _A_LOOP, _A_END),
            "phase_b_x2": head + _repeat(tail, _B_CALL, 2),
        }
    split = header.index(_SPLIT_BODY)
    if _SPLIT not in header or len(_SETMAXNREG.findall(header)) != 2:
        raise ValueError("hpass_tune: the warp-specialised H pass no longer matches")
    pre, h_pass = header[:start], header[start:]
    turns = pre + h_pass.replace(_SPLIT, "kSplit = false;")
    two = turns[start:]
    for old, new in _TWO_BLOCK:
        if old not in two:
            raise ValueError(f"hpass_tune: {old!r} no longer matches")
        two = two.replace(old, new)
    before, after = header[:split], header[split:body]
    return {
        "production": header,
        "turn_taking": turns,
        "two_block": pre + two,
        "no_setmaxnreg": _ROLES.sub("kProducerRegs = 24, kConsumerRegs = 24;", before)
        + _SETMAXNREG.sub("\n", after) + header[body:],
        "phase_a_x0": before + _skip(after, _SPLIT_A, "k8 < kw", "k8 < 0") + header[body:],
        "phase_b_x0": before + _repeat(after, _SPLIT_B, 0) + header[body:],
    }


def main(argv=None):
    parser = arg_parser(__doc__.splitlines()[0])
    parser.add_argument("--lanes", type=int, default=1, help="lanes of one launch")
    parser.set_defaults(reps=3)
    args = parser.parse_args(argv)
    dev = device_of(args)
    if dev.type != "cuda":
        raise RuntimeError("hpass_tune times kernel builds on the card; it has no host form")
    t0 = time.perf_counter()
    header = (_build.CSRC / "sweep_kernels.cuh").read_text()
    tk = 1 << max(0, (args.k - 1).bit_length() - 4)  # k rows a thread, kpad = 16 TK >= k
    entries = _build_variants(variants(header, args.k), _build.BUILD_DIR / "hpass_tune",
                              entry="nbmf_hloss_terms_packed", kernel=f"hpass_kernelILi{tk}E",
                              label=f"TK={tk}")
    if cs.h_warp_specialised(args.k):
        producers, consumers = _ROLES.search(header).groups()
        print(f"  setmaxnreg: producers {producers}, consumers {consumers} registers a thread "
              f"(production, phase_a_x0, phase_b_x0)", flush=True)
    print(f"built {len(entries)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    Y, W, H = random_problem(rng, args.mn, args.mn, args.k, dev)
    words = cs.pack_bits(Y, 256)
    del Y
    R = args.lanes
    W, H = (x.expand(R, *x.shape).contiguous() for x in (W, H))
    k, Mp = W.shape[-2:]
    Np = H.shape[-1]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cs.plan_h_split(Mp, Np, k, n_sm)
    S = plan.nsplit
    splits = sorted({max(1, S // 2), min(2 * S, Mp // 32), 1} - {S})
    # two_block: 32-column blocks, two an SM
    S2 = cs._least_waste_split(Mp // 32, -(-Np // 32), 2 * n_sm, cs.WAVES)
    most = max(splits + [S, S2])
    f32 = dict(dtype=torch.float32, device=dev)
    num, den = torch.empty((R, k, Np), **f32), torch.empty((R, k, Np), **f32)
    ll = torch.empty((R,), **f32)
    parts = [torch.empty((R, most, k, Np), **f32) for _ in range(2)]
    ll_part = torch.empty(R * -(-Np // 32) * most, dtype=torch.float64, device=dev)
    wperm = torch.empty((R, k, Mp), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, nsplit):
        err = fn(W.data_ptr(), H.data_ptr(), words.data_ptr(), None, num.data_ptr(),
                 den.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), ll_part.data_ptr(),
                 ll.data_ptr(), wperm.data_ptr(), k, Mp, Np, 256, Mp, Np, nsplit, R, 1e-8,
                 dev.index or 0, stream)
        if err:
            raise RuntimeError(f"hpass_tune: CUDA error {err}")

    runs = [(name, fn, S2 if name == "two_block" else S) for name, fn in entries.items()]
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
    flops = 6 * args.mn * args.mn * args.k * R
    med = {key: statistics.median(v) for key, v in times.items()}
    for (name, nsplit), v in times.items():
        print(f"{name:13s} S={nsplit:4d}: {med[(name, nsplit)]:.4f} ms/call "
              f"({flops / med[(name, nsplit)] / 1e9:.2f} TFLOP/s by 6 m n k R; rounds "
              f"{' '.join(f'{x:.4f}' for x in v)})", flush=True)
    base = med[("production", S)]
    where = f"{args.mn}^2 k={args.k} R={R}, S={S}; bound {flops / 67e12 * 1e3:.4f} ms"
    if cs.h_warp_specialised(args.k):
        print(f"without the WH loop {base - med[('phase_a_x0', S)]:.4f} ms, without the "
              f"accumulation {base - med[('phase_b_x0', S)]:.4f} ms less than production's "
              f"{base:.4f} ms at {where}", flush=True)
    else:
        print(f"phase A (WH loop) {med[('phase_a_x2', S)] - base:.4f} ms, phase B "
              f"(accumulation) {med[('phase_b_x2', S)] - base:.4f} ms of production's "
              f"{base:.4f} ms at {where}", flush=True)
    return med


if __name__ == "__main__":
    main()
