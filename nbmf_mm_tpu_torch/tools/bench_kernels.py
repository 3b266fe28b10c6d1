"""Per-kernel slope timing of the library's dense sweep passes.

    python -m nbmf_mm_tpu_torch.tools.bench_kernels [--mn 10000] [--k 128] [--blocks 512]

Times ``hloss_terms``, ``h_terms`` (no loss) and ``w_terms`` with the rows
walked in the bit-plane order of each ``--blocks`` stripe, then the stripe
heights 128, 256 and 512 of the JAX package's stripe forms, which the port
serves with the same kernels (padded to a multiple of 512, which each
stripe height divides).
"""

from __future__ import annotations

import numpy as np

from ..ops import dense_sweep as ds
from ..ops.cuda_sweep import round_up
from .bench_true import arg_parser, device_of, random_problem, true_time


def main(argv=None):
    ap = arg_parser(__doc__.splitlines()[0], mn=10000)
    ap.add_argument("--blocks", type=int, nargs="+", default=[512])
    args = ap.parse_args(argv)
    dev = device_of(args)
    M = N = args.mn
    K = args.k
    rng = np.random.default_rng(0)
    print(f"M=N={M} K={K}", flush=True)
    t = lambda fn, a, label: true_time(fn, a[0], a[1], a[2:], label, reps=args.reps)

    for blk in args.blocks:
        Mp = Np = round_up(M, blk)
        Y, W, H = random_problem(rng, Mp, Np, K, dev)
        print(f"--- block {blk} (padded {Mp}x{Np}) ---", flush=True)
        t(lambda W, H, Y: ds.hloss_terms(W, H, Y, eps=1e-8, m_real=M, n_real=N, bm=blk),
          (W, H, Y), f"hloss_terms b={blk}")
        t(lambda W, H, Y: ds.h_terms(W, H, Y, eps=1e-8, bm=blk), (W, H, Y),
          f"h_terms (no loss) b={blk}")
        t(lambda W, H, Y: ds.w_terms(W, H, Y, eps=1e-8, n_real=N, bm=blk), (W, H, Y),
          f"w_terms b={blk}")
    Mp = Np = round_up(M, 512)
    Y, W, H = random_problem(rng, Mp, Np, K, dev)
    for bm in (128, 256, 512):
        t(lambda W, H, Y, bm=bm: ds.hloss_terms(W, H, Y, eps=1e-8, m_real=M, n_real=N, bm=bm),
          (W, H, Y), f"hloss_terms_stripe bm={bm}")
        t(lambda W, H, Y, bm=bm: ds.w_terms(W, H, Y, eps=1e-8, n_real=N, bm=bm), (W, H, Y),
          f"w_terms_stripe bm={bm}")


if __name__ == "__main__":
    main()
