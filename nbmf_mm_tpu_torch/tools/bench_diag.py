"""Diagnostic probes: the matmul, elementwise and stream parts of the H pass
alone.

    python -m nbmf_mm_tpu_torch.tools.bench_diag [--mn 10240] [--k 128] [--block 512]

- ``mxu_only``: WH and two accumulating contractions, no ratios, at
  precision DEFAULT (bf16 operands) and HIGHEST (fp32): the matmul floor;
- ``vpu_only``: the ratio and log chain on the data, no matmuls;
- ``hbm_only``: the data summed by column: the stream floor.
"""

from __future__ import annotations

import numpy as np

from ..ops.probes import make_kernel
from .bench_true import arg_parser, device_of, random_problem, true_time

__all__ = ["make_kernel"]


def main(argv=None):
    ap = arg_parser(__doc__.splitlines()[0])
    ap.add_argument("--block", type=int, default=512)
    args = ap.parse_args(argv)
    dev = device_of(args)
    Mp = Np = args.mn
    K, bm = args.k, args.block
    rng = np.random.default_rng(0)
    Y, W, H = random_problem(rng, Mp, Np, K, dev)
    print(f"{Mp}x{Np} K={K} block={bm}", flush=True)
    t = lambda fn, label: true_time(fn, W, H, (Y,), label, reps=args.reps)
    for kind in ("hbm_only", "vpu_only"):
        t(make_kernel(kind, K, Mp, Np, bm, bm, None), kind)
    for prec in ("DEFAULT", "HIGHEST"):
        t(make_kernel("mxu_only", K, Mp, Np, bm, bm, prec), f"mxu_only precision={prec}")


if __name__ == "__main__":
    main()
