"""Select-form packed passes and the matmul-only calibration.

    python -m nbmf_mm_tpu_torch.tools.bench_packed2 [--mn 10240] [--k 128] [--reps 5]

For binary data ``ym`` enters every formula as a {0,1} indicator, so
``p = where(bit, b r, 0)``, ``q = where(bit, 0, a r)`` and
``ll = log(where(bit, a, b))`` (one log instead of two) give the product
form's values bitwise.  ``mxu_only`` runs the H pass's matmuls alone, at the
production tiling, to give the card's floor for that loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_sweep import pack_bits
from ..ops.probes import hloss_packed2, mxu_only, w_packed2
from ..utils.profiling import sweep_timer
from .bench_packed import chained_sweeps, check_small
from .bench_true import arg_parser, device_of, random_problem, true_time

__all__ = ["hloss_packed2", "w_packed2", "mxu_only", "sweep_loop2"]


def sweep_loop2(W0, H0, Yp, *, n_real, alpha, beta, eps=1e-8, block_m=256, mxu_dtype=None,
                iters=30):
    """ms/sweep of the chained sweep over the select-form passes."""
    run = lambda W, H, Yp: chained_sweeps(
        hloss_packed2, w_packed2, W, H, Yp, n_real=n_real, alpha=alpha, beta=beta, eps=eps,
        block_m=block_m, mxu_dtype=mxu_dtype, iters=iters)
    return sweep_timer(run, W0, H0, Yp, warmup=1, iters=1)[0] / iters * 1e3


def main(argv=None):
    args = arg_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of(args)
    M = N = args.mn
    K = args.k
    rng = np.random.default_rng(0)
    print(f"M=N={M} K={K}", flush=True)
    check_small(rng, dev, hloss_packed2, w_packed2, "packed2")

    bm = 256
    Y, W, H = random_problem(rng, M, N, K, dev)
    Yp = pack_bits(Y, bm)
    t = lambda fn, a, label: true_time(fn, W, H, a, label, reps=args.reps)
    bf16 = torch.bfloat16
    for n_mm in (3, 2):
        for mxu, lbl in ((None, "f32"), (bf16, "bf16")):
            t(lambda W, H, n_mm=n_mm, mxu=mxu: mxu_only(W, H, None, n_mm=n_mm, block_m=bm,
                                                       mxu_dtype=mxu),
              (), f"MXU-only {n_mm} matmuls {lbl}")
    for mxu, lbl in ((None, "f32"), (bf16, "bf16-mxu")):
        t(lambda W, H, Yp, mxu=mxu: hloss_packed2(W, H, Yp, block_m=bm, mxu_dtype=mxu), (Yp,),
          f"packed2 hloss {lbl}")
        t(lambda W, H, Yp, mxu=mxu: w_packed2(W, H, Yp, n_real=N, block_m=bm, mxu_dtype=mxu),
          (Yp,), f"packed2 wterms {lbl}")
    for mxu, lbl in ((None, "f32"), (bf16, "bf16-mxu")):
        dt = sweep_loop2(W, H, Yp, n_real=N, alpha=1.2, beta=1.2, block_m=bm, mxu_dtype=mxu)
        print(f"full packed2 sweep loop {lbl:10s} {dt:8.3f} ms/sweep ({1e3 / dt:.0f} sweeps/s)",
              flush=True)


if __name__ == "__main__":
    main()
