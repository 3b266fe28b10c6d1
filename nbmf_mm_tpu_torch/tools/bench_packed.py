"""Bit-packed stripe passes: ``ym`` unpacked to a float, the one-matmul W
form, and the full chained sweep over them.

    python -m nbmf_mm_tpu_torch.tools.bench_packed [--mn 10240] [--k 128] [--reps 5]

Packing layout (stripe-local bit planes along m, for stripe block bm):
word row ``w = j*bmw + i``, bit ``b`` holds data row ``j*bm + b*bmw + i``
(``bmw = bm/32``), the layout of
:func:`~nbmf_mm_tpu_torch.ops.cuda_sweep.pack_bits`.  Prints the
correctness of the packed passes against the library's dense ones at
512x640, K=16, then their slope times and the ms/sweep of the chained loop,
at f32 and bf16 matmul operands.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dense_sweep as ds
from ..ops.cuda_sweep import pack_bits
from ..ops.probes import hloss_packed, w_packed
from ..utils.profiling import sweep_timer
from .bench_true import arg_parser, device_of, random_problem, true_time

__all__ = ["pack_bits", "hloss_packed", "w_packed", "sweep_loop"]


def chained_sweeps(hloss, wpass, W, H, Yp, *, n_real, alpha, beta, eps, block_m, mxu_dtype,
                   iters):
    """``iters`` sweeps of H pass -> H update -> W pass -> W normalize;
    returns ``(W, H, sum of ll)``."""
    ll_acc = torch.zeros((), dtype=W.dtype, device=W.device)
    for _ in range(iters):
        Num, Den, ll = hloss(W, H, Yp, eps=eps, block_m=block_m, mxu_dtype=mxu_dtype)
        num = H * Num + (alpha - 1.0)
        den = (1.0 - H) * Den + (beta - 1.0)
        H_new = torch.clamp(num / (num + den + eps), eps, 1.0 - eps)
        T = wpass(W, H_new, Yp, n_real=n_real, eps=eps, block_m=block_m, mxu_dtype=mxu_dtype)
        W_raw = W * T / n_real
        cols = W_raw.sum(dim=0, keepdim=True)
        W = W_raw / torch.where(cols > 0, cols, 1.0)
        H = H_new
        ll_acc = ll_acc + ll
    return W, H, ll_acc


def sweep_loop(W0, H0, Yp, *, n_real, alpha, beta, eps=1e-8, block_m=256, mxu_dtype=None,
               iters=30):
    """ms/sweep of the full chained sweep (hloss_packed -> H update ->
    w_packed -> W normalize), after one warm-up run."""
    run = lambda W, H, Yp: chained_sweeps(
        hloss_packed, w_packed, W, H, Yp, n_real=n_real, alpha=alpha, beta=beta, eps=eps,
        block_m=block_m, mxu_dtype=mxu_dtype, iters=iters)
    return sweep_timer(run, W0, H0, Yp, warmup=1, iters=1)[0] / iters * 1e3


def check_small(rng, dev, hloss, wpass, label):
    """Print whether the packed passes equal the library's dense ones at the
    tools' correctness shape (512x640, K=16, bm=256)."""
    Ms, Ns, Ks, bms = 512, 640, 16, 256
    Ys, Ws, Hs = random_problem(rng, Ms, Ns, Ks, dev)
    Yps = pack_bits(Ys, bms)
    n0, d0, l0 = ds.hloss_terms(Ws, Hs, Ys, eps=1e-8, m_real=Ms, n_real=Ns, bm=bms)
    n1, d1, l1 = hloss(Ws, Hs, Yps, block_m=bms)
    t0 = ds.w_terms(Ws, Hs, Ys, eps=1e-8, n_real=Ns, bm=bms)
    t1 = wpass(Ws, Hs, Yps, n_real=Ns, block_m=bms)
    print(f"{label} hloss Num exact: {torch.equal(n0, n1)}  Den exact: {torch.equal(d0, d1)}  "
          f"ll exact: {torch.equal(l0, l1)}; wterms max rel diff "
          f"{float((t1 - t0).abs().max() / t0.abs().max()):.3e} (one-matmul form)", flush=True)


def main(argv=None):
    args = arg_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of(args)
    M = N = args.mn
    K = args.k
    rng = np.random.default_rng(0)
    print(f"M=N={M} K={K}", flush=True)
    check_small(rng, dev, hloss_packed, w_packed, "packed")

    bm = 256
    Y, W, H = random_problem(rng, M, N, K, dev)
    Yp = pack_bits(Y, bm)
    print(f"packed bytes: {Yp.numel() * 4 / 1e6:.1f} MB vs dense {Y.numel() * 4 / 1e6:.1f} MB")
    t = lambda fn, a, label: true_time(fn, W, H, a, label, reps=args.reps)
    bf16 = torch.bfloat16
    t(lambda W, H, Y: ds.hloss_terms(W, H, Y, eps=1e-8, m_real=M, n_real=N, bm=bm), (Y,),
      "dense hloss_terms_stripe")
    t(lambda W, H, Y: ds.w_terms(W, H, Y, eps=1e-8, n_real=N, bm=bm), (Y,),
      "dense w_terms_stripe")
    t(lambda W, H, Yp: hloss_packed(W, H, Yp, block_m=bm), (Yp,), "packed hloss f32")
    t(lambda W, H, Yp: w_packed(W, H, Yp, n_real=N, block_m=bm), (Yp,), "packed wterms f32")
    t(lambda W, H, Yp: hloss_packed(W, H, Yp, block_m=bm, mxu_dtype=bf16), (Yp,),
      "packed hloss bf16-mxu")
    t(lambda W, H, Yp: w_packed(W, H, Yp, n_real=N, block_m=bm, mxu_dtype=bf16), (Yp,),
      "packed wterms bf16-mxu")
    for mxu, lbl in ((None, "f32"), (bf16, "bf16-mxu")):
        dt = sweep_loop(W, H, Yp, n_real=N, alpha=1.2, beta=1.2, block_m=bm, mxu_dtype=mxu)
        print(f"full packed sweep loop {lbl:10s} {dt:8.3f} ms/sweep ({1e3 / dt:.0f} sweeps/s)",
              flush=True)


if __name__ == "__main__":
    main()
