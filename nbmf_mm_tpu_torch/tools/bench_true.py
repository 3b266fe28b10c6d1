"""Slope timing of kernel calls, and the decision-grade run of the probes.

    python -m nbmf_mm_tpu_torch.tools.bench_true [--mn 10240] [--k 128] [--reps 5]

:func:`true_time` reports the median over ``reps`` of
``(t(hi calls) - t(lo calls)) / (hi - lo)``, which cancels the fixed cost
of a timed run; on the card the times come from CUDA events.  The JAX
harness also folds a zero scalar of each output back into ``W``, so that
XLA cannot hoist a loop-invariant call out of its loop; PyTorch runs every
launch it is given, so nothing is folded back here.

The helpers below (:func:`arg_parser`, :func:`device_of`,
:func:`random_problem`) are shared by the other scripts of this package.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..utils.profiling import sweep_timer


def true_time(fn, W, H, args, label, lo=10, hi=110, reps=5, quiet=False):
    """Median slope in ms per call of ``fn(W, H, *args)``."""
    fn(W, H, *args)  # warm-up: builds the kernels at first use
    vals = []
    for _ in range(reps):
        t_lo = sweep_timer(fn, W, H, *args, warmup=0, iters=lo)[0] * lo
        t_hi = sweep_timer(fn, W, H, *args, warmup=0, iters=hi)[0] * hi
        vals.append((t_hi - t_lo) / (hi - lo) * 1e3)
    med = statistics.median(vals)
    if not quiet:
        print(f"{label:48s} {med:8.3f} ms/call "
              f"(reps: {' '.join(f'{v:.3f}' for v in vals)})", flush=True)
    return med


def arg_parser(doc: str, mn: int = 10240) -> argparse.ArgumentParser:
    """The options every script of this package takes."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--mn", type=int, default=mn, help="rows and columns of the data")
    ap.add_argument("--k", type=int, default=128, help="rank")
    ap.add_argument("--reps", type=int, default=5, help="slopes per timing (median)")
    ap.add_argument("--device", default="cuda", help="a CUDA device; 'cpu' times the plain "
                    "versions on the host (a rehearsal, not a device measurement)")
    return ap


def device_of(args) -> torch.device:
    """The device to run on; a CUDA device where there is no card raises."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the measurement path runs on the card "
                           "(pass --device cpu for a host rehearsal)")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    print(f"device={name}", flush=True)
    return dev


def random_problem(rng, M, N, K, dev):
    """The tools' draw: binary ``Y`` of density 0.3, ``W`` with unit column
    sums and ``H`` in [0.1, 0.9], all float32 on ``dev``."""
    Y = torch.tensor(rng.random((M, N)) < 0.3, dtype=torch.float32, device=dev)
    W = rng.uniform(0.1, 0.9, (K, M)).astype(np.float32)
    W /= W.sum(axis=0, keepdims=True)
    H = rng.uniform(0.1, 0.9, (K, N)).astype(np.float32)
    return Y, torch.tensor(W, device=dev), torch.tensor(H, device=dev)


def main(argv=None):
    args = arg_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..ops import dense_sweep as ds
    from .bench_packed import pack_bits
    from .bench_packed2 import hloss_packed2, w_packed2
    from .bench_packed3 import hloss_ngrid, mxu_probe, pack_bits_global

    dev = device_of(args)
    M = N = args.mn
    K = args.k
    rng = np.random.default_rng(0)
    print(f"M=N={M} K={K}", flush=True)
    Y, W, H = random_problem(rng, M, N, K, dev)
    Yp = pack_bits(Y, 256)
    Ypg = pack_bits_global(Y)
    bf16 = torch.bfloat16
    t = lambda fn, a, label: true_time(fn, W, H, a, label, reps=args.reps)

    t(lambda W, H, Y: ds.hloss_terms(W, H, Y, eps=1e-8, m_real=M, n_real=N, bm=256),
      (Y,), "dense hloss stripe")
    t(lambda W, H, Y: ds.w_terms(W, H, Y, eps=1e-8, n_real=N, bm=256), (Y,), "dense w stripe")
    t(lambda W, H: mxu_probe(W, H, variant="chain3_tile"), (), "mxu chain3_tile f32")
    t(lambda W, H: mxu_probe(W, H, variant="chain3_tile", mxu_dtype=bf16), (),
      "mxu chain3_tile bf16")
    t(lambda W, H, Yp: hloss_packed2(W, H, Yp, block_m=256), (Yp,), "packed2 hloss select f32")
    t(lambda W, H, Yp: w_packed2(W, H, Yp, n_real=N, block_m=256), (Yp,),
      "packed2 w select f32")
    t(lambda W, H, Yp: hloss_packed2(W, H, Yp, block_m=256, mxu_dtype=bf16), (Yp,),
      "packed2 hloss select bf16")
    t(lambda W, H, Yp: w_packed2(W, H, Yp, n_real=N, block_m=256, mxu_dtype=bf16), (Yp,),
      "packed2 w select bf16")
    t(lambda W, H, Yp: hloss_ngrid(W, H, Yp, block_n=256, packed=True), (Ypg,),
      "ngrid packed hloss f32")
    t(lambda W, H, Yp: hloss_ngrid(W, H, Yp, block_n=256, packed=True, mxu_dtype=bf16),
      (Ypg,), "ngrid packed hloss bf16")


if __name__ == "__main__":
    main()
