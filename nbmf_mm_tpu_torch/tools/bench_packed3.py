"""The matmul chain probes and the H pass over global bit planes.

    python -m nbmf_mm_tpu_torch.tools.bench_packed3 [--mn 10240] [--k 128] [--reps 5]

``mxu_probe`` times the H pass's matmul chain (``chain3_acc``) and the W
pass's (``chain3_tile``) without elementwise work; ``hloss_ngrid`` is the
H pass with ``ll`` unmasked, on dense data or on words packed in global bit
planes, which must agree bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dense_sweep as ds
from ..ops.cuda_sweep import PACKED_WORD_BITS, pack_bits
from ..ops.probes import hloss_ngrid, mxu_probe
from .bench_true import arg_parser, device_of, random_problem, true_time

__all__ = ["mxu_probe", "hloss_ngrid", "pack_bits_global"]


def pack_bits_global(Ymp: torch.Tensor) -> torch.Tensor:
    """Global bit-plane packing along m: word ``(i, :)`` bit ``b`` holds
    row ``b * (Mp/32) + i``, i.e. :func:`pack_bits` with one stripe of
    ``Mp`` rows."""
    Mp = Ymp.shape[0]
    if Mp % PACKED_WORD_BITS:
        raise ValueError(f"pack_bits_global: {Mp} rows are not a multiple of 32")
    return pack_bits(Ymp, Mp)


def main(argv=None):
    args = arg_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of(args)
    M = N = args.mn
    K = args.k
    rng = np.random.default_rng(0)
    print(f"M=N={M} K={K}", flush=True)
    Y, W, H = random_problem(rng, M, N, K, dev)
    Ypg = pack_bits_global(Y)

    n0, d0, l0 = ds.hloss_terms(W, H, Y, eps=1e-8, m_real=M, n_real=N, bm=256)
    n1, d1, l1 = hloss_ngrid(W, H, Y, block_n=256)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    print(f"ngrid dense vs the library's H pass: max rel diff Num {rel(n1, n0):.3e} "
          f"Den {rel(d1, d0):.3e}, |ll diff| {abs(float(l1) - float(l0)):.3e}", flush=True)
    n2, d2, l2 = hloss_ngrid(W, H, Ypg, block_n=256, packed=True)
    print(f"ngrid packed == ngrid dense: {torch.equal(n1, n2)} {torch.equal(d1, d2)} "
          f"{torch.equal(l1, l2)}", flush=True)

    t = lambda fn, a, label: true_time(fn, W, H, a, label, reps=args.reps)
    bf16 = torch.bfloat16
    for v in ("chain3_acc", "chain3_tile"):
        for mxu, lbl in ((None, "f32"), (bf16, "bf16")):
            t(lambda W, H, v=v, mxu=mxu: mxu_probe(W, H, variant=v, mxu_dtype=mxu), (),
              f"mxu_probe {v} {lbl}")
    for bn in (128, 256):
        t(lambda W, H, Y, bn=bn: hloss_ngrid(W, H, Y, block_n=bn), (Y,),
          f"hloss_ngrid dense f32 bn={bn}")
    for bn in (128, 256):
        t(lambda W, H, Yp, bn=bn: hloss_ngrid(W, H, Yp, block_n=bn, packed=True), (Ypg,),
          f"hloss_ngrid packed f32 bn={bn}")
    t(lambda W, H, Yp: hloss_ngrid(W, H, Yp, block_n=256, packed=True, mxu_dtype=bf16),
      (Ypg,), "hloss_ngrid packed bf16 bn=256")


if __name__ == "__main__":
    main()
