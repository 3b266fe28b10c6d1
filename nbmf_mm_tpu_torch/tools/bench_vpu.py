"""The elementwise sub-costs of a stripe pass, each alone with the data
stream: the stream and sum, three ways to unpack words, the ratio math and
the two loss forms.

    python -m nbmf_mm_tpu_torch.tools.bench_vpu [--mn 10240] [--reps 5]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_sweep import pack_bits
from ..ops.probes import frag_kernel
from .bench_true import arg_parser, device_of, true_time

__all__ = ["frag_kernel"]

# (fragment, packed, label) in the tools' order.
RUNS = (
    ("stream_sum", False, "dense stream + sum"),
    ("stream_sum", True, "packed stream + sum (words only)"),
    ("unpack_concat_int", True, "unpack concat-int + sum"),
    ("unpack_concat_sign", True, "unpack concat-sign-select + sum"),
    ("unpack_repeat_shift", True, "unpack repeat+varshift + sum"),
    ("ratios", False, "ratio math (recip + muls) + sums"),
    ("loss2log", False, "loss 2-log form"),
    ("loss1log", False, "loss 1-log select form"),
)


def main(argv=None):
    args = arg_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of(args)
    M = N = args.mn
    rng = np.random.default_rng(0)
    Y = torch.tensor(rng.random((M, N)) < 0.3, dtype=torch.float32, device=dev)
    Yp = pack_bits(Y, 256)
    print(f"M=N={M}", flush=True)
    for frag, packed, label in RUNS:
        true_time(lambda _W, _H, X, frag=frag, packed=packed: frag_kernel(X, frag=frag,
                                                                          packed=packed),
                  None, None, (Yp if packed else Y,), label, reps=args.reps)


if __name__ == "__main__":
    main()
