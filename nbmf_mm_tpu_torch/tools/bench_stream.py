"""Stream rate of reading the data matrix once, by row-block height and
type.

    python -m nbmf_mm_tpu_torch.tools.bench_stream [--mn 10240] [--reps 5]

Each configuration sums the ``(M, N)`` matrix with the reduction probe
(blocks of ``bm`` rows, 256 columns wide; ``bn`` is the TPU tile's width
and only has to divide N) and prints ms/call and GB/s of the one read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.probes import stream_kernel
from .bench_true import arg_parser, device_of, true_time

__all__ = ["stream_kernel", "configs"]


def configs(Np):
    """The tools' tile shapes (bm, bn, dtype)."""
    return [(512, 512, "f32"), (512, 1024, "f32"), (512, 2048, "f32"), (256, 2048, "f32"),
            (1024, 2048, "f32"), (256, Np, "f32"), (512, Np, "f32"), (512, 512, "bf16"),
            (512, Np, "bf16"), (256, Np, "bf16")]


def main(argv=None):
    args = arg_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of(args)
    Mp = Np = args.mn
    rng = np.random.default_rng(0)
    Yf = torch.tensor(rng.random((Mp, Np)) < 0.3, dtype=torch.float32, device=dev)
    Yb = Yf.to(torch.bfloat16)
    print(f"{Mp}x{Np}", flush=True)
    for bm, bn, dt in configs(Np):
        Y = Yf if dt == "f32" else Yb
        fn = stream_kernel(Mp, Np, bm, bn, dt)
        ms = true_time(lambda _W, _H, Y: fn(Y), None, None, (Y,), "", reps=args.reps,
                       quiet=True)
        print(f"tile ({bm:5d},{bn:5d}) {dt} : {ms:7.3f} ms  "
              f"{Y.numel() * Y.element_size() / ms / 1e6:7.1f} GB/s", flush=True)


if __name__ == "__main__":
    main()
