"""Run one cell of the benchmark and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run is a new process: it loads the program, makes the cell's data on
the card from the seed, warms up, measures for ``--seconds`` seconds, checks
one fit of the window against the plain reference, and prints the card's
state at the start and the end of the window, then one JSON line, last on
standard output.  The numbers compared, each beside its limit, are the last
lines on standard error.  A run that finds no card, fewer cards than the
cell asks for, or JAX or the JAX package loaded once the window has closed
prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Modules whose top-level name may not be loaded in a run: JAX, and the JAX
# package (compared whole: the program's name begins with it).
FORBIDDEN = {"jax", "jaxlib", "flax", "nbmf_mm_tpu"}


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def cache_dirs(root: Path = ROOT) -> dict:
    """The program's build and kernel caches, at fixed paths in the
    checkout, so that only the first run of a checkout builds."""
    build = root / "build"
    return {"NBMF_CACHE_DIR": str(build / "nbmf_mm_tpu_torch"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(cache_dirs())

    from portbench.manifest import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)  # one process, few threads: steadier host work

    from portbench import harness

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    start, end = out["states"]
    print(f"device: start [{start}] end [{end}] ({harness.SMI_QUERY})")
    result = out["result"]
    print(f"portbench: {args.workload} seed {args.seed}: {result['attempted']} fits in "
          f"{out['window_s']:.3f} s; checked fit random_state {out['random_state']}, "
          f"lane {out['lane']}; set-up " + ", ".join(
              f"{k} {v:.3f} s" for k, v in out["setup_parts"].items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
