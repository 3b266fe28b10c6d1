"""Read the numbers that the limits of a cell are set from, on the card, in
one process: for each seed, one fit of the timed path (the window's own
``solve`` call at the cell's sizes, through :func:`portbench.harness.fit`);
for the control seeds, the same fit under ``precision="high"`` (the
program's own TF32 path, the nearest precision below the float32 that the
traffic states); for the fault seeds, the same fit with each fault of
:mod:`portbench.faults` that the cell can have planted underneath.  Each fit
is held by :mod:`portbench.compare` to one run of the plain reference from
the same data and inits.

    python -m portbench.calibrate --workload flagship_fit --seeds 1 2 3 ... \\
        --control-seeds 1 2 3 --fault-seeds 1 2 3

Prints one JSON line a seed: the sound fit's numbers, the control's and each
fault's where they ran, the reference's lane choice, and the seconds each
part took.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from contextlib import nullcontext

import numpy as np

CONTROL = "high"  # the program's TF32 path: the precision below the cells' float32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from portbench.run import cache_dirs

    os.environ.update(cache_dirs())
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2

    from portbench import compare, data, faults, harness
    from portbench.manifest import load_cell

    cell = load_cell(args.workload)
    c, device = cell.config, torch.device("cuda")
    sweeps, tier = int(cell.traffic["sweeps"]), cell.traffic["precision"]
    for seed in args.seeds:
        times = {}
        t = time.perf_counter()
        with data.ieee_fp32():
            X = harness.program_input(cell, data.Recipe(c, seed, device), device)
        torch.cuda.synchronize()
        times["data_s"] = time.perf_counter() - t
        runs = [("sound", tier, nullcontext)]
        if seed in args.control_seeds:
            runs.append(("control", CONTROL, nullcontext))
        if seed in args.fault_seeds:
            runs += [(name, tier, lambda name=name: faults.planted(name))
                     for name in faults.applicable(cell.lanes, "mask_mode" in cell.traffic)]
        fits = {}
        for label, precision, planted in runs:
            t = time.perf_counter()
            with planted():
                res = harness.fit(cell, X, random_state=seed, sweeps=sweeps,
                                  precision=precision, device=device)
            torch.cuda.synchronize()
            times[f"{label}_fit_s"] = time.perf_counter() - t
            fits[label] = harness.kept(res, seed)
            del res
        del X
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = harness.reference_fit(cell, seed, seed, device)
        torch.cuda.synchronize()
        times["reference_s"] = time.perf_counter() - t
        ref_final = ref[2][:, -1].cpu().numpy()
        order = np.sort(ref_final)
        line = {"workload": args.workload, "seed": seed, "times": times,
                "ref_best": int(np.argmin(ref_final)),
                "ref_best_margin": (float((order[1] - order[0]) / abs(order[0]))
                                    if len(order) > 1 else None)}
        for label, f in fits.items():
            f = {k: v.to(device) if torch.is_tensor(v) else v for k, v in f.items()}
            numbers = compare.gaps(f, ref, cell.limits)
            line[label] = {"best": int(f["best"]), **numbers,
                           "correct": compare.verdict(numbers, cell.limits)[0]}
        del ref, fits
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
