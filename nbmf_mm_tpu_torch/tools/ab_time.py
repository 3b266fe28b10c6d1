"""Time the five production kernels (one pair of factors) and the two fused
loops at the headline size from one tree, for comparing two trees on one card.

    python -m nbmf_mm_tpu_torch.tools.ab_time [--root DIR] [--label NAME] [--forms]

``--root`` is a checkout (or a ``git archive`` of a commit unpacked into a
git-ignored directory) that holds ``chip_smoke.py`` and the package; the
script imports both from there, builds that tree's kernels and prints one
``AB`` line with ``chip_smoke.time_kernels``' ms per call and
``chip_smoke.loop_ms_per_sweep``'s ms/sweep, packed and dense, and the card's
name and power limit.  With ``--forms`` it also prints one ``AB_FORMS`` line:
the ms per call of every operand form of the passes
(``chip_smoke.tier_calls``: the bf16 and TF32 forms of the six entry points)
and the fused loops' ms/sweep under ``precision="default"`` and ``"high"``
and on bf16 data.  To compare a change with its parent, run parent,
change, change, parent (and more turns) as separate processes inside one
call on the card, and compare medians.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="the tree to time")
    parser.add_argument("--label", default="here", help="name printed on the AB line")
    parser.add_argument("--forms", action="store_true",
                        help="also time the operand forms and their loops (AB_FORMS line)")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] in ("chip_smoke",
                                                               "nbmf_mm_tpu_torch")]:
        del sys.modules[name]  # this process times the tree at --root, not the caller's
    sm = importlib.import_module("chip_smoke")
    ops = "nbmf_mm_tpu_torch.ops."
    build, cs, ds = (importlib.import_module(ops + name)
                     for name in ("_build", "cuda_sweep", "dense_sweep"))
    build.load_library()
    card = sm.card_line()
    k = sm.HEADLINE["k"]
    X, P = sm.headline_matrix(), sm.mean_matrix()
    times = sm.time_kernels(X, P, k, card, cs, ds)
    packed = sm.loop_ms_per_sweep("binary", X, k, True, card, cs)
    dense = sm.loop_ms_per_sweep("dense", P, k, False, card, cs)
    print("AB", args.label, " ".join(f"{name}={t['ms']:.4f}" for name, t in times.items()),
          f"loop_binary={packed:.3f} loop_dense={dense:.3f} [{card}]", flush=True)
    if args.forms:
        o = sm.operands(X, k, "unmasked", 2, cs)
        d = sm.operands(P, k, "unmasked", 2, cs, weighted=True)
        W, H = o["W"], o["H"]
        forms = {}
        for form in sm.TIER_FORMS:
            calls = {**sm.tier_calls(o, form, cs, ds),
                     **{n: c for n, c in sm.tier_calls(d, form, cs, ds).items() if "packed" not in n}}
            forms.update({name: sm.cuda_ms(lambda: fn(W, H)) for name, (fn, _) in calls.items()})
        loops = {"loop_binary_default": sm.loop_ms_per_sweep("binary", X, k, True, card, cs,
                                                             precision="default"),
                 "loop_dense_default": sm.loop_ms_per_sweep("dense", P, k, False, card, cs,
                                                            precision="default"),
                 "loop_binary_high": sm.loop_ms_per_sweep("binary", X, k, True, card, cs,
                                                          precision="high"),
                 "loop_dense_high": sm.loop_ms_per_sweep("dense", P, k, False, card, cs,
                                                         precision="high"),
                 "loop_dense_bf16": sm.loop_ms_per_sweep("dense", P, k, False, card, cs,
                                                         bf16=True)}
        print("AB_FORMS", args.label, " ".join(f"{name}={t:.4f}" for name, t in forms.items()),
              " ".join(f"{name}={t:.3f}" for name, t in loops.items()), f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
