"""Validate the algorithm's guarantees on synthetic data, both orientations,
masked and unmasked (the counterpart of the repository's
``experiments/validate_implementation.py``): monotone MAP descent, the
simplex and box constraints, masked training.  Float64, on ``--device``
(the plain loop; float64 is the regime of the 1e-12 descent bound).

    python -m nbmf_mm_tpu_torch.experiments.validate_implementation --device cuda

Exit code 0 iff every check passes.
"""

from __future__ import annotations

import argparse

import numpy as np


def check(label, ok):
    print(f"  [{'PASS' if ok else 'FAIL'}] {label}", flush=True)
    return bool(ok)


def validate(orientation: str, masked: bool, device) -> bool:
    from .. import NBMF
    from ..utils import generate_synthetic_binary_data

    X, _, _ = generate_synthetic_binary_data(n_samples=80, n_features=60, n_components=5,
                                             random_state=0)
    mask = None
    if masked:
        mask = (np.random.default_rng(1).random(X.shape) < 0.85).astype(float)
    kw = dict(n_components=5, orientation=orientation, max_iter=200, tol=1e-7, random_state=0,
              dtype="float64", device=device)
    model = NBMF(**kw).fit(X, mask=mask)
    hist = np.asarray(model.objective_history_)
    ok = True
    title = f"{orientation}{' masked' if masked else ''}"
    print(f"{title}: {model.n_iter_} iters, final loss {model.loss_:.6f}", flush=True)
    if masked:
        # The reference's masked semantics (mask_mode="parity") are not a
        # true MM scheme (the monitored loss counts unobserved entries as
        # zeros), so tiny late increases occur, in the reference too; its
        # own masked test checks 30 sweeps.  The corrected mode carries the
        # full guarantee.
        ok &= check("monotone MAP descent, first 30 sweeps (reference masked contract)",
                    np.all(np.diff(hist[:30]) <= 1e-12))
        corrected = NBMF(**kw, mask_mode="corrected").fit(X, mask=mask)
        ok &= check("monotone MAP descent, all sweeps (mask_mode='corrected')",
                    np.all(np.diff(np.asarray(corrected.objective_history_)) <= 1e-12))
    else:
        ok &= check("monotone MAP descent (<= 1e-12 increase)", np.all(np.diff(hist) <= 1e-12))
    ok &= check("finite losses", np.all(np.isfinite(hist)))
    if orientation == "beta-dir":
        ok &= check("W rows on simplex", np.allclose(model.W_.sum(axis=1), 1.0, atol=1e-9))
        ok &= check("H in [0,1]", np.all((model.components_ >= 0) & (model.components_ <= 1)))
        ok &= check("H continuous", len(np.unique(model.components_)) > 50)
    else:
        ok &= check("H cols on simplex",
                    np.allclose(model.components_.sum(axis=0), 1.0, atol=1e-9))
        ok &= check("W in [0,1]", np.all((model.W_ >= 0) & (model.W_ <= 1)))
        ok &= check("W continuous", len(np.unique(model.W_)) > 50)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ok = True
    for orientation in ("beta-dir", "dir-beta"):
        for masked in (False, True):
            ok &= validate(orientation, masked, args.device)
    print("\nALL CHECKS PASSED" if ok else "\nSOME CHECKS FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
