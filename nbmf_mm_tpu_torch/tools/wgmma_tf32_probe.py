"""One-warpgroup probe of the TF32 tensor-core layouts of the ``"high"`` passes
(``ops/csrc/sweep_wgmma_tf32.cuh``), the quickest check of a change to them.

    python -m nbmf_mm_tpu_torch.tools.wgmma_tf32_probe

Builds ``wgmma_tf32_probe.cu`` (which includes the header) with ``nvcc
-shared`` into ``build/nbmf_mm_tpu_torch/`` and checks, on TF32-rounded
random inputs:

- phase A, ``D1 = X S^T`` with both operands K-major in shared memory, at k
  from 8 to 256 (one to eight swizzle atoms of K), against the exact float64
  product, and how many of ``D1``'s 2048 entries differ bitwise from
  ``torch.mm`` of the same values in fp32 and with TF32 on (the plain
  versions' ``WH``: where it differs, a ``p`` or ``q`` may round the other
  way);
- phase B, the register A operand taken from the accumulator entries in the
  order ``4c, 4c + 2, 4c + 1, 4c + 3`` against a tile in slot8 order, at
  ``KN`` 32, 64, 128, against float64; and the accumulator order on an
  unpermuted tile (the bf16 forms' layout), which must miss;
- the staging kernels against ``cuda_sweep.stage_tf32_plain``, bitwise.

Prints one line per check and ``PROBE OK`` or ``PROBE FAILED`` last; exits 1
on a failure.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, tiers
from ..ops import cuda_sweep as cs

SOURCE = Path(__file__).with_suffix(".cu")
# D1 and phase B against float64: fp32 sums of up to 256 products.
TOL = 1e-5


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "wgmma_tf32_probe.so"
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC), "-o", str(out), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_a.argtypes = [P] * 3 + [I] * 2
    lib.probe_b.argtypes = [P] * 3 + [I] * 2
    lib.probe_stage.argtypes = [P] * 7 + [I] * 5
    return lib


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("wgmma_tf32_probe needs a CUDA card")
    lib = build()
    dev = "cuda"
    rng = np.random.default_rng(0)
    r32 = lambda a: tiers.round_tf32(torch.tensor(a, dtype=torch.float32))
    ok = True
    for k in (8, 13, 40, 128, 200, 256):
        ks = cs.plan_wgmma(k, 64, 64).kstage
        X, S = np.zeros((64, ks), np.float32), np.zeros((32, ks), np.float32)
        X[:, :k], S[:, :k] = rng.random((64, k)), rng.random((32, k))
        Xd, Sd = r32(X).to(dev), r32(S).to(dev)
        D = torch.empty((64, 32), device=dev)
        err = lib.probe_a(Xd.data_ptr(), Sd.data_ptr(), D.data_ptr(), k, ks)
        ref = Xd.double() @ Sd.double().T
        rel = ((D.double() - ref).abs().max() / ref.abs().max()).item()
        saved = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = False
            f32 = Xd @ Sd.T
            torch.backends.cuda.matmul.allow_tf32 = True
            t32 = Xd @ Sd.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        print(f"phase A k={k} (kstage {ks}): rc {err}, max rel err against float64 {rel:.3e}; "
              f"D1 entries != torch.mm fp32 {int((D != f32).sum())}/2048, != torch.mm TF32 "
              f"{int((D != t32).sum())}/2048", flush=True)
        ok &= err == 0 and rel < TOL
    order = cs.phase_b_order(32)
    for kn in (32, 64, 128):
        Pd = r32(rng.random((64, 32)).astype(np.float32) * 3).to(dev)
        B = r32(rng.random((kn, 32)).astype(np.float32))
        ref = Pd.double() @ B.double().T.to(dev)
        for variant, tile in ((0, B[:, order]), (1, B)):
            Bd = tile.contiguous().to(dev)
            out = torch.empty((64, kn), device=dev)
            err = lib.probe_b(Pd.data_ptr(), Bd.data_ptr(), out.data_ptr(), kn, variant)
            rel = ((out.double() - ref).abs().max() / ref.abs().max()).item()
            print(f"phase B KN={kn} {'slot8 order' if variant == 0 else 'accumulator order'}: "
                  f"rc {err}, max rel err against float64 {rel:.3e}", flush=True)
            ok &= err == 0 and (rel < TOL if variant == 0 else rel > TOL)
    for (m, n), k, lanes in (((1000, 1234), 17, 1), ((300, 200), 200, 2), ((10_000, 10_000), 128, 1),
                             ((20, 100), 8, 1)):
        bm, Mp, Np = cs.plan_packing(m, n)
        plan = cs.plan_wgmma(k, Mp, Np)
        W = torch.tensor(rng.random((lanes, k, Mp)), dtype=torch.float32)
        H = torch.tensor(rng.random((lanes, k, Np)) * 1.7 - 0.3, dtype=torch.float32)
        want = cs.stage_tf32_plain(W, H, bm, plan)
        Wd, Hd = W.to(dev), H.to(dev)
        got = [torch.full(t.shape, 7.0, device=dev) for t in want]
        err = lib.probe_stage(Wd.data_ptr(), Hd.data_ptr(), *(t.data_ptr() for t in got), k, Mp,
                              Np, bm, lanes)
        same = [torch.equal(g.cpu(), w) for g, w in zip(got, want)]
        print(f"staging {m}x{n} k={k} lanes={lanes}: rc {err}, == plain {same}", flush=True)
        ok &= err == 0 and all(same)
    print("PROBE OK" if ok else "PROBE FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
