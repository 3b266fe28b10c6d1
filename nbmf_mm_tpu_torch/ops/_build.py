"""Build the CUDA sources in ``ops/csrc/`` with ``nvcc`` at first use and load
them with ``ctypes``.

The sources expose a plain C interface (no PyTorch headers), and the operand
forms of the passes (``ops/tiers.py``) have sources of their own, so that the
build takes about as long as its longest source.  One ``nvcc -c`` per ``.cu`` file runs in parallel, and one more
call links the objects into a shared library in
``<checkout>/build/nbmf_mm_tpu_torch/`` under a name keyed on a hash of the
sources and flags, so an edit rebuilds it and an unchanged tree reuses it.
Nothing is imported or built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_log", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nbmf_mm_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills, kept in the build log
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # W, H, words, words2, num, den, num_part, den_part, ll_part, ll, wperm,
    # k, Mp, Np, bm, m_real, n_real, nsplit, lanes, eps, device, stream
    "nbmf_hloss_terms_packed": [_P] * 11 + [_I] * 8 + [_F, _I, _P],
    # W, H, words, words2, T, part, k, Mp, Np, bm, n_real, nsplit, lanes, eps,
    # device, stream
    "nbmf_w_terms_packed": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # as nbmf_hloss_terms_packed with dense Ym, Yc in place of the words
    "nbmf_hloss_terms_dense": [_P] * 11 + [_I] * 8 + [_F, _I, _P],
    # as nbmf_w_terms_packed with dense Ym, Ym2 in place of the words
    "nbmf_w_terms_dense": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # W, H, Ym, Yc, ll_part, ll, wperm, k, Mp, Np, bm, m_real, n_real,
    # nsplit, lanes, eps, device, stream
    "nbmf_loglik_sum_dense": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
    # as nbmf_hloss_terms_dense (ll_part, ll, m_real, n_real not read)
    "nbmf_h_terms_dense": [_P] * 11 + [_I] * 8 + [_F, _I, _P],
    # x, part1, part2, out, num, den, k, rows, cols, rows_per_block, bmw,
    # dtype, frag, device, stream
    "nbmf_probe_reduce": [_P] * 6 + [_I] * 8 + [_P],
}
# The operand forms of the production passes (ops/tiers.py), the form's
# suffix on the name, all on the tensor cores.  The bf16 forms
# (sweep_wgmma.cuh: sweep_wgmma_packed.cu, sweep_tiers_bf16r.cu,
# sweep_bf16.cu) take the bf16 copies of the factors as scratch
# (cuda_sweep.plan_wgmma): the H passes wst, hst in place of wperm, the W
# pass wst, hst, hcst after part.  The TF32 forms (sweep_wgmma_tf32.cuh:
# sweep_wgmma_tf32_packed.cu, sweep_wgmma_tf32_dense.cu) take their TF32
# copies: the H passes wt, wk, ht in place of wperm, the W pass wt, ht, hk,
# hck after part.
_PASSES = ("hloss_terms_packed", "w_terms_packed",
           *(f"{dense}_dense" for dense in ("hloss_terms", "w_terms", "loglik_sum", "h_terms")))


def _with_copies(name, h_copies, w_copies):
    """The f32 entry point's signature with the form's staged copies: the
    W pass's after ``part``, the H passes' in place of ``wperm``."""
    sig = _SIGNATURES[f"nbmf_{name}"]
    if name.startswith("w_terms"):
        return sig[:6] + [_P] * w_copies + sig[6:]
    at = sig.index(_I) - 1  # wperm, the last pointer before k
    return sig[:at] + [_P] * h_copies + sig[at + 1:]


_SIGNATURES.update({f"nbmf_{name}_{form}": _with_copies(name, 2, 3)
                    for name in _PASSES for form in ("bf16r", "bf16d")
                    if not (form == "bf16d" and name.endswith("_packed"))})
_SIGNATURES.update({f"nbmf_{name}_tf32r": _with_copies(name, 3, 4) for name in _PASSES})
# W, H, wst, hst, hcst, k, Mp, Np, bm, hc_of_rounded, lanes, device, stream
_SIGNATURES["nbmf_stage_bf16"] = [_P] * 5 + [_I] * 7 + [_P]
# W, H, wt, wk, ht, hk, hck, k, Mp, Np, bm, lanes, device, stream
_SIGNATURES["nbmf_stage_tf32"] = [_P] * 7 + [_I] * 6 + [_P]
# pass, k, second, blocks per SM (int*), shared memory bytes (int*)
_SIGNATURES["nbmf_tf32_occupancy_packed"] = [_I] * 3 + [_P] * 2
_SIGNATURES["nbmf_tf32_occupancy_dense"] = [_I] * 3 + [_P] * 2
# The H- and W-pass probes of probes.cu take the production signatures
# (with lanes == 1).
_SIGNATURES.update(
    {f"nbmf_probe_{name}{suffix}": _SIGNATURES[f"nbmf_{like}"]
     for like, names in (("hloss_terms_packed", ("hloss_product", "hloss_select", "hloss_dense",
                                                 "mxu_plus1", "mxu_data", "mxu_weighted")),
                         ("w_terms_packed", ("w_product", "w_select", "w_chain3_tile")))
     for name in names for suffix in ("", "_bf16")}
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (searched PATH, CUDA_HOME and /usr/local/cuda)")


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def _library_path() -> Path:
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libnbmf_sweep_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """What ``nvcc`` printed when it built the current library (seconds per
    source, ptxas resource usage per kernel), or an empty string if it was
    reused."""
    path = _library_path().with_suffix(".log")
    return path.read_text() if path.exists() else ""


def _compile(out: Path, csrc: Path = CSRC) -> None:
    """``nvcc -c`` every source of ``csrc`` at once, then link into ``out``;
    the log beside it keeps what ptxas printed and the compile's wall time."""
    cu, _ = _sources(csrc)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in cu:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        log = obj.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((src, obj, log, cmd, proc))
    report, failed = [], []
    for src, obj, log, cmd, proc in jobs:
        rc = proc.wait()
        report.append(f"nvcc -c {src.name}: rc {rc}\n" + log.read_text())
        log.unlink()
        if rc != 0:
            failed.append(f"{' '.join(cmd)}\n{report[-1]}")
    report.append(f"nvcc -c of {len(jobs)} sources in parallel: "
                  f"{time.perf_counter() - t0:.2f} s wall\n")
    if failed:
        for job in jobs:
            job[1].unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    objs = [str(job[1]) for job in jobs]
    cmd = [_nvcc(), *_ARCH, "-shared", "-o", str(tmp), *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.unlink(obj)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text("".join(report))
    os.replace(tmp, out)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with ``argtypes`` and
    ``restype`` set on every entry point."""
    out = _library_path()
    if not out.exists():
        _compile(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nbmf_error_string.argtypes = [ctypes.c_int]
    lib.nbmf_error_string.restype = ctypes.c_char_p
    return lib
