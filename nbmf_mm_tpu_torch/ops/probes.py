"""Measurement probes: the counterparts of the ten Pallas probes in the
repository's ``tools/`` scripts, which split one sweep pass into its matmul,
elementwise and memory-stream costs.

Each function keeps its ``tools/`` name and signature and has a plain
PyTorch version beside it (``<name>_plain``).  CPU tensors take the plain
version; CUDA tensors launch the kernel in ``csrc/probes.cu`` on the current
stream, or raise.  ``LAUNCHES`` counts kernel launches per ``tools/``
kernel.  ``make_kernel`` and ``stream_kernel`` return a callable, as theirs
do.

Conventions of the ``tools/`` probes, kept here:

- ``b = 1 - WH + eps`` is not clamped at 0 (the library kernels clamp it);
- where a probe's log-likelihood is unmasked it runs over all ``Mp x Np``;
- ``mxu_dtype=torch.bfloat16`` (and ``make_kernel``'s ``precision`` None or
  ``"default"``, the TPU's one-pass bf16 matmul) rounds W, H and the values
  fed to each matmul to bf16 (nearest even); products and sums stay fp32.

The kernels run the production tiling, whatever ``block_m``/``block_n``
the TPU probe used for its grid: those change only the order in which the
port adds, and where the TPU needs them (stripes of ``w_packed``, the
bit-plane layout, ``mxu_only``'s per-stripe ``o2 += o1``) the port takes
them as the TPU does.
"""

from __future__ import annotations

import torch

from . import cuda_sweep as cs
from . import tiers

__all__ = [
    "LAUNCHES",
    "make_kernel",
    "hloss_packed",
    "w_packed",
    "hloss_packed2",
    "w_packed2",
    "mxu_only",
    "mxu_probe",
    "hloss_ngrid",
    "stream_kernel",
    "frag_kernel",
]

LAUNCHES = {name: 0 for name in (
    "make_kernel", "hloss_packed", "w_packed", "hloss_packed2", "w_packed2", "mxu_only",
    "mxu_probe", "hloss_ngrid", "stream_kernel", "frag_kernel")}

# The reduction probe's fragments (csrc/probes.cu ``Frag``): frag_kernel's
# names, then make_kernel's two reduction kinds.
_FRAGMENTS = {"stream_sum": 0, "unpack_concat_int": 1, "unpack_concat_sign": 2,
              "unpack_repeat_shift": 3, "ratios": 4, "loss2log": 5, "loss1log": 6}
_HBM_ONLY, _VPU_ONLY = 7, 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


# ------------------------------------------------------------------ helpers
def _is_bf16(mxu_dtype) -> bool:
    if mxu_dtype is None:
        return False
    if mxu_dtype != torch.bfloat16:
        raise ValueError(f"mxu_dtype must be None or torch.bfloat16, got {mxu_dtype}")
    return True


def _mxu(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A matmul operand as the probe feeds it: rounded to bf16 or as is."""
    return x.to(torch.bfloat16).to(x.dtype) if bf16 else x


def _ratios(W, H, eps, bf16):
    """``(Wm, Hm, a, b, r)`` with the unclamped ``b`` of the probes."""
    Wm, Hm = _mxu(W, bf16), _mxu(H, bf16)
    wh = Wm.T @ Hm
    a = wh + eps
    b = 1.0 - wh + eps
    return Wm, Hm, a, b, 1.0 / (a * b)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.float64)


def _scalar(s: torch.Tensor) -> torch.Tensor:
    """A float64 sum as the probes' (1, 1) float32 output."""
    return s.to(torch.float32).reshape(1, 1)


def _suffix(bf16: bool) -> str:
    return "_bf16" if bf16 else ""


def _hloss_select_plain(W, H, bit, *, eps, bf16):
    """H pass on a bool operand, select form, one log, ll unmasked."""
    Wm, _, a, b, r = _ratios(W, H, eps, bf16)
    p = torch.where(bit, b * r, 0.0)
    q = torch.where(bit, 0.0, a * r)
    ll = _sum(torch.log(torch.where(bit, a, b)))
    return Wm @ _mxu(p, bf16), Wm @ _mxu(q, bf16), ll.to(W.dtype)


def _hloss_product_plain(W, H, ym, *, eps, bf16):
    """H pass on a float operand, products, two logs, ll unmasked."""
    Wm, _, a, b, r = _ratios(W, H, eps, bf16)
    p = ym * (b * r)
    q = (1.0 - ym) * (a * r)
    ll = _sum(ym * torch.log(a) + (1.0 - ym) * torch.log(b))
    return Wm @ _mxu(p, bf16), Wm @ _mxu(q, bf16), ll.to(W.dtype)


def _w_one_matmul_plain(H_new, pmq, q, *, bf16):
    """The one-matmul W form ``T = H (P - Q)^T + sum_n Q``."""
    return _mxu(H_new, bf16) @ _mxu(pmq, bf16).T + q.sum(dim=1)[None, :]


def _check_words(who, Yp, block_m):
    if Yp.dtype != torch.int32:
        raise TypeError(f"{who}: packed words must be int32, got {Yp.dtype}")
    cs._check_stripe(Yp.shape[0] * cs.PACKED_WORD_BITS, block_m, who)


def _launch_h(entry, who, W, H, y, *, eps, bm, loss=True):
    Mp, Np = W.shape[1], H.shape[1]
    return cs._launch_hloss(entry, who, W, H, y, None, eps=eps, m_real=Mp, n_real=Np, bm=bm,
                            loss=loss)


# -------------------------------------------- H passes (bench_packed*.py)
def hloss_packed_plain(W, H, Yp, *, eps=1e-8, block_m=256, mxu_dtype=None):
    """Plain version of :func:`hloss_packed`."""
    ym = cs.unpack_bits(Yp, block_m, dtype=W.dtype)
    return _hloss_product_plain(W, H, ym, eps=eps, bf16=_is_bf16(mxu_dtype))


def hloss_packed(W, H, Yp, *, eps=1e-8, block_m=256, mxu_dtype=None):
    """``tools/bench_packed.py::hloss_packed``: the H pass over stripe-packed
    words with ``ym`` unpacked to a float, ``p = ym (b r)``, two logs and
    ``ll`` unmasked.  Returns ``(Num, Den, ll)``."""
    _check_words("hloss_packed", Yp, block_m)
    if W.device.type == "cpu":
        return hloss_packed_plain(W, H, Yp, eps=eps, block_m=block_m, mxu_dtype=mxu_dtype)
    bf16 = _is_bf16(mxu_dtype)
    cs._check_cuda_operands("hloss_packed", W, H, Yp, None, block_m)
    out = _launch_h("nbmf_probe_hloss_product" + _suffix(bf16), "hloss_packed", W, H, Yp,
                    eps=eps, bm=block_m)
    LAUNCHES["hloss_packed"] += 1
    return out


def hloss_packed2_plain(W, H, Yp, *, eps=1e-8, block_m=256, mxu_dtype=None):
    """Plain version of :func:`hloss_packed2`."""
    bit = cs._unpack_planes(Yp, block_m)
    return _hloss_select_plain(W, H, bit, eps=eps, bf16=_is_bf16(mxu_dtype))


def hloss_packed2(W, H, Yp, *, eps=1e-8, block_m=256, mxu_dtype=None):
    """``tools/bench_packed2.py::hloss_packed2``: the select form of
    :func:`hloss_packed`, ``ll = sum log(where(bit, a, b))``; its Num/Den
    equal :func:`hloss_packed`'s bitwise."""
    _check_words("hloss_packed2", Yp, block_m)
    if W.device.type == "cpu":
        return hloss_packed2_plain(W, H, Yp, eps=eps, block_m=block_m, mxu_dtype=mxu_dtype)
    bf16 = _is_bf16(mxu_dtype)
    cs._check_cuda_operands("hloss_packed2", W, H, Yp, None, block_m)
    out = _launch_h("nbmf_probe_hloss_select" + _suffix(bf16), "hloss_packed2", W, H, Yp,
                    eps=eps, bm=block_m)
    LAUNCHES["hloss_packed2"] += 1
    return out


def hloss_ngrid_plain(W, H, Y, *, eps=1e-8, block_n=256, mxu_dtype=None, packed=False):
    """Plain version of :func:`hloss_ngrid`."""
    bf16 = _is_bf16(mxu_dtype)
    if packed:
        bit = cs._unpack_planes(Y, Y.shape[0] * cs.PACKED_WORD_BITS)
        return _hloss_select_plain(W, H, bit, eps=eps, bf16=bf16)
    return _hloss_product_plain(W, H, Y, eps=eps, bf16=bf16)


def hloss_ngrid(W, H, Y, *, eps=1e-8, block_n=256, mxu_dtype=None, packed=False):
    """``tools/bench_packed3.py::hloss_ngrid``: the H pass with ``ll``
    unmasked, on dense ``Y`` (two logs) or, with ``packed``, on
    :func:`~nbmf_mm_tpu_torch.tools.bench_packed3.pack_bits_global` words
    (selects, one log).  W needs no permutation: the global bit planes are
    stripe packing with ``bm = Mp``, which the kernel walks.  The packed
    form equals the dense one bitwise on binary data.  ``block_n`` is the
    TPU's column stripe and must divide ``Np``."""
    Np = H.shape[1]
    if block_n < 1 or Np % block_n:
        raise ValueError(f"hloss_ngrid: block_n={block_n} does not divide Np={Np}")
    Mp = W.shape[1]
    if packed:
        _check_words("hloss_ngrid", Y, Mp)
    if W.device.type == "cpu":
        return hloss_ngrid_plain(W, H, Y, eps=eps, block_n=block_n, mxu_dtype=mxu_dtype,
                                 packed=packed)
    bf16 = _is_bf16(mxu_dtype)
    cs._check_cuda_operands("hloss_ngrid", W, H, Y, None, Mp, dense=not packed)
    entry = "nbmf_probe_hloss_" + ("select" if packed else "dense") + _suffix(bf16)
    out = _launch_h(entry, "hloss_ngrid", W, H, Y, eps=eps, bm=Mp)
    LAUNCHES["hloss_ngrid"] += 1
    return out


# ------------------------------------------------ one-matmul W passes
def w_packed_plain(W, H_new, Yp, *, n_real, eps=1e-8, block_m=256, mxu_dtype=None):
    """Plain version of :func:`w_packed`."""
    bf16 = _is_bf16(mxu_dtype)
    ym = cs.unpack_bits(Yp, block_m, dtype=W.dtype)
    _, _, a, b, r = _ratios(W, H_new, eps, bf16)
    col = torch.arange(ym.shape[1], device=ym.device)[None, :]
    p = ym * (b * r)
    q = torch.where(col < n_real, 1.0 - ym, 0.0) * (a * r)
    return _w_one_matmul_plain(H_new, p - q, q, bf16=bf16)


def w_packed(W, H_new, Yp, *, n_real, eps=1e-8, block_m=256, mxu_dtype=None):
    """``tools/bench_packed.py::w_packed``: the one-matmul W form
    ``T = H (P - Q)^T + sum_n Q`` over stripe-packed words, ``Q`` masked to
    ``col < n_real``.  A probe only: the form cancels when ``q ~ 1e8`` near
    ``WH -> 1``, and the solver keeps the two nonnegative accumulations of
    :func:`~nbmf_mm_tpu_torch.ops.cuda_sweep.w_terms_packed`."""
    _check_words("w_packed", Yp, block_m)
    if W.device.type == "cpu":
        return w_packed_plain(W, H_new, Yp, n_real=n_real, eps=eps, block_m=block_m,
                              mxu_dtype=mxu_dtype)
    bf16 = _is_bf16(mxu_dtype)
    cs._check_cuda_operands("w_packed", W, H_new, Yp, None, block_m)
    T = cs._launch_wterms("nbmf_probe_w_product" + _suffix(bf16), "w_packed", W, H_new, Yp,
                          None, eps=eps, n_real=n_real, bm=block_m)
    LAUNCHES["w_packed"] += 1
    return T


def w_packed2_plain(W, H_new, Yp, *, n_real, eps=1e-8, block_m=256, mxu_dtype=None):
    """Plain version of :func:`w_packed2`."""
    bf16 = _is_bf16(mxu_dtype)
    bit = cs._unpack_planes(Yp, block_m)
    _, _, a, b, r = _ratios(W, H_new, eps, bf16)
    valid = torch.arange(bit.shape[1], device=bit.device)[None, :] < n_real
    q = torch.where(~bit & valid, a * r, 0.0)
    return _w_one_matmul_plain(H_new, torch.where(bit, b * r, -q), q, bf16=bf16)


def w_packed2(W, H_new, Yp, *, n_real, eps=1e-8, block_m=256, mxu_dtype=None):
    """``tools/bench_packed2.py::w_packed2``: the select form of
    :func:`w_packed` (``P - Q = where(bit, b r, -q)``); a probe only, as
    :func:`w_packed`."""
    _check_words("w_packed2", Yp, block_m)
    if W.device.type == "cpu":
        return w_packed2_plain(W, H_new, Yp, n_real=n_real, eps=eps, block_m=block_m,
                               mxu_dtype=mxu_dtype)
    bf16 = _is_bf16(mxu_dtype)
    cs._check_cuda_operands("w_packed2", W, H_new, Yp, None, block_m)
    T = cs._launch_wterms("nbmf_probe_w_select" + _suffix(bf16), "w_packed2", W, H_new, Yp,
                          None, eps=eps, n_real=n_real, bm=block_m)
    LAUNCHES["w_packed2"] += 1
    return T


# ------------------------------------------------------ matmul-only probes
def mxu_only_plain(W, H, X3=None, *, n_mm=3, block_m=256, mxu_dtype=None):
    """Plain version of :func:`mxu_only`: the TPU's stripe loop."""
    bf16 = _is_bf16(mxu_dtype)
    Wm, Hm = _mxu(W, bf16), _mxu(H, bf16)
    o1 = torch.zeros((W.shape[0], H.shape[1]), dtype=W.dtype, device=W.device)
    o2 = torch.zeros_like(o1)
    for j0 in range(0, W.shape[1], block_m):
        w = Wm[:, j0:j0 + block_m]
        wh = w.T @ Hm
        o1 += w @ _mxu(wh, bf16)
        o2 += w @ _mxu(wh + 1.0, bf16) if n_mm >= 3 else o1
    return o1, o2


def _check_mxu_only(W, n_mm, block_m):
    if n_mm not in (2, 3):
        raise ValueError(f"mxu_only: n_mm must be 2 or 3, got {n_mm}")
    cs._check_stripe(W.shape[1], block_m, "mxu_only")


def mxu_only(W, H, X3=None, *, n_mm=3, block_m=256, mxu_dtype=None):
    """``tools/bench_packed2.py::mxu_only``: the H pass's matmuls alone, no
    data.  ``n_mm=3``: ``o1 = W WH``, ``o2 = W (WH + 1)``; ``n_mm=2``:
    ``o2 += o1`` after each stripe's update, so ``o2 = sum_j (S - j) c_j``
    over the ``S`` stripes of ``block_m`` rows.  ``X3`` is not read."""
    _check_mxu_only(W, n_mm, block_m)
    if W.device.type == "cpu":
        return mxu_only_plain(W, H, X3, n_mm=n_mm, block_m=block_m, mxu_dtype=mxu_dtype)
    out = _mxu_chain(W, H, n_mm, block_m, _is_bf16(mxu_dtype), "mxu_only")
    LAUNCHES["mxu_only"] += 1
    return out


def _mxu_chain(W, H, n_mm, block_m, bf16, who):
    cs._check_cuda_operands(who, W, H, None, None, block_m)
    entry = "nbmf_probe_mxu_" + ("plus1" if n_mm == 3 else "weighted") + _suffix(bf16)
    num, den, _ = _launch_h(entry, who, W, H, None, eps=0.0, bm=block_m, loss=False)
    return num, den


def mxu_probe_plain(W, H, *, variant, block_m=256, mxu_dtype=None):
    """Plain version of :func:`mxu_probe`."""
    if variant == "chain3_acc":
        return mxu_only_plain(W, H, n_mm=3, block_m=block_m, mxu_dtype=mxu_dtype)
    if variant != "chain3_tile":
        raise ValueError(variant)
    bf16 = _is_bf16(mxu_dtype)
    Hm = _mxu(H, bf16)
    wh = _mxu(W, bf16).T @ Hm
    return Hm @ _mxu(wh, bf16).T, Hm @ _mxu(wh + 1.0, bf16).T


def mxu_probe(W, H, *, variant, block_m=256, mxu_dtype=None):
    """``tools/bench_packed3.py::mxu_probe``: ``"chain3_acc"`` is
    :func:`mxu_only` with ``n_mm=3`` (``(k, Np)`` outputs);
    ``"chain3_tile"`` the W-pass shape, ``t1 = H WH^T`` and
    ``t2 = H (WH + 1)^T`` (``(k, Mp)`` each, written once)."""
    if variant not in ("chain3_acc", "chain3_tile"):
        raise ValueError(variant)
    cs._check_stripe(W.shape[1], block_m, "mxu_probe")
    if W.device.type == "cpu":
        return mxu_probe_plain(W, H, variant=variant, block_m=block_m, mxu_dtype=mxu_dtype)
    bf16 = _is_bf16(mxu_dtype)
    if variant == "chain3_acc":
        out = _mxu_chain(W, H, 3, block_m, bf16, "mxu_probe")
    else:
        cs._check_cuda_operands("mxu_probe", W, H, None, None, block_m)
        T = cs._launch_wterms("nbmf_probe_w_chain3_tile" + _suffix(bf16), "mxu_probe", W, H,
                              None, None, eps=0.0, n_real=H.shape[1], bm=block_m, n_out=2)
        out = (T[:W.shape[0]], T[W.shape[0]:])
    LAUNCHES["mxu_probe"] += 1
    return out


# --------------------------------------------------- the reduction probe
def _check_reduce(who, X, dtypes):
    if X.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {X.device}")
    if X.dtype not in dtypes:
        raise TypeError(f"{who}: operand must be one of {dtypes}, got {X.dtype}")
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"{who}: operand must be a contiguous matrix")


def _launch_reduce(who, X, frag, rows_per_block, bmw, k=0):
    """Launch the reduction probe on the current stream: a (1, 1) scalar, or
    ``(num, den)`` (``(k, cols)`` each) for make_kernel's two kinds."""
    from ._build import load_library

    lib = load_library()
    rows, cols = X.shape
    if rows % rows_per_block:
        raise ValueError(f"{who}: {rows_per_block} rows per block do not divide {rows}")
    dev = X.device
    nrb = rows // rows_per_block
    columns = frag in (_HBM_ONLY, _VPU_ONLY)
    f32 = dict(dtype=torch.float32, device=dev)
    if columns:
        part1 = torch.empty((nrb, cols), dtype=torch.float64, device=dev)
        part2 = torch.empty_like(part1)
        out, num, den = None, torch.empty((k, cols), **f32), torch.empty((k, cols), **f32)
    else:
        part1 = torch.empty(-(-cols // 256) * nrb, dtype=torch.float64, device=dev)
        part2 = num = den = None
        out = torch.empty((1, 1), **f32)
    err = lib.nbmf_probe_reduce(
        X.data_ptr(), part1.data_ptr(), cs._ptr(part2), cs._ptr(out), cs._ptr(num),
        cs._ptr(den), k, rows, cols, rows_per_block, bmw, _DTYPE_CODE[X.dtype], frag,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    cs._raise_on_error(lib, who, err)
    return (num, den) if columns else out


def stream_kernel_plain(Y):
    """Plain version of :func:`stream_kernel`'s callable."""
    return _scalar(_sum(Y.to(torch.float32)))


def stream_kernel(Mp, Np, bm, bn, dtype):
    """``tools/bench_stream.py::stream_kernel``: a callable ``fn(Y)`` giving
    the (1, 1) sum of an ``(Mp, Np)`` ``"f32"`` or ``"bf16"`` matrix.  The
    kernel's blocks take ``bm`` rows; ``bn`` must divide ``Np``."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    if Mp % bm or Np % bn:
        raise ValueError(f"stream_kernel: tile ({bm}, {bn}) does not divide ({Mp}, {Np})")

    def fn(Y):
        if tuple(Y.shape) != (Mp, Np) or Y.dtype != dtype:
            raise ValueError(f"stream_kernel: expected {dtype} ({Mp}, {Np}), got {Y.dtype} "
                             f"{tuple(Y.shape)}")
        if Y.device.type == "cpu":
            return stream_kernel_plain(Y)
        _check_reduce("stream_kernel", Y, (dtype,))
        out = _launch_reduce("stream_kernel", Y, _FRAGMENTS["stream_sum"], bm, 1)
        LAUNCHES["stream_kernel"] += 1
        return out

    return fn


def frag_kernel_plain(X, *, frag, bm=256, packed=False):
    """Plain version of :func:`frag_kernel`."""
    if frag in ("unpack_concat_int", "unpack_concat_sign", "unpack_repeat_shift"):
        bmw = bm // cs.PACKED_WORD_BITS
        if frag == "unpack_repeat_shift":
            i = torch.arange(X.shape[0], device=X.device)[:, None] % bmw
        else:
            i, bmw = 0, 1
        return _scalar(sum(_sum((X >> ((i + bmw * t) % 32)) & 1)
                           for t in range(cs.PACKED_WORD_BITS)))
    x = X.to(torch.float32)
    if frag == "stream_sum":
        return _scalar(_sum(x))
    if frag == "ratios":
        wh = x * 0.5
        a = wh + 1e-8
        b = 1.0 - wh + 1e-8
        r = 1.0 / (a * b)
        return _scalar(_sum(a * r) + _sum(b * r))
    a = x * 0.4 + 0.3
    b = 1.0 - a
    if frag == "loss2log":
        return _scalar(_sum(x * torch.log(a) + (1.0 - x) * torch.log(b)))
    if frag == "loss1log":
        return _scalar(_sum(torch.log(torch.where(x > 0.5, a, b))))
    raise ValueError(frag)


def frag_kernel(X, *, frag, bm=256, packed=False):
    """``tools/bench_vpu.py::frag_kernel``: the (1, 1) sum of one fragment
    per element over stripes of ``bm`` rows (``bm/32`` word rows when
    ``packed``).  The unpack fragments take int32 words; ``stream_sum`` adds
    words as signed int32 values cast to f32.  ``unpack_repeat_shift``
    computes what ``pltpu.repeat`` tiling gives: stripe row ``r`` reads word
    row ``r mod bm/32`` at bit ``r mod 32``, not the bit count."""
    if frag not in _FRAGMENTS:
        raise ValueError(frag)
    words_only = frag.startswith("unpack_")
    if frag != "stream_sum" and packed != words_only:
        raise ValueError(f"frag_kernel: {frag} {'needs' if words_only else 'takes no'} "
                         "packed words")
    rows = bm // cs.PACKED_WORD_BITS if packed else bm
    if bm % cs.PACKED_WORD_BITS or X.shape[0] % rows:
        raise ValueError(f"frag_kernel: bm={bm} does not tile {X.shape[0]} rows")
    if X.device.type == "cpu":
        return frag_kernel_plain(X, frag=frag, bm=bm, packed=packed)
    _check_reduce("frag_kernel", X, (torch.int32,) if packed else (torch.float32,))
    out = _launch_reduce("frag_kernel", X, _FRAGMENTS[frag], rows, bm // cs.PACKED_WORD_BITS)
    LAUNCHES["frag_kernel"] += 1
    return out


# ----------------------------------------------- bench_diag.py::make_kernel
def _highest(precision) -> bool:
    """make_kernel's precision: None or "default" is the TPU's one-pass bf16
    matmul, "highest" fp32 (the tier names of :mod:`.tiers`; the probe has
    no "high" form)."""
    tier = "default" if precision is None else tiers.resolve_tier(precision)
    if tier == "high":
        raise ValueError(f"make_kernel: precision must be None, 'default' or 'highest', "
                         f"got {precision}")
    return tier == "highest"


def make_kernel_plain(kind, k, Mp, Np, bm, bn, precision):
    """Plain version of :func:`make_kernel`."""
    bf16 = not _highest(precision)

    def fn(W, H, Y):
        if kind == "mxu_only":
            Wm = _mxu(W, bf16)
            wh = Wm.T @ _mxu(H, bf16)
            return Wm @ _mxu(wh + Y, bf16), Wm @ _mxu(wh - Y, bf16)
        if kind == "hbm_only":
            num, den = _sum_cols(Y), torch.full((Np,), float(Mp // bm), device=Y.device)
        elif kind == "vpu_only":
            a = Y + 1e-8
            b = 1.0 - Y + 1e-8
            r = 1.0 / (a * b)
            ll = Y * torch.log(a) + (1.0 - Y) * torch.log(b)
            num, den = _sum_cols(Y * (b * r) + ll), _sum_cols((1.0 - Y) * (a * r))
        else:
            raise ValueError(kind)
        return tuple(v.to(torch.float32)[None, :].expand(k, Np).contiguous()
                     for v in (num, den))

    return fn


def _sum_cols(x):
    return x.sum(dim=0, dtype=torch.float64)


def make_kernel(kind, k, Mp, Np, bm, bn, precision):
    """``tools/bench_diag.py::make_kernel``: a callable ``fn(W, H, Y)``
    giving ``(num, den)`` (``(k, Np)`` each) for one of three kinds:
    ``"mxu_only"`` (``num = W (WH + y)``, ``den = W (WH - y)``),
    ``"vpu_only"`` (the ratio and loss chain with ``WH := y``, column sums
    of ``p + ll`` and of ``q``) and ``"hbm_only"`` (column sums of ``y``;
    ``den`` counts the ``Mp / bm`` m-blocks), the last two on every k row."""
    if kind not in ("mxu_only", "vpu_only", "hbm_only"):
        raise ValueError(kind)
    if Mp % bm or Np % bn:
        raise ValueError(f"make_kernel: block ({bm}, {bn}) does not divide ({Mp}, {Np})")
    bf16 = not _highest(precision)
    plain = make_kernel_plain(kind, k, Mp, Np, bm, bn, precision)

    def fn(W, H, Y):
        if W.device.type == "cpu":
            return plain(W, H, Y)
        if kind == "mxu_only":
            cs._check_cuda_operands("make_kernel", W, H, Y, None, bm, dense=True)
            num, den, _ = _launch_h("nbmf_probe_mxu_data" + _suffix(bf16), "make_kernel", W, H,
                                    Y, eps=0.0, bm=bm, loss=False)
            out = (num, den)
        else:
            _check_reduce("make_kernel", Y, (torch.float32,))
            frag = _HBM_ONLY if kind == "hbm_only" else _VPU_ONLY
            out = _launch_reduce("make_kernel", Y, frag, bm, 1, k=k)
        LAUNCHES["make_kernel"] += 1
        return out

    return fn
