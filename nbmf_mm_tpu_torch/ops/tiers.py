"""The port's product precision tiers and its bf16-data mode: one definition
shared by the CUDA kernels (the bf16 staging of ``csrc/sweep_wgmma.cuh``,
the TF32 staging and ``round_tf32`` of ``csrc/sweep_wgmma_tf32.cuh``), their
plain PyTorch versions and the plain loop.

The JAX package threads ``precision=`` into every matmul, and on the TPU the
tier decides how the MXU rounds the operands of each product.  The port makes
that rounding explicit, so a tier is the same numbers on the CPU and on the
card (up to the order of the fp32 sums):

========================  ===========================  ======================================
``precision``             JAX package on the TPU       Port (every route, every device)
========================  ===========================  ======================================
``None``, ``"highest"``   HIGHEST: true fp32 products  IEEE fp32 products (TF32 off)
``"high"``                HIGH: 3 bf16 passes, or      each operand of each product rounded
                          TF32 where available         to TF32 (10-bit mantissa, nearest,
                                                       ties away from zero: what
                                                       ``cvt.rna.tf32.f32`` gives), fp32
                                                       FMA, fp32 sums
``"default"``             DEFAULT: one bf16 pass,      each operand rounded to bf16 (nearest
                          fp32 accumulation            even), fp32 FMA, fp32 sums
========================  ===========================  ======================================

The port's default stays IEEE fp32: ``precision=None`` means ``"highest"``,
not DEFAULT as on the JAX package's Pallas path.  The reduced tiers run
their products on the tensor cores (``wgmma``): the bf16 forms (DEFAULT and
the bf16-data mode) in the kernels of ``csrc/sweep_wgmma.cuh``, whose ``WH``
sums the plain versions form the same way on the card (:func:`wh_product`),
and the TF32 tier (HIGH) in those of ``csrc/sweep_wgmma_tf32.cuh``, whose
plain versions keep an fp32 ``WH``: a TF32 operand that rounds the other way
moves a product by 8 times less than a bf16 one, and every ``_tf32r`` form
stays within 1e-4 of max |plain| at every shape ``chip_smoke.py`` checks.
On the CPU the JAX package computes every tier in fp32; the port rounds
there too.

The bf16-data mode (``dtype="bfloat16"``) stores the data operands ``Ym``,
``Ym2`` and ``Yc`` bf16 and keeps factors, updates and losses float32.  The
kernels then round every matmul operand to bf16 (the JAX package's
``_mxu_dtype``), so the tier is DEFAULT, with one difference from DEFAULT on
float32 data: the W pass's ``1 - h`` operand.  The JAX kernel forms
``1.0 - h`` in bf16 arithmetic from the bf16 ``h``, giving
``round_bf16(1 - round_bf16(h))``; under DEFAULT on float32 data the MXU
rounds the f32 difference, giving ``round_bf16(1 - h)``.  The port computes
each as its reference does (:func:`complement`).

A form names the operand rounding a kernel instance runs: ``"f32"``
(HIGHEST), ``"tf32r"`` (HIGH), ``"bf16r"`` (DEFAULT) and ``"bf16d"`` (bf16
data).  A kernel entry point and its launch counter carry the form as a
suffix (:func:`suffix`).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "TIERS",
    "FORMS",
    "resolve_tier",
    "operand_form",
    "suffix",
    "round_bf16",
    "round_tf32",
    "mxu_round",
    "complement",
    "wh_product",
]

TIERS = ("highest", "high", "default")
FORMS = ("f32", "tf32r", "bf16r", "bf16d")
_FORM_OF_TIER = {"highest": "f32", "high": "tf32r", "default": "bf16r"}


def resolve_tier(precision) -> str:
    """``None``, ``"default"``, ``"high"`` or ``"highest"`` in any case (or a
    value whose ``name`` is one of them, such as ``jax.lax.Precision``) as the
    tier's name; ``None`` is ``"highest"``.  Anything else raises."""
    if precision is None:
        return "highest"
    name = getattr(precision, "name", precision)
    if isinstance(name, str) and name.lower() in TIERS:
        return name.lower()
    raise ValueError(f"precision must be None, 'default', 'high' or 'highest', got {precision!r}")


def operand_form(precision, data_dtype: Optional[torch.dtype] = None) -> str:
    """The form a kernel runs for ``precision`` over data of ``data_dtype``:
    bf16 data is ``"bf16d"`` whatever the tier, as in the JAX package."""
    if data_dtype == torch.bfloat16:
        return "bf16d"
    return _FORM_OF_TIER[resolve_tier(precision)]


def suffix(form: str) -> str:
    """``""`` for float32 products, else ``"_" + form``: the suffix of a
    kernel entry point and of its launch counter."""
    return "" if form == "f32" else "_" + form


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10-bit mantissa, nearest, ties away from zero),
    in its own dtype: ``(bits + 0x1000) & ~0x1fff`` of the float32 value,
    infinities and NaNs unchanged."""
    f = x.to(torch.float32)
    bits = (f.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(f), bits.view(torch.float32), f).to(x.dtype)


def mxu_round(x: torch.Tensor, form: str) -> torch.Tensor:
    """A product operand under ``form``: ``x`` itself for ``"f32"``, else
    rounded to TF32 or bf16."""
    if form == "f32":
        return x
    return round_tf32(x) if form == "tf32r" else round_bf16(x)


def wh_product(A: torch.Tensor, B: torch.Tensor, form: str) -> torch.Tensor:
    """The plain versions' ``WH = A @ B`` of two 2-D float32 operands already
    rounded to ``form``.  For the bf16 forms on the card it is one bf16 GEMM
    with fp32 accumulation (``torch.mm`` with ``out_dtype=torch.float32``),
    whose sums round as the tensor cores' do in the port's ``wgmma`` kernels
    (and the TPU's one bf16 pass): ``p`` and ``q`` are rounded to bf16 after
    this product, and a sum one fp32 ulp apart can round one of them the
    other way, which over a 64-row serving chunk moves ``W P`` by more than
    1e-4 of its largest entry.  Elsewhere (every form on the CPU, f32 and
    TF32 on the card, and the products after ``p`` and ``q``, where nothing
    is rounded again) the fp32 matmul of the same values: for TF32 no GEMM
    of the library sums as the tensor-core kernels do (cuBLAS's TF32 product
    and its fp32 product both differ from their ``WH`` at K = 128), and the
    TF32 flips stay inside the bar."""
    if A.is_cuda and form in ("bf16r", "bf16d"):
        return torch.mm(A.to(torch.bfloat16), B.to(torch.bfloat16), out_dtype=torch.float32)
    return A @ B


def complement(h: torch.Tensor, form: str) -> torch.Tensor:
    """The W pass's ``1 - h`` operand: ``1 - h`` for ``"f32"``,
    ``round(1 - round(h))`` in the bf16-data mode, ``round(1 - h)`` under a
    tier."""
    if form == "bf16d":
        return round_bf16(1.0 - round_bf16(h))
    return mxu_round(1.0 - h, form)
