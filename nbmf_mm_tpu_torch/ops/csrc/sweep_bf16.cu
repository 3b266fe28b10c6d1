// The bf16-data mode of the dense sweep passes for NVIDIA Hopper (sm_90a):
// the four entry points of sweep_dense.cu over bf16 operands Ym, Yc, Ym2
// (converted to f32 in registers; rows staged by 8-byte cp.async), every
// product operand rounded to bf16 (TierBf16d of sweep_kernels.cuh).  They
// replace hloss_terms (pallas_sweep.py:212), w_terms (:333), loglik_sum
// (:444) and h_terms (:122) on bf16 data, where _mxu_dtype (:93) casts every
// matmul operand to bf16; the W pass's 1 - h operand is
// round_bf16(1 - round_bf16(h)), as the TPU kernel forms it in bf16 (:379).
// Half the data bytes of the f32 instances, the same arithmetic: bound by
// fp32 arithmetic as those are.

#include "sweep_kernels.cuh"

extern "C" {

NBMF_DENSE_FORM(_bf16d, __nv_bfloat16, TierBf16d)

}  // extern "C"
