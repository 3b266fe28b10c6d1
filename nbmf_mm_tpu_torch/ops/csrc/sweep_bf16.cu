// The bf16-data mode of the dense sweep passes for NVIDIA Hopper (sm_90a) on
// the tensor cores: the four entry points of sweep_dense.cu over bf16
// operands Ym, Yc, Ym2 (read as bf16, widened exactly in registers), every
// product operand bf16 (the wgmma kernels of sweep_wgmma.cuh).  They replace
// hloss_terms (pallas_sweep.py:212), w_terms (:333), loglik_sum (:444) and
// h_terms (:122) on bf16 data, where _mxu_dtype (:93) casts every matmul
// operand to bf16; the W pass's 1 - h operand is round_bf16(1 -
// round_bf16(h)), as the TPU kernel forms it in bf16 (:379).

#include "sweep_wgmma.cuh"

extern "C" {

NBMF_WGMMA_DENSE_FORM(_bf16d, __nv_bfloat16, true)

}  // extern "C"
