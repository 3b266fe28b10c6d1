// The precision tier "default" of the dense sweep passes for NVIDIA Hopper
// (sm_90a) on the tensor cores: the four entry points of sweep_dense.cu over
// f32 operands with every product operand bf16 (the wgmma kernels of
// sweep_wgmma.cuh), the TPU's one bf16 MXU pass of hloss_terms
// (pallas_sweep.py:212), w_terms (:333), loglik_sum (:444) and h_terms
// (:122) under lax.Precision.DEFAULT.  The W pass's 1 - h operand is
// round_bf16(1 - h).

#include "sweep_wgmma.cuh"

extern "C" {

NBMF_WGMMA_DENSE_FORM(_bf16r, float, false)

}  // extern "C"
