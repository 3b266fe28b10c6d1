// The precision tier "high" of the dense sweep passes for NVIDIA Hopper
// (sm_90a): the four entry points of sweep_dense.cu over f32 operands with
// every product operand rounded to TF32 (TierTf32r of sweep_kernels.cuh), for
// hloss_terms (pallas_sweep.py:212), w_terms (:333), loglik_sum (:444) and
// h_terms (:122) under lax.Precision.HIGH.

#include "sweep_kernels.cuh"

extern "C" {

NBMF_DENSE_FORM(_tf32r, float, TierTf32r)

}  // extern "C"
