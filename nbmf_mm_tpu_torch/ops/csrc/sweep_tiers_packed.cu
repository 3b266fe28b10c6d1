// The precision tier "high" of the bit-packed sweep passes for NVIDIA Hopper
// (sm_90a): K1 and K2 of sweep_packed.cu with every product operand rounded
// to TF32 (policy TierTf32r of sweep_kernels.cuh; ops/tiers.py defines the
// tiers), for hloss_terms_packed (pallas_sweep.py:843) and w_terms_packed
// (:947) under lax.Precision.HIGH.  Same FMAs and sums as the f32 instances
// plus the roundings, so they are bound by fp32 arithmetic as those are.
// The bf16 tier of these passes runs on the tensor cores
// (sweep_wgmma_packed.cu).

#include "sweep_kernels.cuh"

extern "C" {

NBMF_PACKED_FORM(_tf32r, TierTf32r)

}  // extern "C"
