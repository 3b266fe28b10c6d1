// The precision tiers of the bit-packed sweep passes for NVIDIA Hopper
// (sm_90a): K1 and K2 of sweep_packed.cu with every product operand rounded
// (policies TierBf16r, TierTf32r of sweep_kernels.cuh; ops/tiers.py defines
// the tiers).
//
// nbmf_{hloss,w}_terms_packed_bf16r  precision "default": the TPU's one
//    bf16 MXU pass of hloss_terms_packed (pallas_sweep.py:843) and
//    w_terms_packed (:947) under lax.Precision.DEFAULT;
// nbmf_{hloss,w}_terms_packed_tf32r  precision "high", operands rounded to
//    TF32.
// Same FMAs and sums as the f32 instances plus the roundings, so they are
// bound by fp32 arithmetic as those are.  No bf16-data form: the words
// replace the data stream.

#include "sweep_kernels.cuh"

extern "C" {

NBMF_PACKED_FORM(_bf16r, TierBf16r)
NBMF_PACKED_FORM(_tf32r, TierTf32r)

}  // extern "C"
