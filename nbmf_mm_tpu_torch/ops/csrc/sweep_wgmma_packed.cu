// The precision tier "default" of the bit-packed sweep passes for NVIDIA
// Hopper (sm_90a) on the tensor cores: K1 and K2 of sweep_packed.cu with
// every product operand bf16 (the wgmma kernels of sweep_wgmma.cuh), the
// TPU's one bf16 MXU pass of hloss_terms_packed (pallas_sweep.py:843) and
// w_terms_packed (:947) under lax.Precision.DEFAULT.  The W pass's 1 - h
// operand is round_bf16(1 - h).  No bf16-data form: the words replace the
// data stream.  Also the bf16 staging of the operands alone, for checking
// it against its plain version (cuda_sweep.stage_bf16_plain).

#include "sweep_wgmma.cuh"

extern "C" {

NBMF_WGMMA_PACKED_FORM(_bf16r)

// The bf16 copies the forms above make of W (wst, lanes x kstage x Mps, in
// bit-plane order), H (hst) and, where hcst is given, 1 - h (hcst, both
// lanes x kstage x Nps; round(1 - round(h)) with hc_of_rounded, else
// round(1 - h)), at cuda_sweep.plan_wgmma's geometry.
int nbmf_stage_bf16(const float* W, const float* H, bf16* wst, bf16* hst, bf16* hcst, int k,
                    int Mp, int Np, int bm, int hc_of_rounded, int lanes, int device,
                    void* stream_ptr) {
    if (!geometry_ok(k, Mp, Np, bm, lanes) || wst == nullptr || hst == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    err = hc_of_rounded
              ? stage_operands<true>(W, H, wst, hst, hcst, k, Mp, Np, bm, lanes, stream)
              : stage_operands<false>(W, H, wst, hst, hcst, k, Mp, Np, bm, lanes, stream);
    return (int)err;
}

}  // extern "C"
