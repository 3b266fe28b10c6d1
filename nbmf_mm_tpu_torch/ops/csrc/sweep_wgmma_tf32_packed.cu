// The precision tier "high" of the bit-packed sweep passes for NVIDIA Hopper
// (sm_90a) on the tensor cores: K1 and K2 of sweep_packed.cu with every
// product operand rounded to TF32 (the wgmma kernels of
// sweep_wgmma_tf32.cuh), for hloss_terms_packed (pallas_sweep.py:843) and
// w_terms_packed (:947) under lax.Precision.HIGH.  The W pass's 1 - h
// operand is round_tf32(1 - h).  Also the TF32 staging of the operands
// alone, for checking it against its plain version
// (cuda_sweep.stage_tf32_plain), and the occupancy of each instance.

#include "sweep_wgmma_tf32.cuh"

extern "C" {

NBMF_TF32_H_ENTRY(nbmf_hloss_terms_packed_tf32r, int32_t, true, true)
NBMF_TF32_W_ENTRY(nbmf_w_terms_packed_tf32r, int32_t)

// The TF32 copies the forms above make, each lanes x ... at
// cuda_sweep.plan_wgmma's geometry: W^T in bit-plane order (wt, Mps x
// kstage), W's phase-B copy (wk, kstage x Mps), H^T (ht, Nps x kstage), H's
// and 1 - H's phase-B copies (hk, hck, kstage x Nps); wk and hk/hck may be
// NULL (not staged).
int nbmf_stage_tf32(const float* W, const float* H, float* wt, float* wk, float* ht, float* hk,
                    float* hck, int k, int Mp, int Np, int bm, int lanes, int device,
                    void* stream_ptr) {
    if (!geometry_ok(k, Mp, Np, bm, lanes) || wt == nullptr || ht == nullptr ||
        (hk == nullptr) != (hck == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)stage_tf32(W, H, wt, wk, ht, hk, hck, k, Mp, Np, bm, lanes,
                           (cudaStream_t)stream_ptr);
}

// Blocks per SM and shared memory bytes of the instance that rank k runs:
// pass 0 K1, 1 K2; second: words2 given.
int nbmf_tf32_occupancy_packed(int pass, int k, int second, int* blocks, int* smem) {
    if (k < 1 || k > 256 || blocks == nullptr || smem == nullptr) return (int)cudaErrorInvalidValue;
    if (pass == 0) return (int)hpass_tf32_occupancy<int32_t, true, true>(k, second, blocks, smem);
    if (pass == 1) return (int)wpass_tf32_occupancy<int32_t>(k, second, blocks, smem);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
