// The precision tier "high" of the dense sweep passes for NVIDIA Hopper
// (sm_90a) on the tensor cores: the four entry points of sweep_dense.cu over
// f32 operands with every product operand rounded to TF32 (the wgmma kernels
// of sweep_wgmma_tf32.cuh), for hloss_terms (pallas_sweep.py:212), w_terms
// (:333), loglik_sum (:444) and h_terms (:122) under lax.Precision.HIGH.
// The W pass's 1 - h operand is round_tf32(1 - h).

#include "sweep_wgmma_tf32.cuh"

extern "C" {

NBMF_TF32_H_ENTRY(nbmf_hloss_terms_dense_tf32r, float, true, true)
NBMF_TF32_H_ENTRY(nbmf_h_terms_dense_tf32r, float, true, false)
NBMF_TF32_W_ENTRY(nbmf_w_terms_dense_tf32r, float)

// ll alone on the H pass's grid: the signature of nbmf_loglik_sum_dense
// with the TF32 copies wt, wk, ht in place of wperm (wk is not read).
int nbmf_loglik_sum_dense_tf32r(const float* W, const float* H, const float* Ym, const float* Yc,
                                double* ll_part, float* ll, float* wt, float* wk, float* ht, int k,
                                int Mp, int Np, int bm, int m_real, int n_real, int nsplit,
                                int lanes, float eps, int device, void* stream_ptr) {
    return run_hloss_tf32<float, false, true>(W, H, Ym, Yc, nullptr, nullptr, nullptr, nullptr,
                                              ll_part, ll, wt, wk, ht, k, Mp, Np, bm, m_real,
                                              n_real, nsplit, lanes, eps, device, stream_ptr);
}

// Blocks per SM and shared memory bytes of the instance that rank k runs:
// pass 0 hloss_terms, 1 h_terms, 2 loglik_sum, 3 w_terms; second: Yc or
// Ym2 given.
int nbmf_tf32_occupancy_dense(int pass, int k, int second, int* blocks, int* smem) {
    if (k < 1 || k > 256 || blocks == nullptr || smem == nullptr) return (int)cudaErrorInvalidValue;
    switch (pass) {
        case 0: return (int)hpass_tf32_occupancy<float, true, true>(k, second, blocks, smem);
        case 1: return (int)hpass_tf32_occupancy<float, true, false>(k, second, blocks, smem);
        case 2: return (int)hpass_tf32_occupancy<float, false, true>(k, second, blocks, smem);
        case 3: return (int)wpass_tf32_occupancy<float>(k, second, blocks, smem);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
