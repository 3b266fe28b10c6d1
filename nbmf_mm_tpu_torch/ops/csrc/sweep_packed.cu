// Bit-packed NBMF-MM sweep passes for NVIDIA Hopper (sm_90a): the kernel
// templates of sweep_kernels.cuh instantiated on int32 words.
//
// K1 nbmf_hloss_terms_packed replaces the Pallas kernel
//    ops/pallas_sweep.py::hloss_terms_packed of the JAX package: the H-update
//    contractions Num = W.P, Den = W.Q (k, Np) and the Bernoulli
//    log-likelihood ll of the current (W, H), from one read of the words.
// K2 nbmf_w_terms_packed replaces pallas_sweep.py::w_terms_packed: the
//    W-update contraction T = H.P^T + (1-H).Q^T (k, Mp) with the new H.
//
// Because the words are exactly 0/1, p = bit ? b r : 0, q the complement
// term a r, and ll = log of one select (see sweep_kernels.cuh for the
// design, the bounds and the numerics).

#include "sweep_kernels.cuh"

extern "C" {

// Num/Den (lanes, k, Np), ll (lanes) of the factors W (lanes, k, Mp),
// H (lanes, k, Np) from the words (Mp/32, Np), which every lane shares, and,
// in corrected mode, words2 (else NULL), over nsplit chunks of word rows
// (1 <= nsplit <= Mp/32).  wperm is (lanes, k, Mp) scratch for W in
// bit-plane order; with nsplit > 1 the caller passes (lanes, nsplit, k, Np)
// scratch in num_part/den_part, with nsplit == 1 they may be NULL.  ll_part
// holds lanes * ceil(Np/64) * nsplit doubles.  Np % 4 == 0, the words
// 16-byte aligned, 1 <= lanes <= 65535.
int nbmf_hloss_terms_packed(const float* W, const float* H, const int32_t* words,
                            const int32_t* words2, float* num, float* den, float* num_part,
                            float* den_part, double* ll_part, float* ll, float* wperm, int k,
                            int Mp, int Np, int bm, int m_real, int n_real, int nsplit, int lanes,
                            float eps, int device, void* stream_ptr) {
    return run_hloss<int32_t, true>(W, H, words, words2, num, den, num_part, den_part, ll_part,
                                    ll, wperm, k, Mp, Np, bm, m_real, n_real, nsplit, lanes, eps,
                                    device, stream_ptr);
}

// T (lanes, k, Mp) from the shared words, each lane's W and new H and, when
// given, words2 (else the complement is synthesized as !bit && col < n_real),
// over nsplit column chunks; with nsplit > 1 the caller passes
// (lanes, nsplit, k, Mp) scratch in part, else it may be NULL.
int nbmf_w_terms_packed(const float* W, const float* H, const int32_t* words,
                        const int32_t* words2, float* T, float* part, int k, int Mp, int Np,
                        int bm, int n_real, int nsplit, int lanes, float eps, int device,
                        void* stream_ptr) {
    return run_wterms<int32_t>(W, H, words, words2, T, part, k, Mp, Np, bm, n_real, nsplit, lanes,
                               eps, device, stream_ptr);
}

const char* nbmf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

long long nbmf_h_split_launches = 0;

}  // extern "C"
