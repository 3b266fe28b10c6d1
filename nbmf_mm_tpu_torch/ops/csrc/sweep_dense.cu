// Dense NBMF-MM sweep passes for NVIDIA Hopper (sm_90a): the kernel
// templates of sweep_kernels.cuh instantiated on f32 (Mp, Np) operands, for
// [0,1]-valued data and weighted masks.
//
// nbmf_hloss_terms_dense replaces the Pallas kernels hloss_terms and
//    hloss_terms_stripe of the JAX package's ops/pallas_sweep.py: Num, Den
//    (k, Np) and the masked log-likelihood ll from one read of Ym (and Yc).
// nbmf_w_terms_dense replaces w_terms and w_terms_stripe: T (k, Mp).
// nbmf_loglik_sum_dense replaces loglik_sum: the H-pass instance with the
//    Num/Den work compiled out, on the same block split, so its ll equals
//    the H pass's ll bitwise.
// nbmf_h_terms_dense replaces h_terms: the H-pass instance with the loss
//    compiled out, so its Num/Den equal the H pass's bitwise.
// The tiled and stripe forms of the TPU exist for its VMEM budget; here one
// kernel per pass takes any padded shape.
//
// Operand contract (the JAX package's pad_operands): zero-padded Ym; the
// H pass takes Yc = NULL for 1 - Ym over every entry (unmasked and parity)
// or an explicit Yc (corrected, where it aliases Ym2); the W pass takes
// Ym2 = NULL for the unmasked complement (1 - Ym for col < n_real) or an
// explicit Ym2 = (1 - Y) mask (both masked modes).  Rows are visited in the
// bit-plane order of stripe bm, so on exactly-binary operands every output
// equals the packed kernels' bitwise.

#include "sweep_kernels.cuh"

extern "C" {

// Num/Den (lanes, k, Np), ll (lanes); lanes, scratch and alignment as
// nbmf_hloss_terms_packed.
int nbmf_hloss_terms_dense(const float* W, const float* H, const float* Ym, const float* Yc,
                           float* num, float* den, float* num_part, float* den_part,
                           double* ll_part, float* ll, float* wperm, int k, int Mp, int Np, int bm,
                           int m_real, int n_real, int nsplit, int lanes, float eps, int device,
                           void* stream_ptr) {
    return run_hloss<float, true>(W, H, Ym, Yc, num, den, num_part, den_part, ll_part, ll, wperm,
                                  k, Mp, Np, bm, m_real, n_real, nsplit, lanes, eps, device,
                                  stream_ptr);
}

// Num/Den alone (h_terms): the instance above with the logs and the ll
// partials compiled out, so its Num/Den equal nbmf_hloss_terms_dense's
// bitwise.  The signature is nbmf_hloss_terms_dense's; ll_part, ll, m_real
// and n_real are not read.
int nbmf_h_terms_dense(const float* W, const float* H, const float* Ym, const float* Yc,
                       float* num, float* den, float* num_part, float* den_part, double* ll_part,
                       float* ll, float* wperm, int k, int Mp, int Np, int bm, int m_real,
                       int n_real, int nsplit, int lanes, float eps, int device,
                       void* stream_ptr) {
    return run_hloss<float, true, false>(W, H, Ym, Yc, num, den, num_part, den_part, ll_part, ll,
                                         wperm, k, Mp, Np, bm, m_real, n_real, nsplit, lanes, eps,
                                         device, stream_ptr);
}

// T (lanes, k, Mp) from Ym, each lane's W and new H and, when given, Ym2;
// lanes and scratch as nbmf_w_terms_packed.
int nbmf_w_terms_dense(const float* W, const float* H, const float* Ym, const float* Ym2,
                       float* T, float* part, int k, int Mp, int Np, int bm, int n_real,
                       int nsplit, int lanes, float eps, int device, void* stream_ptr) {
    return run_wterms<float>(W, H, Ym, Ym2, T, part, k, Mp, Np, bm, n_real, nsplit, lanes, eps,
                             device, stream_ptr);
}

// ll (lanes) of each lane's (W, H) over the real region, on the H pass's
// grid of nsplit word-row chunks; ll_part holds lanes * ceil(Np/64) * nsplit
// doubles, wperm is (lanes, k, Mp) scratch.
int nbmf_loglik_sum_dense(const float* W, const float* H, const float* Ym, const float* Yc,
                          double* ll_part, float* ll, float* wperm, int k, int Mp, int Np, int bm,
                          int m_real, int n_real, int nsplit, int lanes, float eps, int device,
                          void* stream_ptr) {
    return run_hloss<float, false>(W, H, Ym, Yc, nullptr, nullptr, nullptr, nullptr, ll_part, ll,
                                   wperm, k, Mp, Np, bm, m_real, n_real, nsplit, lanes, eps,
                                   device, stream_ptr);
}

}  // extern "C"
