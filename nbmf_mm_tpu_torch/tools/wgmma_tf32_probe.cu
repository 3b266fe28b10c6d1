// One-warpgroup checks of the TF32 wgmma layouts of sweep_wgmma_tf32.cuh,
// built and driven by wgmma_tf32_probe.py: phase A (D1 = X S^T from two
// K-major tiles of up to 256 K values, several swizzle atoms), phase B (a
// register A operand from D1's accumulator entries times a [KN][32] tile
// stored in slot8 order; VARIANT 1 takes the entries in accumulator order
// and an unpermuted tile, the layout of the bf16 A fragment) and the two
// staging kernels.
#include "sweep_wgmma_tf32.cuh"

namespace {
__global__ void probe_phase_a(const float* X, const float* S, float* D, int k, int kstage) {
    extern __shared__ uint8_t smem_raw[];
    float* Xs = reinterpret_cast<float*>(align1024(smem_raw));
    float* Ss = Xs + 64 * kstage;
    load_tile_tf32(Xs, X, kstage, 64, kstage);
    load_tile_tf32(Ss, S, kstage, 32, kstage);
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    float d[16];
    wgmma_fence();
#pragma unroll 1
    for (int j = 0; j < (k + 7) / 8; ++j)
        wgmma_m64n32k8_tf32_ss(d, desc_tf32(Xs, 64, 0, j), desc_tf32(Ss, 32, 0, j), j > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(d);
    for (int i = 0; i < 16; ++i) D[frag_m(i) * 32 + frag_n(i)] = d[i];
}

template <int KN, int VARIANT>
__global__ void probe_phase_b(const float* P, const float* B, float* out) {
    extern __shared__ uint8_t smem_raw[];
    float* Bs = reinterpret_cast<float*>(align1024(smem_raw));
    load_tile_tf32(Bs, B, 32, KN, 32);
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    uint32_t x[16];
    for (int i = 0; i < 16; ++i) x[i] = tf32_bits(P[frag_m(i) * 32 + frag_n(i)]);
    float acc[KN / 2];
    for (int i = 0; i < KN / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
    if constexpr (VARIANT == 0) {
        phase_b_tf32<KN>(acc, x, Bs);
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const uint32_t a[4] = {x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]};
            wgmma_tf32_rs<KN>(acc, a, desc_tf32(Bs, KN, 0, c));
        }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    for (int i = 0; i < KN / 2; ++i) out[frag_m(i) * KN + frag_n(i)] = acc[i];
}

template <int KN, int V>
int run_b(const float* P, const float* B, float* out) {
    const size_t smem = 4 * KN * 32 + 1024;
    cudaFuncSetAttribute(probe_phase_b<KN, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    probe_phase_b<KN, V><<<1, 128, smem>>>(P, B, out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceSynchronize();
}
}  // namespace

extern "C" {
int probe_a(const float* X, const float* S, float* D, int k, int kstage) {
    const size_t smem = 4 * 96 * (size_t)kstage + 1024;
    cudaFuncSetAttribute(probe_phase_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    probe_phase_a<<<1, 128, smem>>>(X, S, D, k, kstage);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceSynchronize();
}
int probe_b(const float* P, const float* B, float* out, int kn, int variant) {
    if (variant == 0) {
        if (kn == 32) return run_b<32, 0>(P, B, out);
        if (kn == 64) return run_b<64, 0>(P, B, out);
        return run_b<128, 0>(P, B, out);
    }
    if (kn == 32) return run_b<32, 1>(P, B, out);
    if (kn == 64) return run_b<64, 1>(P, B, out);
    return run_b<128, 1>(P, B, out);
}
int probe_stage(const float* W, const float* H, float* wt, float* wk, float* ht, float* hk,
                float* hck, int k, int Mp, int Np, int bm, int lanes) {
    cudaError_t e = stage_tf32(W, H, wt, wk, ht, hk, hck, k, Mp, Np, bm, lanes, 0);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceSynchronize();
}
}
