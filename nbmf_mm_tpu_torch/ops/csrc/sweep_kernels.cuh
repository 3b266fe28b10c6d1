// NBMF-MM sweep passes for NVIDIA Hopper (sm_90a): the kernel templates
// shared by the bit-packed entry points (sweep_packed.cu) and the dense ones
// (sweep_dense.cu).
//
// Two passes per sweep, each templated on its operand type Y:
//   hloss_kernel  Num = W.P, Den = W.Q (k, Np) and the Bernoulli
//                 log-likelihood ll of the current (W, H); with TERMS=false
//                 only ll (the loglik_sum pass);
//   wterms_kernel T = H.P^T + (1-H).Q^T (k, Mp) with the new H.
// Y = int32_t reads bit-packed words, Y = float reads dense (Mp, Np) f32
// operands.  Both loaders yield the 32 data rows of word row w in the same
// bit-plane order (row0 + b*bmw for bit b), so the two instances share the
// block split, the register accumulators and the fixed-order fp64 ll
// partials, and on exactly-binary operands the dense instance gives the
// packed one's outputs bitwise (the select identities of the JAX package's
// pallas_sweep.py:744-752: 1*x = x, 0*x + y = y).
//
// Notation: WH = W^T H, a = WH + eps, b = max(1 - WH, 0) + eps,
// r = 1/(a b), p = ym (b r), q = yc (a r), ll = ym log a + yc log b; packed
// operands collapse each to a select.  Layout (kept bit-identical to
// pallas_sweep.py::pack_bits): word row w = j*bmw + i, bit b holds data row
// j*bm + b*bmw + i, bmw = bm/32.
//
// What bounds them on an H100: at m = n = 1e4, k = 128 the H pass does
// ~8 m n k = 1.0e11 flops (the W pass ~6 m n k) against 12.5 MB of words or
// 400 MB of dense f32 (0.12 ms of HBM time at 3.35 TB/s), so both are
// bound by arithmetic, not by device memory.  The design keeps every (m, n)
// intermediate on chip: a block stages a (k x 32) slice of W and a (k x 32)
// tile of H in shared memory, forms the 32 x 32 tile of WH, p and q there,
// and folds it into per-thread fp32 register accumulators.  Dense operands
// are read with plain loads coalesced along the column tile.  This first
// version runs fp32 FMA on the CUDA cores; the tensor cores (wgmma, TF32)
// and TMA are later work.
//
// Determinism: no float atomics.  Every output element and every partial is
// written by one thread, and the cross-block sums (the H pass's split over
// m and its ll partials) run in a fixed order in separate small kernels, so
// a launch on the same inputs gives bitwise the same outputs.
//
// Numerics follow the TPU kernels: one IEEE reciprocal r = 1/(a b), logf,
// two nonnegative accumulations in the W pass (never the one-matmul identity
// H (P - Q)^T + sum Q, which cancels when q ~ 1e8 near WH -> 1).  Dense ll
// takes both logs (ym log a + yc log b), never log of a select.  Build
// without --use_fast_math.  ll is masked exactly to row < m_real and
// col < n_real (the TPU stripe and packed kernels add log(1 + eps) per pad
// entry instead).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 32;  // warps per block
constexpr int kTile = 32;               // columns per tile == data rows per word row
constexpr int kPitch = kTile + 1;       // padded shared-memory row: no bank conflicts

// Shared memory layout common to both passes, in floats:
//   Ws [kpad][32]  W at the 32 data rows of the current word row
//   Hs [kpad][32]  H at the current 32 columns
//   Ps, Qs [32][33] p and q of the current 32 x 32 tile (row = data row)
// kpad = 8 * KPT >= k; rows k..kpad-1 of Ws and Hs are zero.
__host__ __device__ inline size_t smem_bytes(int kpad) {
    return sizeof(float) * (size_t)(2 * kpad * kTile + 2 * kTile * kPitch);
}

// Stage W[:, rows of word row w] into Ws (zero beyond k).
__device__ inline void load_w_slice(float* Ws, const float* __restrict__ W, int k, int kpad,
                                    int Mp, int row0, int bmw) {
    for (int e = threadIdx.x; e < kpad * kTile; e += kThreads) {
        const int kk = e / kTile, r = e % kTile;
        Ws[e] = kk < k ? W[(size_t)kk * Mp + row0 + r * bmw] : 0.f;
    }
}

// Stage H[:, c0:c0+32] into Hs (zero beyond k and beyond Np).
__device__ inline void load_h_tile(float* Hs, const float* __restrict__ H, int k, int kpad,
                                   int Np, int c0) {
    for (int e = threadIdx.x; e < kpad * kTile; e += kThreads) {
        const int kk = e / kTile, c = e % kTile;
        Hs[e] = (kk < k && c0 + c < Np) ? H[(size_t)kk * Np + c0 + c] : 0.f;
    }
}

// WH for the 4 data rows r = g + 8 q (q < 4) of this thread at column `lane`.
__device__ inline void tile_wh(float wh[4], const float* Ws, const float* Hs, int k, int g,
                               int lane) {
#pragma unroll
    for (int q = 0; q < 4; ++q) wh[q] = 0.f;
    for (int kk = 0; kk < k; ++kk) {
        const float h = Hs[kk * kTile + lane];
#pragma unroll
        for (int q = 0; q < 4; ++q) wh[q] = fmaf(Ws[kk * kTile + g + 8 * q], h, wh[q]);
    }
}

// Dense loader: the operand at the 4 data rows r = g + 8 q of this thread
// (data row row0 + r * bmw) and column col; 0 outside the columns.
__device__ inline void load_dense(float v[4], const float* __restrict__ Y, int row0, int bmw,
                                  int g, int Np, int col, bool col_in) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
        v[q] = col_in ? Y[(size_t)(row0 + (g + 8 * q) * bmw) * Np + col] : 0.f;
}

// ------------------------------------------------------------ H pass
// Grid (ceil(Np/32), nsplit).  Block (x, y) owns columns [32x, 32x+32) and
// word rows [y*rows_per_split, ...).  Thread t = 32 g + lane holds Num/Den
// for rows kk = g + 8 i (i < KPT) of column lane in registers.  SECOND: an
// explicit second operand (corrected mode's Yc); otherwise yc = 1 - ym.
template <int KPT, bool SECOND, typename Y, bool TERMS>
__global__ void __launch_bounds__(kThreads)
hloss_kernel(const float* __restrict__ W, const float* __restrict__ H,
             const Y* __restrict__ y, const Y* __restrict__ y2,
             float* __restrict__ num_out, float* __restrict__ den_out,
             double* __restrict__ ll_part, int k, int Mp, int Np, int bm, int m_real,
             int n_real, int rows_per_split, float eps) {
    constexpr bool kDense = std::is_same<Y, float>::value;
    extern __shared__ float smem[];
    constexpr int kpad = 8 * KPT;
    float* Ws = smem;
    float* Hs = Ws + kpad * kTile;
    float* Ps = Hs + kpad * kTile;
    float* Qs = Ps + kTile * kPitch;
    __shared__ double ll_warp[kGroups];

    const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
    const int c0 = blockIdx.x * kTile, col = c0 + lane;
    const bool col_in = col < Np;
    const int bmw = bm / 32, Mw = Mp / 32;
    const int w_begin = blockIdx.y * rows_per_split;
    const int w_end = min(Mw, w_begin + rows_per_split);

    load_h_tile(Hs, H, k, kpad, Np, c0);

    float num[KPT], den[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) num[i] = den[i] = 0.f;
    double ll = 0.0;

    for (int w = w_begin; w < w_end; ++w) {
        const int j = w / bmw, i0 = w - j * bmw;
        const int row0 = j * bm + i0;  // data row of bit 0; bit b is row0 + b*bmw
        __syncthreads();               // the previous tile's readers are done
        load_w_slice(Ws, W, k, kpad, Mp, row0, bmw);
        __syncthreads();

        uint32_t word = 0u, word2 = 0u;
        float ym[4], yc[4];
        if constexpr (kDense) {
            load_dense(ym, y, row0, bmw, g, Np, col, col_in);
            if constexpr (SECOND) load_dense(yc, y2, row0, bmw, g, Np, col, col_in);
        } else {
            word = col_in ? (uint32_t)y[(size_t)w * Np + col] : 0u;
            word2 = (SECOND && col_in) ? (uint32_t)y2[(size_t)w * Np + col] : 0u;
        }
        float wh[4];
        tile_wh(wh, Ws, Hs, k, g, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = g + 8 * q;
            const float a = wh[q] + eps;
            const float b = fmaxf(1.f - wh[q], 0.f) + eps;
            const float rr = 1.f / (a * b);
            float p, qv;
            const bool in_region = row0 + r * bmw < m_real && col < n_real;
            if constexpr (kDense) {
                const float c = SECOND ? yc[q] : 1.f - ym[q];
                p = ym[q] * (b * rr);
                qv = c * (a * rr);
                // Explicit fmaf: one rounding, the same in every instance.
                if (in_region) ll += (double)fmaf(ym[q], logf(a), c * logf(b));
            } else {
                const bool bit = (word >> r) & 1u;
                p = bit ? b * rr : 0.f;
                float sel;
                if (SECOND) {
                    const bool bit2 = (word2 >> r) & 1u;
                    qv = bit2 ? a * rr : 0.f;
                    sel = bit ? a : (bit2 ? b : 1.f);
                } else {
                    qv = bit ? 0.f : a * rr;
                    sel = bit ? a : b;
                }
                if (in_region) ll += (double)logf(sel);
            }
            if (!col_in) p = qv = 0.f;
            if constexpr (TERMS) {
                Ps[r * kPitch + lane] = p;
                Qs[r * kPitch + lane] = qv;
            }
        }
        if constexpr (TERMS) {
            __syncthreads();
            for (int r = 0; r < kTile; ++r) {
                const float p = Ps[r * kPitch + lane];
                const float qv = Qs[r * kPitch + lane];
#pragma unroll
                for (int i = 0; i < KPT; ++i) {
                    const float wv = Ws[(g + 8 * i) * kTile + r];
                    num[i] = fmaf(wv, p, num[i]);
                    den[i] = fmaf(wv, qv, den[i]);
                }
            }
        }
    }

    if (TERMS && col_in) {
        const size_t base = (size_t)blockIdx.y * k * Np;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const int kk = g + 8 * i;
            if (kk < k) {
                num_out[base + (size_t)kk * Np + col] = num[i];
                den_out[base + (size_t)kk * Np + col] = den[i];
            }
        }
    }

    // Block sum of ll in a fixed order: warp tree, then warp 0 over warps.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ll += __shfl_down_sync(0xffffffffu, ll, off);
    if (lane == 0) ll_warp[g] = ll;
    __syncthreads();
    if (threadIdx.x == 0) {
        double s = 0.0;
        for (int i = 0; i < kGroups; ++i) s += ll_warp[i];
        ll_part[blockIdx.y * gridDim.x + blockIdx.x] = s;
    }
}

// out[e] = sum over s of part[s][e], s in order (the H pass's split over m).
__global__ void sum_splits_kernel(const float* __restrict__ num_part,
                                  const float* __restrict__ den_part, float* __restrict__ num,
                                  float* __restrict__ den, int nsplit, size_t count) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= count) return;
    float sn = 0.f, sd = 0.f;
    for (int s = 0; s < nsplit; ++s) {
        sn += num_part[(size_t)s * count + e];
        sd += den_part[(size_t)s * count + e];
    }
    num[e] = sn;
    den[e] = sd;
}

// ll = sum of the per-block partials, in a fixed order (one block).
__global__ void sum_ll_kernel(const double* __restrict__ part, int count, float* __restrict__ ll) {
    __shared__ double s[kThreads];
    double acc = 0.0;
    for (int i = threadIdx.x; i < count; i += kThreads) acc += part[i];
    s[threadIdx.x] = acc;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) *ll = (float)s[0];
}

// ------------------------------------------------------------ W pass
// Grid (Mp/32): block w owns word row w, i.e. 32 data rows, and walks all
// columns in tiles of 32.  Thread t = 32 g + lane holds T for rows
// kk = g + 8 i of data row `lane` as two nonnegative register sums.
// SECOND: an explicit Ym2 (both masked modes); otherwise the complement is
// synthesized as 1 - ym (bit: !bit) for col < n_real.
template <int KPT, bool SECOND, typename Y>
__global__ void __launch_bounds__(kThreads)
wterms_kernel(const float* __restrict__ W, const float* __restrict__ H,
              const Y* __restrict__ y, const Y* __restrict__ y2,
              float* __restrict__ T, int k, int Mp, int Np, int bm, int n_real, float eps) {
    constexpr bool kDense = std::is_same<Y, float>::value;
    extern __shared__ float smem[];
    constexpr int kpad = 8 * KPT;
    float* Ws = smem;
    float* Hs = Ws + kpad * kTile;
    float* Ps = Hs + kpad * kTile;
    float* Qs = Ps + kTile * kPitch;

    const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
    const int w = blockIdx.x, bmw = bm / 32;
    const int j = w / bmw;
    const int row0 = j * bm + (w - j * bmw);

    load_w_slice(Ws, W, k, kpad, Mp, row0, bmw);

    float tp[KPT], tq[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) tp[i] = tq[i] = 0.f;

    for (int c0 = 0; c0 < Np; c0 += kTile) {
        __syncthreads();  // Ws staged / the previous tile's readers are done
        load_h_tile(Hs, H, k, kpad, Np, c0);
        __syncthreads();

        const int col = c0 + lane;
        const bool col_in = col < Np;
        uint32_t word = 0u, word2 = 0u;
        float ym[4], ym2[4];
        if constexpr (kDense) {
            load_dense(ym, y, row0, bmw, g, Np, col, col_in);
            if constexpr (SECOND) load_dense(ym2, y2, row0, bmw, g, Np, col, col_in);
        } else {
            word = col_in ? (uint32_t)y[(size_t)w * Np + col] : 0u;
            word2 = (SECOND && col_in) ? (uint32_t)y2[(size_t)w * Np + col] : 0u;
        }
        float wh[4];
        tile_wh(wh, Ws, Hs, k, g, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = g + 8 * q;
            const float a = wh[q] + eps;
            const float b = fmaxf(1.f - wh[q], 0.f) + eps;
            const float rr = 1.f / (a * b);
            if constexpr (kDense) {
                const float c = SECOND ? ym2[q] : (col < n_real ? 1.f - ym[q] : 0.f);
                Ps[r * kPitch + lane] = col_in ? ym[q] * (b * rr) : 0.f;
                Qs[r * kPitch + lane] = col_in ? c * (a * rr) : 0.f;
            } else {
                const bool bit = (word >> r) & 1u;
                const bool bit2 = SECOND ? ((word2 >> r) & 1u) : (!bit && col < n_real);
                Ps[r * kPitch + lane] = (col_in && bit) ? b * rr : 0.f;
                Qs[r * kPitch + lane] = (col_in && bit2) ? a * rr : 0.f;
            }
        }
        __syncthreads();

        for (int c = 0; c < kTile; ++c) {
            const float p = Ps[lane * kPitch + c];
            const float qv = Qs[lane * kPitch + c];
#pragma unroll
            for (int i = 0; i < KPT; ++i) {
                const float h = Hs[(g + 8 * i) * kTile + c];
                tp[i] = fmaf(h, p, tp[i]);
                tq[i] = fmaf(1.f - h, qv, tq[i]);
            }
        }
    }

    const int row = row0 + lane * bmw;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
        const int kk = g + 8 * i;
        if (kk < k) T[(size_t)kk * Mp + row] = tp[i] + tq[i];
    }
}

// ------------------------------------------------------------ launchers
bool geometry_ok(int k, int Mp, int Np, int bm) {
    return k >= 1 && k <= 256 && Np >= 1 && bm >= 32 && bm % 32 == 0 && Mp >= bm &&
           Mp % bm == 0;
}

// Registers per thread scale with KPT = ceil(k / 8), rounded up to a power
// of two so a handful of instantiations covers k in [1, 256].
template <class L, class... A>
cudaError_t dispatch_kpt(int k, A... args) {
    if (k <= 8) return L::template launch<1>(args...);
    if (k <= 16) return L::template launch<2>(args...);
    if (k <= 32) return L::template launch<4>(args...);
    if (k <= 64) return L::template launch<8>(args...);
    if (k <= 128) return L::template launch<16>(args...);
    return L::template launch<32>(args...);
}

template <bool SECOND, typename Y, bool TERMS>
struct HlossLauncher {
    // One H-pass launch, grid ceil(Np/32) x nsplit.
    template <int KPT>
    static cudaError_t launch(const float* W, const float* H, const Y* y, const Y* y2,
                              float* num, float* den, double* ll_part, int k, int Mp, int Np,
                              int bm, int m_real, int n_real, int rows_per_split, int nsplit,
                              float eps, cudaStream_t stream) {
        auto kernel = hloss_kernel<KPT, SECOND, Y, TERMS>;
        const size_t smem = smem_bytes(8 * KPT);
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        const dim3 grid((Np + kTile - 1) / kTile, nsplit);
        kernel<<<grid, kThreads, smem, stream>>>(W, H, y, y2, num, den, ll_part, k, Mp, Np, bm,
                                                 m_real, n_real, rows_per_split, eps);
        return cudaGetLastError();
    }
};

template <bool SECOND, typename Y>
struct WtermsLauncher {
    // One W-pass launch, grid Mp/32.
    template <int KPT>
    static cudaError_t launch(const float* W, const float* H, const Y* y, const Y* y2, float* T,
                              int k, int Mp, int Np, int bm, int n_real, float eps,
                              cudaStream_t stream) {
        auto kernel = wterms_kernel<KPT, SECOND, Y>;
        const size_t smem = smem_bytes(8 * KPT);
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        kernel<<<Mp / 32, kThreads, smem, stream>>>(W, H, y, y2, T, k, Mp, Np, bm, n_real, eps);
        return cudaGetLastError();
    }
};

// The H pass with its fixed-order reductions: Num/Den (k, Np) and ll from
// the operands y and, when given, y2.  With nsplit > 1 the caller passes
// (nsplit, k, Np) scratch in num_part/den_part; TERMS=false writes ll only.
template <typename Y, bool TERMS>
int run_hloss(const float* W, const float* H, const Y* y, const Y* y2, float* num, float* den,
              float* num_part, float* den_part, double* ll_part, float* ll, int k, int Mp,
              int Np, int bm, int m_real, int n_real, int rows_per_split, float eps, int device,
              void* stream_ptr) {
    if (!geometry_ok(k, Mp, Np, bm) || rows_per_split < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int Mw = Mp / 32;
    const int nsplit = (Mw + rows_per_split - 1) / rows_per_split;
    const bool split = TERMS && nsplit > 1;
    if (split && (num_part == nullptr || den_part == nullptr)) return (int)cudaErrorInvalidValue;
    float* num_dst = split ? num_part : num;
    float* den_dst = split ? den_part : den;
    if (y2 != nullptr)
        err = dispatch_kpt<HlossLauncher<true, Y, TERMS>>(
            k, W, H, y, y2, num_dst, den_dst, ll_part, k, Mp, Np, bm, m_real, n_real,
            rows_per_split, nsplit, eps, stream);
    else
        err = dispatch_kpt<HlossLauncher<false, Y, TERMS>>(
            k, W, H, y, y2, num_dst, den_dst, ll_part, k, Mp, Np, bm, m_real, n_real,
            rows_per_split, nsplit, eps, stream);
    if (err != cudaSuccess) return (int)err;
    if (split) {
        const size_t count = (size_t)k * Np;
        const int blocks = (int)((count + kThreads - 1) / kThreads);
        sum_splits_kernel<<<blocks, kThreads, 0, stream>>>(num_part, den_part, num, den, nsplit,
                                                           count);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int nparts = ((Np + kTile - 1) / kTile) * nsplit;
    sum_ll_kernel<<<1, kThreads, 0, stream>>>(ll_part, nparts, ll);
    return (int)cudaGetLastError();
}

// The W pass: T (k, Mp) from the operands y and, when given, y2.
template <typename Y>
int run_wterms(const float* W, const float* H, const Y* y, const Y* y2, float* T, int k, int Mp,
               int Np, int bm, int n_real, float eps, int device, void* stream_ptr) {
    if (!geometry_ok(k, Mp, Np, bm)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (y2 != nullptr)
        err = dispatch_kpt<WtermsLauncher<true, Y>>(k, W, H, y, y2, T, k, Mp, Np, bm, n_real, eps,
                                                    stream);
    else
        err = dispatch_kpt<WtermsLauncher<false, Y>>(k, W, H, y, y2, T, k, Mp, Np, bm, n_real,
                                                     eps, stream);
    return (int)err;
}

}  // namespace
