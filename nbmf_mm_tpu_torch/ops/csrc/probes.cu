// Measurement probes for NVIDIA Hopper (sm_90a): the counterparts of the ten
// Pallas probes in the repository's tools/ scripts, which split one sweep
// pass into its matmul, elementwise and memory-stream costs.
//
// Most are instances of the two pass templates of sweep_kernels.cuh under
// another per-entry policy, so they run the production tiling and a
// matmul-only probe times exactly the FMA loop that K1/K2 run:
//   nbmf_probe_hloss_{product,select}[_bf16]  bench_packed.py:65 hloss_packed
//       (ym unpacked to a float, products, two logs) and bench_packed2.py:50
//       hloss_packed2 (selects, one log); with bm = Mp also the packed form
//       of bench_packed3.py:110 hloss_ngrid;
//   nbmf_probe_hloss_dense[_bf16]  the dense form of hloss_ngrid;
//   nbmf_probe_mxu_{plus1,weighted,data}[_bf16]  the H pass with the ratios
//       replaced by an identity step: bench_packed2.py:168 mxu_only (n_mm=3:
//       WH and WH+1; n_mm=2: o2 += o1 per stripe), bench_packed3.py:37
//       mxu_probe chain3_acc, and bench_diag.py:38 make_kernel's mxu_only
//       (WH + y and WH - y);
//   nbmf_probe_w_{product,select}[_bf16]  bench_packed.py:135 w_packed and
//       bench_packed2.py:118 w_packed2, the one-matmul W form
//       T = H.(P-Q)^T + sum_n Q.  A probe only: it cancels when q ~ 1e8
//       near WH -> 1, and no solver path takes it;
//   nbmf_probe_w_chain3_tile[_bf16]  mxu_probe chain3_tile: T = H.WH^T and
//       T2 = H.(WH+1)^T, each written once.
// Every tools/ probe leaves b = 1 - WH + eps unclamped; the wrappers pass
// m_real = Mp and n_real = Np where the probe's ll is unmasked.  _bf16
// rounds W, H and the tile values to bf16 before the fp32 FMA, the TPU's
// one-pass bf16 matmul (mxu_dtype=bfloat16, and precision DEFAULT).
//
// The rest are one new reduction kernel, templated on the fragment and the
// operand type (f32, bf16 bits, int32 words): bench_stream.py:26
// stream_kernel (sum of Y), bench_vpu.py:32 frag_kernel (a sum of one
// fragment per element: the stream, three unpack forms, the ratios, the
// two loss forms) and make_kernel's hbm_only and vpu_only (column sums).
// It is bound by device memory: one read of the operand, 400 MB at
// 10240^2 f32.  One thread per column, coalesced across the warp; fp64
// sums in a fixed order (per thread down its rows, then a tree per block or
// one partial per column, then one more pass), no float atomics.

#include "sweep_kernels.cuh"

namespace {

template <bool SELECT, bool BF16>
struct Probe : Sweep {
    static constexpr bool kClampB = false;
    static constexpr bool kSelect = SELECT;
    static constexpr bool kBf16 = BF16;
};

template <int FORM, bool BF16>
struct Identity : Sweep {
    static constexpr int kIdentity = FORM;
    static constexpr bool kBf16 = BF16;
};

template <bool SELECT, bool BF16>
struct OneMatmul : Probe<SELECT, BF16> {
    static constexpr int kWForm = 1;
};

template <bool BF16>
struct Chain3Tile : Sweep {
    static constexpr int kWForm = 2;
    static constexpr bool kBf16 = BF16;
};

using ProductF32 = Probe<false, false>;
using ProductBf16 = Probe<false, true>;
using SelectF32 = Probe<true, false>;
using SelectBf16 = Probe<true, true>;
using Plus1F32 = Identity<1, false>;
using Plus1Bf16 = Identity<1, true>;
using DataF32 = Identity<2, false>;
using DataBf16 = Identity<2, true>;
using WeightedF32 = Identity<3, false>;
using WeightedBf16 = Identity<3, true>;
using OneMatmulProductF32 = OneMatmul<false, false>;
using OneMatmulProductBf16 = OneMatmul<false, true>;
using OneMatmulSelectF32 = OneMatmul<true, false>;
using OneMatmulSelectBf16 = OneMatmul<true, true>;
using Chain3TileF32 = Chain3Tile<false>;
using Chain3TileBf16 = Chain3Tile<true>;

// ------------------------------------------------------ reduction probe
enum Frag : int {
    kSum = 0,          // stream_sum / stream_kernel: sum of Y (words cast to f32)
    kConcatInt = 1,    // unpack_concat_int: the 32 bits by shift-and-mask
    kConcatSign = 2,   // unpack_concat_sign: the 32 bits by the sign test
    kRepeatShift = 3,  // unpack_repeat_shift: pltpu.repeat's row tiling
    kRatios = 4,       // ratios: a r + b r with WH := y / 2
    kLoss2 = 5,        // loss2log: ym log a + (1 - ym) log b, a = 0.4 y + 0.3
    kLoss1 = 6,        // loss1log: log(where(ym > 0.5, a, b))
    kHbmOnly = 7,      // make_kernel hbm_only: column sums of Y
    kVpuOnly = 8,      // make_kernel vpu_only: column sums of p + ll and of q
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
__device__ __forceinline__ float to_f32(int32_t v) { return (float)v; }

// The fragment's values for element v at operand row `row`, in the order
// the tools/ probe writes them.  bmw = words per word row of the probe's
// stripe (bm / 32).
template <int FRAG, typename T>
__device__ __forceinline__ void fragment(T v, int row, int bmw, float& f1, float& f2) {
    f2 = 0.f;
    if constexpr (FRAG == kSum || FRAG == kHbmOnly) {
        f1 = to_f32(v);
    } else if constexpr (FRAG == kConcatInt || FRAG == kConcatSign || FRAG == kRepeatShift) {
        const uint32_t u = (uint32_t)v;
        const int i = row % bmw;
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
            if constexpr (FRAG == kConcatInt) s += (float)((u >> b) & 1u);
            if constexpr (FRAG == kConcatSign) s += (int32_t)(u << (31 - b)) < 0 ? 1.f : 0.f;
            // Stripe row r = i + bmw b reads this word at bit r mod 32.
            if constexpr (FRAG == kRepeatShift) s += (float)((u >> ((i + bmw * b) & 31)) & 1u);
        }
        f1 = s;
    } else if constexpr (FRAG == kRatios) {
        const float wh = to_f32(v) * 0.5f;
        const float a = wh + 1e-8f;
        const float b = 1.f - wh + 1e-8f;
        const float r = 1.f / (a * b);
        f1 = a * r;
        f2 = b * r;
    } else if constexpr (FRAG == kLoss2 || FRAG == kLoss1) {
        const float ym = to_f32(v);
        const float a = ym * 0.4f + 0.3f;
        const float b = 1.f - a;
        if constexpr (FRAG == kLoss2) f1 = ym * logf(a) + (1.f - ym) * logf(b);
        else f1 = logf(ym > 0.5f ? a : b);
    } else {
        static_assert(FRAG == kVpuOnly, "unknown fragment");
        const float ym = to_f32(v);  // WH := y, no matmul
        const float a = ym + 1e-8f;
        const float b = 1.f - ym + 1e-8f;
        const float r = 1.f / (a * b);
        f1 = ym * (b * r) + (ym * logf(a) + (1.f - ym) * logf(b));
        f2 = (1.f - ym) * (a * r);
    }
}

// Block (x, y) owns columns [256 x, 256 x + 256), one per thread, and
// operand rows [y rpb, y rpb + rpb).  COLUMNS: one partial per column and
// row block in part1/part2 [y][col]; otherwise one partial per block, the
// block's threads summed as a tree in a fixed order.
template <int FRAG, typename T, bool COLUMNS>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ x, double* __restrict__ part1, double* __restrict__ part2,
              int cols, int rows_per_block, int bmw) {
    const int col = blockIdx.x * kThreads + threadIdx.x;
    const int r0 = blockIdx.y * rows_per_block;
    double s1 = 0.0, s2 = 0.0;
    if (col < cols) {
#pragma unroll 8
        for (int r = r0; r < r0 + rows_per_block; ++r) {
            float f1, f2;
            fragment<FRAG>(x[(size_t)r * cols + col], r, bmw, f1, f2);
            s1 += (double)f1;
            s2 += (double)f2;
        }
    }
    if constexpr (COLUMNS) {
        if (col < cols) {
            part1[(size_t)blockIdx.y * cols + col] = s1;
            part2[(size_t)blockIdx.y * cols + col] = s2;
        }
    } else {
        __shared__ double s[kThreads];
        s[threadIdx.x] = s1 + s2;
        __syncthreads();
        for (int half = kThreads / 2; half > 0; half >>= 1) {
            if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
            __syncthreads();
        }
        if (threadIdx.x == 0) part1[blockIdx.y * gridDim.x + blockIdx.x] = s[0];
    }
}

// num[kk][col] = the row blocks' partials of column col summed in order,
// for every kk < k; den from part2, or the number of row blocks
// (make_kernel's hbm_only adds 1 per m-block).
__global__ void columns_kernel(const double* __restrict__ part1, const double* __restrict__ part2,
                               float* __restrict__ num, float* __restrict__ den, int nrb,
                               int cols, int k, bool count_blocks) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= cols) return;
    double s1 = 0.0, s2 = 0.0;
    for (int y = 0; y < nrb; ++y) {
        s1 += part1[(size_t)y * cols + col];
        s2 += part2[(size_t)y * cols + col];
    }
    const float n1 = (float)s1, n2 = count_blocks ? (float)nrb : (float)s2;
    for (int kk = 0; kk < k; ++kk) {
        num[(size_t)kk * cols + col] = n1;
        den[(size_t)kk * cols + col] = n2;
    }
}

template <int FRAG, typename T, bool COLUMNS>
cudaError_t launch_reduce(const void* x, double* part1, double* part2, int cols,
                          int rows_per_block, int bmw, dim3 grid, cudaStream_t stream) {
    reduce_kernel<FRAG, T, COLUMNS><<<grid, kThreads, 0, stream>>>(
        (const T*)x, part1, part2, cols, rows_per_block, bmw);
    return cudaGetLastError();
}

// The operand types and fragments the tools/ probes combine.
cudaError_t dispatch_reduce(int dtype, int frag, const void* x, double* part1, double* part2,
                            int cols, int rows_per_block, int bmw, dim3 grid,
                            cudaStream_t stream) {
#define NBMF_REDUCE(F, T, C) \
    case F: return launch_reduce<F, T, C>(x, part1, part2, cols, rows_per_block, bmw, grid, stream)
    if (dtype == 0) {
        switch (frag) {
            NBMF_REDUCE(kSum, float, false);
            NBMF_REDUCE(kRatios, float, false);
            NBMF_REDUCE(kLoss2, float, false);
            NBMF_REDUCE(kLoss1, float, false);
            NBMF_REDUCE(kHbmOnly, float, true);
            NBMF_REDUCE(kVpuOnly, float, true);
        }
    } else if (dtype == 1) {
        switch (frag) { NBMF_REDUCE(kSum, uint16_t, false); }
    } else if (dtype == 2) {
        switch (frag) {
            NBMF_REDUCE(kSum, int32_t, false);
            NBMF_REDUCE(kConcatInt, int32_t, false);
            NBMF_REDUCE(kConcatSign, int32_t, false);
            NBMF_REDUCE(kRepeatShift, int32_t, false);
        }
    }
#undef NBMF_REDUCE
    return cudaErrorInvalidValue;
}

}  // namespace

// An H-pass probe: the production signature (nbmf_hloss_terms_packed's);
// y2 must be NULL.  Identity instances read no ll arguments, and the
// plus1/weighted ones no data operand.
#define NBMF_PROBE_H(NAME, Y, LOSS, POLICY)                                                      \
    extern "C" int NAME(const float* W, const float* H, const Y* y, const Y* y2, float* num,    \
                        float* den, float* num_part, float* den_part, double* ll_part,         \
                        float* ll, int k, int Mp, int Np, int bm, int m_real, int n_real,      \
                        int rows_per_split, float eps, int device, void* stream) {             \
        if (y2 != nullptr) return (int)cudaErrorInvalidValue;                                  \
        return run_hloss_as<false, Y, true, LOSS, POLICY>(                                     \
            W, H, y, nullptr, num, den, num_part, den_part, ll_part, ll, k, Mp, Np, bm,        \
            m_real, n_real, rows_per_split, eps, device, stream);                              \
    }

NBMF_PROBE_H(nbmf_probe_hloss_product, int32_t, true, ProductF32)
NBMF_PROBE_H(nbmf_probe_hloss_product_bf16, int32_t, true, ProductBf16)
NBMF_PROBE_H(nbmf_probe_hloss_select, int32_t, true, SelectF32)
NBMF_PROBE_H(nbmf_probe_hloss_select_bf16, int32_t, true, SelectBf16)
NBMF_PROBE_H(nbmf_probe_hloss_dense, float, true, SelectF32)
NBMF_PROBE_H(nbmf_probe_hloss_dense_bf16, float, true, SelectBf16)
NBMF_PROBE_H(nbmf_probe_mxu_plus1, float, false, Plus1F32)
NBMF_PROBE_H(nbmf_probe_mxu_plus1_bf16, float, false, Plus1Bf16)
NBMF_PROBE_H(nbmf_probe_mxu_data, float, false, DataF32)
NBMF_PROBE_H(nbmf_probe_mxu_data_bf16, float, false, DataBf16)
NBMF_PROBE_H(nbmf_probe_mxu_weighted, float, false, WeightedF32)
NBMF_PROBE_H(nbmf_probe_mxu_weighted_bf16, float, false, WeightedBf16)
#undef NBMF_PROBE_H

// A W-pass probe: the production signature (nbmf_w_terms_packed's); y2
// must be NULL.  chain3_tile reads no data operand and writes (2k, Mp).
#define NBMF_PROBE_W(NAME, Y, POLICY)                                                          \
    extern "C" int NAME(const float* W, const float* H, const Y* y, const Y* y2, float* T,     \
                        int k, int Mp, int Np, int bm, int n_real, float eps, int device,      \
                        void* stream) {                                                        \
        if (y2 != nullptr) return (int)cudaErrorInvalidValue;                                  \
        return run_wterms_as<false, Y, POLICY>(W, H, y, nullptr, T, k, Mp, Np, bm, n_real,     \
                                               eps, device, stream);                           \
    }

NBMF_PROBE_W(nbmf_probe_w_product, int32_t, OneMatmulProductF32)
NBMF_PROBE_W(nbmf_probe_w_product_bf16, int32_t, OneMatmulProductBf16)
NBMF_PROBE_W(nbmf_probe_w_select, int32_t, OneMatmulSelectF32)
NBMF_PROBE_W(nbmf_probe_w_select_bf16, int32_t, OneMatmulSelectBf16)
NBMF_PROBE_W(nbmf_probe_w_chain3_tile, float, Chain3TileF32)
NBMF_PROBE_W(nbmf_probe_w_chain3_tile_bf16, float, Chain3TileBf16)
#undef NBMF_PROBE_W

extern "C" {

// The reduction probe over x (rows, cols): dtype 0 f32, 1 bf16, 2 int32
// words; frag as the Frag enum.  Scalar fragments write out (one float) and
// need part1 of ceil(cols/256) * (rows/rows_per_block) doubles; hbm_only
// and vpu_only write num/den (k, cols) and need part1 and part2 of
// (rows/rows_per_block) * cols doubles each.
int nbmf_probe_reduce(const void* x, double* part1, double* part2, float* out, float* num,
                      float* den, int k, int rows, int cols, int rows_per_block, int bmw,
                      int dtype, int frag, int device, void* stream_ptr) {
    if (rows < 1 || cols < 1 || rows_per_block < 1 || rows % rows_per_block || bmw < 1)
        return (int)cudaErrorInvalidValue;
    const bool columns = frag == kHbmOnly || frag == kVpuOnly;
    if (columns ? (num == nullptr || den == nullptr || part2 == nullptr || k < 1)
                : out == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const dim3 grid((cols + kThreads - 1) / kThreads, rows / rows_per_block);
    err = dispatch_reduce(dtype, frag, x, part1, part2, cols, rows_per_block, bmw, grid, stream);
    if (err != cudaSuccess) return (int)err;
    if (columns)
        columns_kernel<<<grid.x, kThreads, 0, stream>>>(part1, part2, num, den, (int)grid.y, cols,
                                                        k, frag == kHbmOnly);
    else
        sum_ll_kernel<<<1, kThreads, 0, stream>>>(part1, (int)(grid.x * grid.y), out);
    return (int)cudaGetLastError();
}

}  // extern "C"
