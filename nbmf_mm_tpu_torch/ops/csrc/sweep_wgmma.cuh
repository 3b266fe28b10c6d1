// The bf16 operand forms of the NBMF-MM sweep passes on Hopper's tensor
// cores (sm_90a, wgmma): precision "default" over f32 data and over packed
// words (_bf16r) and the bf16-data mode (_bf16d), the forms in which every
// operand of every product is bf16 and every sum fp32 (ops/tiers.py).  Such
// a product is exactly what a Hopper tensor core computes, so these forms
// run their three products per pass as wgmma instructions, where the f32
// instances of sweep_kernels.cuh run FMAs (TF32: sweep_wgmma_tf32.cuh).
//
// What they replace (the JAX package's ops/pallas_sweep.py, under
// lax.Precision.DEFAULT or on bf16 data, where _mxu_dtype casts every
// matmul operand to bf16):
//   hpass_wgmma_kernel  hloss_terms_packed (:843), hloss_terms (:212) and
//       hloss_terms_stripe (:546), loglik_sum (:444), h_terms (:122):
//       Num = W.P, Den = W.Q (k, Np) and the log-likelihood ll;
//   wpass_wgmma_kernel  w_terms_packed (:947), w_terms (:333) and
//       w_terms_stripe (:650): T = H.P^T + (1-H).Q^T (k, Mp).
// Entry points: nbmf_hloss_terms_packed_bf16r and nbmf_w_terms_packed_bf16r
// (sweep_wgmma_packed.cu), nbmf_{hloss_terms,h_terms,w_terms,loglik_sum}_
// dense_bf16r (sweep_tiers_bf16r.cu) and _bf16d (sweep_bf16.cu).
//
// Bound on an H100: 6 m n k flops per pass (three m x n x k products) at
// the 989 TFLOP/s bf16 tensor-core peak, 0.078 ms at m = n = 1e4, k = 128,
// or the bytes where a dense f32 operand is read (400 MB, 0.12 ms at
// 3.35 TB/s).  The expected limit is neither: the elementwise chain between
// the products (a, b, the IEEE r = 1/(a b), p, q, two logf per entry) runs
// on the CUDA cores, and alone it takes several times the tensor-core time
// (the vpu_only probe of tools/bench_diag.py).  The design keeps that chain
// fed and the products off the CUDA cores:
//   - one shape for both passes, as in FlashAttention-3.  A block owns 64
//     columns (H pass) or 64 data rows (W pass) and walks steps of 64 data
//     rows (two word rows) or 64 columns.  Per step, phase A is
//     D1 = X^T S (m64n64k16, K = k) with X the block's resident tile and S
//     the step's streamed tile, both read MN-major from shared memory; the
//     elementwise step turns D1's accumulator fragment into p and q in
//     registers, rounded to bf16 as they are packed; phase B is two
//     m64nKNk16 products with p and q as register A operands (the
//     accumulator layout of m64nNk16 is the bf16 A-fragment layout, so no
//     shuffle) and S read K-major from the same shared-memory copy:
//       H pass  X = H (k x 64 columns), S = W's slice (k x 64 data rows),
//               Num^T += P^T W_slice^T, Den^T += Q^T W_slice^T;
//       W pass  X = W's rows (k x 64 data rows), S = H's tile and 1 - H's
//               tile (k x 64 columns each), T^T += P H^T and
//               T^T += Q (1-H)^T as two nonnegative accumulators, added
//               once at the end (never the one-matmul identity);
//   - operands staged as bf16 once per call by small kernels: W in the
//     bit-plane order of the packed layout (stage_w_bf16_kernel), H, and the
//     W pass's 1 - h by the form's rule (stage_h_bf16_kernel), zero beyond k
//     and the real columns, rows padded to 64-element multiples so every
//     16-byte copy is aligned and every tile lies inside its row;
//   - tiles arrive by cp.async in the 128-byte swizzled layout wgmma reads
//     (16-byte chunk c of 128-byte row r at c ^ (r & 7)); the next step's
//     tile lands in a second buffer while the current step computes;
//   - the data operand (words, f32 or bf16) enters only the elementwise
//     step: each thread loads the entries of its own accumulator fragment
//     straight from global memory, issued while phase A runs;
//   - the CUDA cores and the tensor cores overlap across the two or three
//     blocks an SM holds (one warpgroup each), not within a block: a block
//     waits on its own products;
//   - rank 1..256: the phase-B width KN is 32, 64 or 128; above 128 the
//     output k is split over two blocks (grid x), each recomputing phase A.
//
// Numerics: products of bf16 operands, fp32 sums on the tensor cores, the
// elementwise step in IEEE fp32 as in sweep_kernels.cuh (one 1/(a b), logf,
// ll in fp64 per thread, masked exactly to m_real x n_real).  The block
// split, the fixed-order partial sums (sum_splits_kernel, sum_parts_kernel,
// sum_ll_kernel) and the lane axis (blockIdx.z) are those of the CUDA-core
// passes, so two launches agree bitwise, lane r equals the unbatched call,
// dense forms equal the packed form on binary data, loglik_sum's ll equals
// the H pass's and h_terms' Num/Den equal the H pass's, all bitwise.

#pragma once

#include "sweep_kernels.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWg = 128;        // threads of a block: one warpgroup
constexpr int kTile = 64;       // a block's columns / rows, and a step's
constexpr int kRowBytes = 128;  // one staged k row of a tile: 64 bf16

// ------------------------------------------------------------ wgmma
// A shared-memory matrix descriptor, 128-byte swizzle.  For an MN-major
// operand (64 wide) SBO is the stride between groups of 8 k rows and LBO
// that between 64-wide chunks, of which there is one; for a K-major one SBO
// is the stride between groups of 8 rows of the N extent and LBO is unused.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}
// Operand of phase A: rows kk of a [rows][64] tile from k16 step j on.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int j) {
    return smem_desc(tile + j * 16 * kTile, 8 * kRowBytes, 8 * kRowBytes);
}
// Operand of phase B: rows r0 .. r0 + N of a [rows][64] tile as N x K with K
// the 64-element row, K chunk kc (16 elements, 32 bytes) of it.
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int kc) {
    return smem_desc(tile + r0 * kTile + kc * 16, 16, 8 * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// cp.async writes are seen by the async proxy (wgmma) only after this.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D = A B (scale_d 0) or D += A B (scale_d 1).
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float (&d)[32], uint64_t da, uint64_t db,
                                                      int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int KN>
__device__ __forceinline__ void wgmma_rs(float (&d)[KN / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (KN == 32) wgmma_m64n32k16_rs(d, a, db);
    if constexpr (KN == 64) wgmma_m64n64k16_rs(d, a, db);
    if constexpr (KN == 128) wgmma_m64n128k16_rs(d, a, db);
}

// Two f32 values as a bf16x2 register, each rounded to nearest even (the
// rounding of tiers.round_bf16); lo is the lower K index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment index maps of an m64nNk16 f32 accumulator, entry i of thread
// t = 32 warp + lane: M index 16 warp + lane/4 + 8 ((i/2) % 2), N index
// 8 (i/4) + 2 (lane % 4) + i % 2.  Entries 8c .. 8c + 7 of phase A's
// accumulator are, packed in pairs, the A fragment of K chunk c of phase B.
__device__ __forceinline__ int frag_m(int i) {
    return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_n(int i) {
    return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Copy rows [0, rows) of a [rows][64] bf16 tile (row stride `stride`
// elements) into shared memory, 128-byte swizzled, by cp.async.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride, int rows) {
    for (int e = threadIdx.x; e < rows * 8; e += kWg) {
        const int r = e >> 3, ch = e & 7;
        cp_async16(dst + r * kTile + 8 * (ch ^ (r & 7)), src + r * stride + 8 * ch, true);
    }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return p + ((1024u - (a & 1023u)) & 1023u);
}

// One data value of a dense operand as f32.
template <typename Y>
__device__ __forceinline__ float dense_value(const Y* p) {
    if constexpr (sizeof(Y) == 4) return __ldg(p);
    else return __bfloat162float(*p);
}

// Block sum of ll in a fixed order (warp tree, then thread 0 over the four
// warps) into ll_part[at].
__device__ __forceinline__ void block_ll(double ll, double* ll_warp, double* ll_part, size_t at) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ll += __shfl_down_sync(0xffffffffu, ll, off);
    if ((threadIdx.x & 31) == 0) ll_warp[threadIdx.x >> 5] = ll;
    __syncthreads();
    if (threadIdx.x == 0) ll_part[at] = ((ll_warp[0] + ll_warp[1]) + ll_warp[2]) + ll_warp[3];
}

// ------------------------------------------------------------ staging
// Wst[kk][c] (kstage, Mps) of each lane (blockIdx.y) = bf16 of W[kk][data
// row of bit-plane column c] (column 32 w + b holds bit b of word row w),
// zero for kk >= k or c >= Mp.
__global__ void stage_w_bf16_kernel(const float* __restrict__ W, bf16* __restrict__ Wst, int k,
                                    int Mp, int bm, int kstage, int Mps) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (size_t)kstage * Mps) return;
    const int kk = (int)(e / Mps), c = (int)(e % Mps);
    const float v = (kk < k && c < Mp)
                        ? W[(size_t)blockIdx.y * k * Mp + (size_t)kk * Mp +
                            word_row_bit(c >> 5, c & 31, bm, bm / 32)]
                        : 0.f;
    Wst[(size_t)blockIdx.y * kstage * Mps + e] = __float2bfloat16_rn(v);
}

// Hst[kk][c] (kstage, Nps) of each lane = bf16 of H[kk][c] and, where Hcst
// is given, Hcst[kk][c] = the W pass's 1 - h operand: round(1 - round(h))
// with HC_OF_ROUNDED (the bf16-data mode), round(1 - h) without; zero for
// kk >= k or c >= Np.
template <bool HC_OF_ROUNDED>
__global__ void stage_h_bf16_kernel(const float* __restrict__ H, bf16* __restrict__ Hst,
                                    bf16* __restrict__ Hcst, int k, int Np, int kstage, int Nps) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (size_t)kstage * Nps) return;
    const int kk = (int)(e / Nps), c = (int)(e % Nps);
    const bool in = kk < k && c < Np;
    const float h = in ? H[(size_t)blockIdx.y * k * Np + (size_t)kk * Np + c] : 0.f;
    const size_t at = (size_t)blockIdx.y * kstage * Nps + e;
    Hst[at] = __float2bfloat16_rn(h);
    if (Hcst != nullptr)
        Hcst[at] = in ? __float2bfloat16_rn(1.f - (HC_OF_ROUNDED ? round_bf16(h) : h))
                      : __float2bfloat16_rn(0.f);
}

// The staged copies' geometry (cuda_sweep.plan_wgmma mirrors it): phase B's
// width KN, the k blocks nkb, the staged k rows kstage = KN nkb, and the
// padded row lengths of the W and H copies.
struct WgmmaPlan {
    int kn, nkb, kstage, Mps, Nps;
};
__host__ __device__ inline WgmmaPlan plan_wgmma(int k, int Mp, int Np) {
    WgmmaPlan p;
    p.kn = k <= 32 ? 32 : k <= 64 ? 64 : 128;
    p.nkb = (k + p.kn - 1) / p.kn;
    p.kstage = p.kn * p.nkb;
    p.Mps = (Mp + 32 + 63) / 64 * 64;
    p.Nps = (Np + 32 + 63) / 64 * 64;
    return p;
}

// ------------------------------------------------------------ H pass
// Grid (ceil(Np/64) nkb, S, R): block x = cb + ncb kb owns the columns
// [64 cb, 64 cb + 64) and the output k rows [KN kb, KN kb + KN); s is the
// chunk of word rows of plan_h_split (the first Mw % S take one more),
// walked two word rows a step (a chunk of odd length masks the second word
// row of its last step).  Only kb = 0 adds ll; TERMS=false (loglik_sum)
// has nkb = 1 and no phase B, LOSS=false (h_terms) no logs.
template <int KN, bool SECOND, typename Y, bool TERMS, bool LOSS>
__global__ void __launch_bounds__(kWg, KN == 128 ? 2 : 3)
hpass_wgmma_kernel(const bf16* __restrict__ Wst, const bf16* __restrict__ Hst,
                   const Y* __restrict__ y, const Y* __restrict__ y2, float* __restrict__ num_out,
                   float* __restrict__ den_out, double* __restrict__ ll_part, int k, int Mp,
                   int Np, int bm, int m_real, int n_real, int kstage, int Mps, int Nps, int ncb,
                   float eps) {
    constexpr bool kDense = !std::is_same<Y, int32_t>::value;
    extern __shared__ uint8_t smem_raw[];
    __shared__ double ll_warp[kWg / 32];
    bf16* Xs = reinterpret_cast<bf16*>(align1024(smem_raw));  // H's tile [kstage][64]
    bf16* Sbuf = Xs + kstage * kTile;                           // W's slice, two stages

    const int bmw = bm / 32, Mw = Mp / 32;
    const size_t z = blockIdx.z;
    Wst += z * kstage * Mps;
    Hst += z * kstage * Nps;
    const int cb = blockIdx.x % ncb, kb = blockIdx.x / ncb;
    const int c0 = cb * kTile;
    const int S = gridDim.y, s = blockIdx.y;
    const int w_begin = s * (Mw / S) + min(s, Mw % S);
    const int w_end = w_begin + Mw / S + (s < Mw % S ? 1 : 0);
    const int ksteps = (k + 15) / 16;

    // This thread's accumulator entries: columns c0 + m for m = mrow, mrow + 8.
    const int mrow = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);

    float acc1[TERMS ? KN / 2 : 1], acc2[TERMS ? KN / 2 : 1];
#pragma unroll
    for (int i = 0; i < (TERMS ? KN / 2 : 1); ++i) acc1[i] = acc2[i] = 0.f;
    double ll = 0.0;

    if (w_begin < w_end) {
        load_tile(Xs, Hst + c0, Nps, kstage);
        load_tile(Sbuf, Wst + (size_t)32 * w_begin, Mps, kstage);
        cp_async_commit();
    }
    for (int w = w_begin, st = 0; w < w_end; w += 2, st ^= 1) {
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();  // step w has landed; the previous step's products are done
        if (w + 2 < w_end) {
            load_tile(Sbuf + (st ^ 1) * kstage * kTile, Wst + (size_t)32 * (w + 2), Mps, kstage);
            cp_async_commit();
        }
        const bf16* Ss = Sbuf + st * kstage * kTile;

        // ---- phase A: D1 (64 columns x 64 data rows) = H_tile^T W_slice;
        // the first product overwrites d (scale_d 0), so no instruction but
        // wgmma defines it
        float d[32];
        wgmma_fence();
#pragma unroll 1
        for (int j = 0; j < ksteps; ++j)
            wgmma_m64n64k16_ss_mn(d, desc_mn(Xs, j), desc_mn(Ss, j), j > 0);
        wgmma_commit();

        // The data of this thread's entries while the products run: word
        // row w + u holds local data rows 32 u .. 32 u + 31 (bit n % 32).
        const bool second_row = w + 1 < w_end;
        float ym[32], yc[32];
        uint32_t word[2][2] = {{0u, 0u}, {0u, 0u}}, word2[2][2] = {{0u, 0u}, {0u, 0u}};
        if constexpr (kDense) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int n = frag_n(i), u = n >> 5, col = c0 + frag_m(i);
                const bool ok = col < Np && (u == 0 || second_row);
                const size_t row = (size_t)word_row_bit(w + u, n & 31, bm, bmw);
                ym[i] = ok ? dense_value(y + row * Np + col) : 0.f;
                if constexpr (SECOND) yc[i] = ok ? dense_value(y2 + row * Np + col) : 0.f;
            }
        } else {
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int col = c0 + mrow + 8 * h;
                    const bool ok = col < Np && (u == 0 || second_row);
                    word[u][h] = ok ? (uint32_t)__ldg(y + (size_t)(w + u) * Np + col) : 0u;
                    if constexpr (SECOND)
                        word2[u][h] = ok ? (uint32_t)__ldg(y2 + (size_t)(w + u) * Np + col) : 0u;
                }
        }
        wgmma_wait0();
        fence_regs(d);

        // ---- the elementwise step: p, q (rounded to bf16 as packed), ll
        uint32_t pa[16], qa[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
            float pv[2], qv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int n = frag_n(i + e), u = n >> 5, b = n & 31, h = ((i + e) >> 1) & 1;
                const int col = c0 + frag_m(i + e);
                const bool valid = col < Np && (u == 0 || second_row);
                const float v = d[i + e];
                const float a = v + eps;
                const float bb = fmaxf(1.f - v, 0.f) + eps;
                const float rr = 1.f / (a * bb);
                const bool in_region =
                    valid && word_row_bit(w + u, b, bm, bmw) < m_real && col < n_real;
                float p, q;
                if constexpr (kDense) {
                    const float c = SECOND ? yc[i + e] : 1.f - ym[i + e];
                    p = ym[i + e] * (bb * rr);
                    q = c * (a * rr);
                    if (LOSS && in_region)
                        ll += (double)fmaf(ym[i + e], logf(a), c * logf(bb));
                } else {
                    const bool bit = (word[u][h] >> b) & 1u;
                    p = bit ? bb * rr : 0.f;
                    float sel;
                    if constexpr (SECOND) {
                        const bool bit2 = (word2[u][h] >> b) & 1u;
                        q = bit2 ? a * rr : 0.f;
                        sel = bit ? a : (bit2 ? bb : 1.f);
                    } else {
                        q = bit ? 0.f : a * rr;
                        sel = bit ? a : bb;
                    }
                    if (LOSS && in_region) ll += (double)logf(sel);
                }
                pv[e] = valid ? p : 0.f;
                qv[e] = valid ? q : 0.f;
            }
            pa[i >> 1] = pack_bf16x2(pv[0], pv[1]);
            qa[i >> 1] = pack_bf16x2(qv[0], qv[1]);
        }

        // ---- phase B: Num^T += P^T W_slice^T, Den^T += Q^T W_slice^T
        if constexpr (TERMS) {
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
                const uint32_t a1[4] = {pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3]};
                const uint32_t a2[4] = {qa[4 * kc], qa[4 * kc + 1], qa[4 * kc + 2], qa[4 * kc + 3]};
                const uint64_t db = desc_k(Ss, kb * KN, kc);
                wgmma_rs<KN>(acc1, a1, db);
                wgmma_rs<KN>(acc2, a2, db);
            }
            wgmma_commit();
            wgmma_wait0();
            fence_regs(acc1);
            fence_regs(acc2);
        }
    }

    if constexpr (TERMS) {
        const size_t base = (z * S + s) * k * Np;
#pragma unroll
        for (int i = 0; i < KN / 2; ++i) {
            const int col = c0 + frag_m(i), kk = kb * KN + frag_n(i);
            if (col < Np && kk < k) {
                num_out[base + (size_t)kk * Np + col] = acc1[i];
                den_out[base + (size_t)kk * Np + col] = acc2[i];
            }
        }
    }
    if constexpr (LOSS) {
        if (kb == 0) block_ll(ll, ll_warp, ll_part, (z * S + s) * ncb + cb);
    }
}

// ------------------------------------------------------------ W pass
// Grid (ceil(Mw/2) nkb, S, R): block x = rb + nrb kb owns the 64 data rows
// of word rows 2 rb and 2 rb + 1 (local row m is bit m % 32 of word row
// 2 rb + m / 32) and the output k rows [KN kb, KN kb + KN); s is the column
// chunk of plan_w_split (whole 32-column tiles), walked 64 columns a step
// (columns past the chunk's end are masked).
template <int KN, bool SECOND, typename Y>
__global__ void __launch_bounds__(kWg, KN == 128 ? 2 : 3)
wpass_wgmma_kernel(const bf16* __restrict__ Wst, const bf16* __restrict__ Hst,
                   const bf16* __restrict__ Hcst, const Y* __restrict__ y,
                   const Y* __restrict__ y2, float* __restrict__ dst, int k, int Mp, int Np,
                   int bm, int n_real, int kstage, int Mps, int Nps, int nrb, float eps) {
    constexpr bool kDense = !std::is_same<Y, int32_t>::value;
    extern __shared__ uint8_t smem_raw[];
    bf16* Xs = reinterpret_cast<bf16*>(align1024(smem_raw));  // W's rows [kstage][64]
    bf16* Sbuf = Xs + kstage * kTile;  // two stages of H's tile, then 1 - H's, [kstage][64] each
    const int stage_elems = 2 * kstage * kTile;

    const int bmw = bm / 32, Mw = Mp / 32;
    const size_t z = blockIdx.z;
    Wst += z * kstage * Mps;
    Hst += z * kstage * Nps;
    Hcst += z * kstage * Nps;
    const int rb = blockIdx.x % nrb, kb = blockIdx.x / nrb;
    const int w0 = 2 * rb;
    const int nt = (Np + 31) / 32;
    const int S = gridDim.y, s = blockIdx.y;
    const int t_begin = s * (nt / S) + min(s, nt % S);
    const int t_end = t_begin + nt / S + (s < nt % S ? 1 : 0);
    const int c_begin = 32 * t_begin, c_end = min(32 * t_end, Np);
    const int ksteps = (k + 15) / 16;

    // This thread's data rows: local m = mrow, mrow + 8, both bits of one
    // word row.
    const int mrow = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
    const int wr = w0 + (mrow >> 5);
    const bool row_ok = wr < Mw;

    float tp[KN / 2], tq[KN / 2];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) tp[i] = tq[i] = 0.f;

    auto stage = [&](int c, int st) {
        bf16* Hs = Sbuf + st * stage_elems;
        load_tile(Hs, Hst + c, Nps, kstage);
        load_tile(Hs + kstage * kTile, Hcst + c, Nps, kstage);
    };
    if (c_begin < c_end) {
        load_tile(Xs, Wst + (size_t)kTile * rb, Mps, kstage);
        stage(c_begin, 0);
        cp_async_commit();
    }
    for (int c = c_begin, st = 0; c < c_end; c += kTile, st ^= 1) {
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();  // step c has landed; the previous step's products are done
        if (c + kTile < c_end) {
            stage(c + kTile, st ^ 1);
            cp_async_commit();
        }
        const bf16* Hs = Sbuf + st * stage_elems;
        const bf16* Hcs = Hs + kstage * kTile;

        // ---- phase A: D1 (64 data rows x 64 columns) = W_rows^T H_tile (the
        // first product overwrites d)
        float d[32];
        wgmma_fence();
#pragma unroll 1
        for (int j = 0; j < ksteps; ++j)
            wgmma_m64n64k16_ss_mn(d, desc_mn(Xs, j), desc_mn(Hs, j), j > 0);
        wgmma_commit();

        // The data of this thread's entries while the products run: columns
        // c + n in pairs (n even), rows mrow and mrow + 8.
        float ym[32], ym2[32];
        uint32_t word[16], word2[16];
        if constexpr (kDense) {
            const size_t row0 = (size_t)word_row_bit(wr, mrow & 31, bm, bmw);
            const size_t row1 = (size_t)word_row_bit(wr, (mrow + 8) & 31, bm, bmw);
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int col = c + frag_n(i);
                const bool ok = row_ok && col < c_end;
                const size_t row = ((i >> 1) & 1) ? row1 : row0;
                ym[i] = ok ? dense_value(y + row * Np + col) : 0.f;
                if constexpr (SECOND) ym2[i] = ok ? dense_value(y2 + row * Np + col) : 0.f;
            }
        } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                // entry pairs 4 (j/2) + {0,1} (row mrow) share their words
                // with 4 (j/2) + {2,3} (row mrow + 8)
                const int col = c + frag_n(4 * (j >> 1) + (j & 1));
                const bool ok = row_ok && col < c_end;
                word[j] = ok ? (uint32_t)__ldg(y + (size_t)wr * Np + col) : 0u;
                if constexpr (SECOND) word2[j] = ok ? (uint32_t)__ldg(y2 + (size_t)wr * Np + col) : 0u;
            }
        }
        wgmma_wait0();
        fence_regs(d);

        // ---- the elementwise step: p, q (rounded to bf16 as packed)
        uint32_t pa[16], qa[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
            float pv[2], qv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = c + frag_n(i + e);
                const bool col_in = row_ok && col < c_end;
                const float v = d[i + e];
                const float a = v + eps;
                const float bb = fmaxf(1.f - v, 0.f) + eps;
                const float rr = 1.f / (a * bb);
                if constexpr (kDense) {
                    const float cm = SECOND ? ym2[i + e] : (col < n_real ? 1.f - ym[i + e] : 0.f);
                    pv[e] = col_in ? ym[i + e] * (bb * rr) : 0.f;
                    qv[e] = col_in ? cm * (a * rr) : 0.f;
                } else {
                    const int j = 2 * ((i + e) >> 2) + e;  // the word of this entry
                    const int b = frag_m(i + e) & 31;
                    const bool bit = (word[j] >> b) & 1u;
                    const bool bit2 = SECOND ? ((word2[j] >> b) & 1u) : (!bit && col < n_real);
                    pv[e] = (col_in && bit) ? bb * rr : 0.f;
                    qv[e] = (col_in && bit2) ? a * rr : 0.f;
                }
            }
            pa[i >> 1] = pack_bf16x2(pv[0], pv[1]);
            qa[i >> 1] = pack_bf16x2(qv[0], qv[1]);
        }

        // ---- phase B: T^T += P H_tile^T and += Q (1 - H)_tile^T, apart
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            const uint32_t a1[4] = {pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3]};
            const uint32_t a2[4] = {qa[4 * kc], qa[4 * kc + 1], qa[4 * kc + 2], qa[4 * kc + 3]};
            wgmma_rs<KN>(tp, a1, desc_k(Hs, kb * KN, kc));
            wgmma_rs<KN>(tq, a2, desc_k(Hcs, kb * KN, kc));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(tp);
        fence_regs(tq);
    }

    if (!row_ok) return;
    float* out = dst + (z * S + s) * k * Mp;
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
        const int kk = kb * KN + frag_n(i);
        if (kk < k)
            out[(size_t)kk * Mp + word_row_bit(wr, frag_m(i) & 31, bm, bmw)] = tp[i] + tq[i];
    }
}

// ------------------------------------------------------------ launchers
// The bf16 copies of one call: W in bit-plane order into wst and H into hst
// (kstage x Mps, kstage x Nps a lane); with hcst, 1 - h by the rule.
template <bool HC_OF_ROUNDED>
cudaError_t stage_operands(const float* W, const float* H, bf16* wst, bf16* hst, bf16* hcst,
                           int k, int Mp, int Np, int bm, int lanes, cudaStream_t stream) {
    const WgmmaPlan pl = plan_wgmma(k, Mp, Np);
    const auto grid = [&](int row) {
        return dim3((unsigned)(((size_t)pl.kstage * row + kThreads - 1) / kThreads), lanes);
    };
    stage_w_bf16_kernel<<<grid(pl.Mps), kThreads, 0, stream>>>(W, wst, k, Mp, bm, pl.kstage,
                                                               pl.Mps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    stage_h_bf16_kernel<HC_OF_ROUNDED><<<grid(pl.Nps), kThreads, 0, stream>>>(
        H, hst, hcst, k, Np, pl.kstage, pl.Nps);
    return cudaGetLastError();
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

template <bool SECOND, typename Y, bool TERMS, bool LOSS>
struct HpassWgmmaLauncher {
    template <int KN>
    static cudaError_t launch(const bf16* wst, const bf16* hst, const Y* y, const Y* y2,
                              float* num, float* den, double* ll_part, int k, int Mp, int Np,
                              int bm, int m_real, int n_real, int nsplit, int lanes, float eps,
                              cudaStream_t stream) {
        const WgmmaPlan pl = plan_wgmma(k, Mp, Np);
        auto kernel = hpass_wgmma_kernel<KN, SECOND, Y, TERMS, LOSS>;
        // the H tile and two stages of W's slice, 1024-byte aligned
        const size_t smem = (size_t)3 * pl.kstage * kRowBytes + 1024;
        cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        const int ncb = (Np + kTile - 1) / kTile;
        const int nkb = TERMS ? pl.nkb : 1;
        const dim3 grid(ncb * nkb, nsplit, lanes);
        kernel<<<grid, kWg, smem, stream>>>(wst, hst, y, y2, num, den, ll_part, k, Mp, Np, bm,
                                            m_real, n_real, pl.kstage, pl.Mps, pl.Nps, ncb, eps);
        return cudaGetLastError();
    }
};

template <bool SECOND, typename Y>
struct WpassWgmmaLauncher {
    template <int KN>
    static cudaError_t launch(const bf16* wst, const bf16* hst, const bf16* hcst, const Y* y,
                              const Y* y2, float* dst, int k, int Mp, int Np, int bm,
                              int n_real, int nsplit, int lanes, float eps, cudaStream_t stream) {
        const WgmmaPlan pl = plan_wgmma(k, Mp, Np);
        auto kernel = wpass_wgmma_kernel<KN, SECOND, Y>;
        // W's rows and two stages of H's and 1 - H's tiles, 1024-byte aligned
        const size_t smem = (size_t)5 * pl.kstage * kRowBytes + 1024;
        cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        const int nrb = (Mp / 32 + 1) / 2;
        const dim3 grid(nrb * pl.nkb, nsplit, lanes);
        kernel<<<grid, kWg, smem, stream>>>(wst, hst, hcst, y, y2, dst, k, Mp, Np, bm, n_real,
                                            pl.kstage, pl.Mps, pl.Nps, nrb, eps);
        return cudaGetLastError();
    }
};

template <class L, class... A>
cudaError_t dispatch_kn(int k, A... args) {
    if (k <= 32) return L::template launch<32>(args...);
    if (k <= 64) return L::template launch<64>(args...);
    return L::template launch<128>(args...);
}

// The H pass of a bf16 form with its fixed-order reductions: the contract
// of run_hloss_as (sweep_kernels.cuh) with the bf16 copies of W (wst,
// lanes x kstage x Mps) and H (hst, lanes x kstage x Nps) as scratch in
// place of wperm (cuda_sweep.plan_wgmma gives the sizes).
template <bool SECOND, typename Y, bool TERMS, bool LOSS>
int run_hloss_wgmma_as(const float* W, const float* H, const Y* y, const Y* y2, float* num,
                       float* den, float* num_part, float* den_part, double* ll_part, float* ll,
                       bf16* wst, bf16* hst, int k, int Mp, int Np, int bm, int m_real,
                       int n_real, int nsplit, int lanes, float eps, int device,
                       void* stream_ptr) {
    const auto misaligned = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
    const bool split = TERMS && nsplit > 1;
    if (!geometry_ok(k, Mp, Np, bm, lanes) || Np % 4 || nsplit < 1 || nsplit > Mp / 32 ||
        wst == nullptr || hst == nullptr || misaligned(wst) || misaligned(hst) ||
        misaligned(y) || misaligned(y2) || (TERMS && (num == nullptr || den == nullptr)) ||
        (split && (num_part == nullptr || den_part == nullptr)) ||
        (LOSS && (ll_part == nullptr || ll == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    err = stage_operands<false>(W, H, wst, hst, nullptr, k, Mp, Np, bm, lanes, stream);
    if (err != cudaSuccess) return (int)err;
    using L = HpassWgmmaLauncher<SECOND, Y, TERMS, LOSS>;
    if constexpr (TERMS)
        err = dispatch_kn<L>(k, wst, hst, y, y2, split ? num_part : num, split ? den_part : den,
                             ll_part, k, Mp, Np, bm, m_real, n_real, nsplit, lanes, eps, stream);
    else  // no phase B: one width
        err = L::template launch<32>(wst, hst, y, y2, num, den, ll_part, k, Mp, Np, bm, m_real,
                                     n_real, nsplit, lanes, eps, stream);
    if (err != cudaSuccess) return (int)err;
    if (split) {
        const size_t terms = (size_t)k * Np;
        const dim3 blocks((unsigned)((terms + kThreads - 1) / kThreads), lanes);
        sum_splits_kernel<<<blocks, kThreads, 0, stream>>>(num_part, den_part, num, den, nsplit,
                                                           terms);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if constexpr (LOSS) {
        const int nparts = ((Np + kTile - 1) / kTile) * nsplit;
        sum_ll_kernel<<<lanes, kThreads, 0, stream>>>(ll_part, nparts, ll);
    }
    return (int)cudaGetLastError();
}

template <typename Y, bool TERMS, bool LOSS>
int run_hloss_wgmma(const float* W, const float* H, const Y* y, const Y* y2, float* num,
                    float* den, float* num_part, float* den_part, double* ll_part, float* ll,
                    bf16* wst, bf16* hst, int k, int Mp, int Np, int bm, int m_real, int n_real,
                    int nsplit, int lanes, float eps, int device, void* stream_ptr) {
    if (y2 != nullptr)
        return run_hloss_wgmma_as<true, Y, TERMS, LOSS>(W, H, y, y2, num, den, num_part,
                                                        den_part, ll_part, ll, wst, hst, k, Mp,
                                                        Np, bm, m_real, n_real, nsplit, lanes,
                                                        eps, device, stream_ptr);
    return run_hloss_wgmma_as<false, Y, TERMS, LOSS>(W, H, y, y2, num, den, num_part, den_part,
                                                     ll_part, ll, wst, hst, k, Mp, Np, bm,
                                                     m_real, n_real, nsplit, lanes, eps, device,
                                                     stream_ptr);
}

// The W pass of a bf16 form: the contract of run_wterms_as with the bf16
// copies of W (wst), H (hst) and 1 - H (hcst, by HC_OF_ROUNDED's rule) as
// scratch (the sizes of run_hloss_wgmma_as; hcst as hst).
template <bool SECOND, typename Y, bool HC_OF_ROUNDED>
int run_wterms_wgmma_as(const float* W, const float* H, const Y* y, const Y* y2, float* T,
                        float* part, bf16* wst, bf16* hst, bf16* hcst, int k, int Mp, int Np,
                        int bm, int n_real, int nsplit, int lanes, float eps, int device,
                        void* stream_ptr) {
    const auto misaligned = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
    if (!geometry_ok(k, Mp, Np, bm, lanes) || Np % 4 || nsplit < 1 ||
        nsplit > (Np + kWCols - 1) / kWCols || (nsplit > 1 && part == nullptr) ||
        wst == nullptr || hst == nullptr || hcst == nullptr || misaligned(wst) ||
        misaligned(hst) || misaligned(hcst) || misaligned(y) || misaligned(y2))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    err = stage_operands<HC_OF_ROUNDED>(W, H, wst, hst, hcst, k, Mp, Np, bm, lanes, stream);
    if (err != cudaSuccess) return (int)err;
    err = dispatch_kn<WpassWgmmaLauncher<SECOND, Y>>(k, wst, hst, hcst, y, y2,
                                                     nsplit > 1 ? part : T, k, Mp, Np, bm,
                                                     n_real, nsplit, lanes, eps, stream);
    if (err != cudaSuccess) return (int)err;
    if (nsplit > 1) {
        const size_t count = (size_t)k * Mp;
        const dim3 blocks((unsigned)((count + kThreads - 1) / kThreads), lanes);
        sum_parts_kernel<<<blocks, kThreads, 0, stream>>>(part, T, nsplit, count);
    }
    return (int)cudaGetLastError();
}

template <typename Y, bool HC_OF_ROUNDED>
int run_wterms_wgmma(const float* W, const float* H, const Y* y, const Y* y2, float* T,
                     float* part, bf16* wst, bf16* hst, bf16* hcst, int k, int Mp, int Np, int bm,
                     int n_real, int nsplit, int lanes, float eps, int device, void* stream_ptr) {
    if (y2 != nullptr)
        return run_wterms_wgmma_as<true, Y, HC_OF_ROUNDED>(W, H, y, y2, T, part, wst, hst, hcst,
                                                           k, Mp, Np, bm, n_real, nsplit, lanes,
                                                           eps, device, stream_ptr);
    return run_wterms_wgmma_as<false, Y, HC_OF_ROUNDED>(W, H, y, y2, T, part, wst, hst, hcst, k,
                                                        Mp, Np, bm, n_real, nsplit, lanes, eps,
                                                        device, stream_ptr);
}

}  // namespace

// The C entry points of the bf16 forms.  The f32 entry points' signatures
// (sweep_packed.cu, sweep_dense.cu) with the bf16 copies as scratch: the H
// passes take wst, hst in place of wperm; the W pass takes wst, hst, hcst
// after part.
#define NBMF_WGMMA_PACKED_FORM(SUFFIX)                                                            \
    int nbmf_hloss_terms_packed##SUFFIX(                                                          \
        const float* W, const float* H, const int32_t* words, const int32_t* words2, float* num,  \
        float* den, float* num_part, float* den_part, double* ll_part, float* ll, bf16* wst,      \
        bf16* hst, int k, int Mp, int Np, int bm, int m_real, int n_real, int nsplit, int lanes,  \
        float eps, int device, void* stream_ptr) {                                                \
        return run_hloss_wgmma<int32_t, true, true>(W, H, words, words2, num, den, num_part,      \
                                                    den_part, ll_part, ll, wst, hst, k, Mp, Np,   \
                                                    bm, m_real, n_real, nsplit, lanes, eps,       \
                                                    device, stream_ptr);                          \
    }                                                                                             \
    int nbmf_w_terms_packed##SUFFIX(const float* W, const float* H, const int32_t* words,         \
                                    const int32_t* words2, float* T, float* part, bf16* wst,      \
                                    bf16* hst, bf16* hcst, int k, int Mp, int Np, int bm,         \
                                    int n_real, int nsplit, int lanes, float eps, int device,     \
                                    void* stream_ptr) {                                           \
        return run_wterms_wgmma<int32_t, false>(W, H, words, words2, T, part, wst, hst, hcst, k,  \
                                                Mp, Np, bm, n_real, nsplit, lanes, eps, device,   \
                                                stream_ptr);                                      \
    }

#define NBMF_WGMMA_DENSE_FORM(SUFFIX, Y, HC_OF_ROUNDED)                                           \
    int nbmf_hloss_terms_dense##SUFFIX(                                                           \
        const float* W, const float* H, const Y* Ym, const Y* Yc, float* num, float* den,         \
        float* num_part, float* den_part, double* ll_part, float* ll, bf16* wst, bf16* hst,      \
        int k, int Mp, int Np, int bm, int m_real, int n_real, int nsplit, int lanes, float eps,  \
        int device, void* stream_ptr) {                                                           \
        return run_hloss_wgmma<Y, true, true>(W, H, Ym, Yc, num, den, num_part, den_part,         \
                                              ll_part, ll, wst, hst, k, Mp, Np, bm, m_real,       \
                                              n_real, nsplit, lanes, eps, device, stream_ptr);    \
    }                                                                                             \
    int nbmf_h_terms_dense##SUFFIX(                                                               \
        const float* W, const float* H, const Y* Ym, const Y* Yc, float* num, float* den,         \
        float* num_part, float* den_part, double* ll_part, float* ll, bf16* wst, bf16* hst,      \
        int k, int Mp, int Np, int bm, int m_real, int n_real, int nsplit, int lanes, float eps,  \
        int device, void* stream_ptr) {                                                           \
        return run_hloss_wgmma<Y, true, false>(W, H, Ym, Yc, num, den, num_part, den_part,        \
                                               ll_part, ll, wst, hst, k, Mp, Np, bm, m_real,      \
                                               n_real, nsplit, lanes, eps, device, stream_ptr);   \
    }                                                                                             \
    int nbmf_w_terms_dense##SUFFIX(const float* W, const float* H, const Y* Ym, const Y* Ym2,     \
                                   float* T, float* part, bf16* wst, bf16* hst, bf16* hcst,       \
                                   int k, int Mp, int Np, int bm, int n_real, int nsplit,         \
                                   int lanes, float eps, int device, void* stream_ptr) {          \
        return run_wterms_wgmma<Y, HC_OF_ROUNDED>(W, H, Ym, Ym2, T, part, wst, hst, hcst, k, Mp,  \
                                                  Np, bm, n_real, nsplit, lanes, eps, device,     \
                                                  stream_ptr);                                    \
    }                                                                                             \
    int nbmf_loglik_sum_dense##SUFFIX(const float* W, const float* H, const Y* Ym, const Y* Yc,   \
                                      double* ll_part, float* ll, bf16* wst, bf16* hst, int k,    \
                                      int Mp, int Np, int bm, int m_real, int n_real, int nsplit, \
                                      int lanes, float eps, int device, void* stream_ptr) {       \
        return run_hloss_wgmma<Y, false, true>(W, H, Ym, Yc, nullptr, nullptr, nullptr, nullptr,  \
                                               ll_part, ll, wst, hst, k, Mp, Np, bm, m_real,      \
                                               n_real, nsplit, lanes, eps, device, stream_ptr);   \
    }
