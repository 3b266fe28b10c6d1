// The TF32 operand form of the NBMF-MM sweep passes on Hopper's tensor
// cores (sm_90a, wgmma): precision "high" over f32 data and over packed words
// (_tf32r), the form in which every operand of every product is rounded to
// TF32 and every sum is fp32 (ops/tiers.py).  A tensor core multiplies TF32
// operands exactly and adds in fp32, so these forms run their three products
// per pass as wgmma instructions, as the bf16 forms of sweep_wgmma.cuh do.
//
// What they replace (the JAX package's ops/pallas_sweep.py under
// lax.Precision.HIGH, the precision= of every dot_general there):
//   hpass_tf32_wgmma_kernel  hloss_terms_packed (:843; products :889, :904,
//       :907), hloss_terms (:212) and hloss_terms_stripe (:546), loglik_sum
//       (:444), h_terms (:122): Num = W.P, Den = W.Q (k, Np) and ll;
//   wpass_tf32_wgmma_kernel  w_terms_packed (:947; products :985, :1002,
//       :1005), w_terms (:333) and w_terms_stripe (:650):
//       T = H.P^T + (1-H).Q^T (k, Mp).
// Entry points: nbmf_hloss_terms_packed_tf32r and nbmf_w_terms_packed_tf32r
// (sweep_wgmma_tf32_packed.cu), nbmf_{hloss_terms,h_terms,w_terms,
// loglik_sum}_dense_tf32r (sweep_wgmma_tf32_dense.cu).
//
// Bound on an H100: 6 m n k flops per pass at the 495 TFLOP/s TF32
// tensor-core peak, 0.155 ms at m = n = 1e4, k = 128.  As for the bf16 forms,
// the expected limit is the elementwise chain between the products on the
// CUDA cores (the vpu_only probe of tools/bench_diag.py), so the design is
// that of sweep_wgmma.cuh: one warpgroup per block, a block owns 64 columns
// (H pass) or 64 data rows (W pass), per step phase A D1 = X^T S on the
// tensor cores, the elementwise step on D1's registers, then phase B with p
// and q as register A operands; the host-planned block split, the
// fixed-order partial sums and the lane axis on blockIdx.z.  What TF32
// changes:
//   - wgmma reads a TF32 operand from shared memory only K-major (the
//     transpose immediates exist only for 16-bit types), and phase A and
//     phase B contract the staged operands over different indices.  So the
//     operands are staged once per call in both orders by small tiled
//     transposes (stage_w_tf32_kernel, stage_h_tf32_kernel): (row, kstage)
//     copies W^T (bit-plane order) and H^T for phase A, and (kstage, row)
//     copies W (bit-plane order), H and 1 - h for phase B.  Transposing
//     each tile in shared memory instead would spend CUDA-core
//     instructions, and the CUDA cores set these kernels' pace.  A k row of
//     a K-major tile spans kstage / 32 swizzle atoms of 32 values (128
//     bytes); each k8 instruction reads 32 bytes inside one atom, so the
//     descriptors step through atoms and never use LBO;
//   - the A fragment of m64nNk8.tf32 gives each thread K indices t and t + 4
//     of each k8 chunk (t = lane % 4), where phase A's accumulator gives it
//     2t and 2t + 1.  Phase B contracts over those indices, so the phase-B
//     copies store each group of 8 in the order [0, 2, 4, 6, 1, 3, 5, 7]
//     (physical j holds logical slot8(j)) and the accumulator entries go to
//     the A fragment with no shuffle;
//   - TF32 tiles take twice the bytes of bf16 ones in two layouts, so steps
//     are 32 wide (one word row in the H pass, one 32-column tile in the W
//     pass: phase A m64n32k8, phase B K = 32), the phase-A tile streams in
//     two stages and the phase-B tiles in one, fetched at the top of a step
//     and needed only after its elementwise work.  A block then asks for
//     80 KB (H pass) or 96 KB (W pass) at k <= 128, so two share an SM, and
//     144 / 160 KB above (kstage 256, one block);
//   - every operand is rounded to TF32 before it reaches shared memory or a
//     register fragment: the hardware ignores the low 13 bits.
//
// Numerics: products of TF32 operands, fp32 sums on the tensor cores, the
// elementwise step in IEEE fp32 (one 1/(a b), logf, ll in fp64 per thread,
// masked exactly to m_real x n_real), the W pass's two nonnegative
// accumulations added once at the end (never the one-matmul identity, which
// cancels under TF32).  The block split, the fixed-order sums and the lane
// axis are those of the other passes, so two launches agree bitwise, lane r
// equals the unbatched call, dense forms equal the packed form on binary
// data, loglik_sum's ll equals the H pass's and h_terms' Num/Den equal the
// H pass's, all bitwise.

#pragma once

#include "sweep_wgmma.cuh"

namespace {

constexpr int kAtom = 32;  // TF32 values in one 128-byte swizzle row
constexpr int kStep = 32;  // data rows (H pass) or columns (W pass) of a step

// x rounded to TF32 (10-bit mantissa, nearest, ties away from zero): what
// cvt.rna.tf32.f32 gives, as a bit operation on finite values (the
// mantissa's 13 low bits cleared after adding half of their weight to the
// magnitude); infinities and NaNs pass unchanged.  tiers.round_tf32.
__device__ __forceinline__ float round_tf32(float x) {
    const uint32_t u = __float_as_uint(x);
    if ((u & 0x7f800000u) == 0x7f800000u) return x;
    return __uint_as_float((u + 0x1000u) & ~0x1fffu);
}
// The TF32 bits of a finite value (p and q: a, b >= eps keep them finite).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
    return (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
}

// Physical slot j of each group of 8 in a phase-B copy holds logical index
// slot8(j): [0, 2, 4, 6, 1, 3, 5, 7].
__host__ __device__ __forceinline__ int slot8(int j) { return j < 4 ? 2 * j : 2 * j - 7; }

// ------------------------------------------------------------ wgmma
// K-major operand in shared memory as [width / 32][rows][32] (atom a holds K
// values 32 a .. 32 a + 31 of every row, 128-byte swizzled): the descriptor
// of k8 chunk j of rows r0 ... (SBO: 8 rows of 128 bytes; LBO unused).
__device__ __forceinline__ uint64_t desc_tf32(const float* tile, int rows, int r0, int j) {
    return smem_desc(tile + ((j >> 2) * rows + r0) * kAtom + (j & 3) * 8, 16, 8 * kRowBytes);
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                       int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int KN>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[KN / 2], const uint32_t (&a)[4],
                                              uint64_t db) {
    if constexpr (KN == 32) wgmma_m64n32k8_tf32_rs(d, a, db);
    if constexpr (KN == 64) wgmma_m64n64k8_tf32_rs(d, a, db);
    if constexpr (KN == 128) wgmma_m64n128k8_tf32_rs(d, a, db);
}

// Phase B of one step: acc += A B with A (64 x 32) from phase A's
// accumulator entries (rounded TF32 bits, entry i at K index frag_n(i)) and
// B a [KN][32] K-major tile whose K indices are stored in slot8 order, so
// that entries 4c, 4c + 2, 4c + 1, 4c + 3 are the A fragment of k8 chunk c.
template <int KN>
__device__ __forceinline__ void phase_b_tf32(float (&acc)[KN / 2], const uint32_t (&x)[16],
                                             const float* tile) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const uint32_t a[4] = {x[4 * c], x[4 * c + 2], x[4 * c + 1], x[4 * c + 3]};
        wgmma_tf32_rs<KN>(acc, a, desc_tf32(tile, KN, 0, c));
    }
}

__device__ __forceinline__ void cp_async_wait_1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [0, rows) of a K-major tile in global memory (row stride `stride`
// floats, `width` floats a row, width % 32 == 0) into shared memory as
// [width / 32][rows][32], 16-byte chunk c of row r of an atom at c ^ (r & 7),
// by cp.async.
__device__ __forceinline__ void load_tile_tf32(float* dst, const float* src, size_t stride,
                                               int rows, int width) {
    const int chunks = width >> 2;  // 16-byte chunks of a row
    for (int e = threadIdx.x; e < rows * chunks; e += kWg) {
        const int r = e / chunks, ch = e - r * chunks;
        cp_async16(dst + ((ch >> 3) * rows + r) * kAtom + 4 * ((ch & 7) ^ (r & 7)),
                   src + r * stride + 4 * ch, true);
    }
}

// ------------------------------------------------------------ staging
// A 32 x 32 tile of each lane (blockIdx.z) per block (32 x 8 threads): rows
// k0 + r of k, columns c0 + x of the padded row length.  From W: WT[c][kk]
// (Mps, kstage) = W[kk][data row of bit-plane column c], and, where Wk is
// given, Wk[kk][c] (kstage, Mps) the same values with each group of 8
// columns in slot8 order; TF32-rounded, zero for kk >= k or c >= Mp.
__global__ void stage_w_tf32_kernel(const float* __restrict__ W, float* __restrict__ WT,
                                    float* __restrict__ Wk, int k, int Mp, int bm, int kstage,
                                    int Mps) {
    __shared__ float tile[32][33];
    const size_t z = blockIdx.z;
    W += z * k * Mp;
    WT += z * Mps * kstage;
    const int c0 = 32 * blockIdx.x, k0 = 32 * blockIdx.y, x = threadIdx.x, bmw = bm / 32;
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int kk = k0 + r, c = c0 + x;
        tile[r][x] = (kk < k && c < Mp)
                         ? round_tf32(W[(size_t)kk * Mp + word_row_bit(c >> 5, c & 31, bm, bmw)])
                         : 0.f;
    }
    __syncthreads();
    for (int r = threadIdx.y; r < 32; r += 8) {
        WT[(size_t)(c0 + r) * kstage + k0 + x] = tile[x][r];
        if (Wk != nullptr)
            Wk[z * kstage * Mps + (size_t)(k0 + r) * Mps + c0 + x] = tile[r][(x & ~7) + slot8(x & 7)];
    }
}

// From H: HT[c][kk] (Nps, kstage) = H[kk][c] and, where Hk and Hck are
// given, Hk[kk][c] and Hck[kk][c] (kstage, Nps) = H and the W pass's 1 - h,
// round(1 - h), with each group of 8 columns in slot8 order; TF32-rounded,
// zero for kk >= k or c >= Np.
__global__ void stage_h_tf32_kernel(const float* __restrict__ H, float* __restrict__ HT,
                                    float* __restrict__ Hk, float* __restrict__ Hck, int k,
                                    int Np, int kstage, int Nps) {
    __shared__ float tile[32][33], comp[32][33];
    const size_t z = blockIdx.z;
    H += z * k * Np;
    HT += z * Nps * kstage;
    const int c0 = 32 * blockIdx.x, k0 = 32 * blockIdx.y, x = threadIdx.x;
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int kk = k0 + r, c = c0 + x;
        const bool in = kk < k && c < Np;
        const float h = in ? H[(size_t)kk * Np + c] : 0.f;
        tile[r][x] = round_tf32(h);
        comp[r][x] = in ? round_tf32(1.f - h) : 0.f;
    }
    __syncthreads();
    for (int r = threadIdx.y; r < 32; r += 8) {
        HT[(size_t)(c0 + r) * kstage + k0 + x] = tile[x][r];
        if (Hk != nullptr) {
            const size_t at = z * kstage * Nps + (size_t)(k0 + r) * Nps + c0 + x;
            Hk[at] = tile[r][(x & ~7) + slot8(x & 7)];
            Hck[at] = comp[r][(x & ~7) + slot8(x & 7)];
        }
    }
}

// ------------------------------------------------------------ H pass
// Grid (ceil(Np/64) nkb, S, R): block x = cb + ncb kb owns the columns
// [64 cb, 64 cb + 64) and the output k rows [KN kb, KN kb + KN); s is the
// chunk of word rows of plan_h_split, walked one word row (32 data rows) a
// step.  Phase A reads H^T's tile (resident) and the step's W^T slice (two
// stages); phase B the step's [KN][32] slice of W's phase-B copy (one
// stage, fetched at the top of the step).  Only kb = 0 adds ll; TERMS=false
// (loglik_sum) has nkb = 1 and no phase B, LOSS=false (h_terms) no logs.
template <int KN, bool SECOND, typename Y, bool TERMS, bool LOSS>
__global__ void __launch_bounds__(kWg, KN == 128 ? 2 : 3)
hpass_tf32_wgmma_kernel(const float* __restrict__ WT, const float* __restrict__ Wk,
                        const float* __restrict__ HT, const Y* __restrict__ y,
                        const Y* __restrict__ y2, float* __restrict__ num_out,
                        float* __restrict__ den_out, double* __restrict__ ll_part, int k, int Mp,
                        int Np, int bm, int m_real, int n_real, int kstage, int Mps, int Nps,
                        int ncb, float eps) {
    constexpr bool kDense = !std::is_same<Y, int32_t>::value;
    extern __shared__ uint8_t smem_raw[];
    __shared__ double ll_warp[kWg / 32];
    float* Xs = reinterpret_cast<float*>(align1024(smem_raw));  // H^T tile [kstage/32][64][32]
    float* Sbuf = Xs + kTile * kstage;  // W^T slice, two stages of [kstage/32][32][32]
    float* Bs = Sbuf + 2 * kStep * kstage;  // W's phase-B slice [KN][32] (TERMS)

    const int bmw = bm / 32, Mw = Mp / 32;
    const size_t z = blockIdx.z;
    WT += z * Mps * kstage;
    Wk += z * kstage * Mps;
    HT += z * Nps * kstage;
    const int cb = blockIdx.x % ncb, kb = blockIdx.x / ncb;
    const int c0 = cb * kTile;
    const int S = gridDim.y, s = blockIdx.y;
    const int w_begin = s * (Mw / S) + min(s, Mw % S);
    const int w_end = w_begin + Mw / S + (s < Mw % S ? 1 : 0);
    const int ksteps = (k + 7) / 8;

    // This thread's accumulator entries: columns c0 + m for m = mrow, mrow + 8.
    const int mrow = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);

    float acc1[TERMS ? KN / 2 : 1], acc2[TERMS ? KN / 2 : 1];
#pragma unroll
    for (int i = 0; i < (TERMS ? KN / 2 : 1); ++i) acc1[i] = acc2[i] = 0.f;
    double ll = 0.0;

    if (w_begin < w_end) {
        load_tile_tf32(Xs, HT + (size_t)c0 * kstage, kstage, kTile, kstage);
        load_tile_tf32(Sbuf, WT + (size_t)kStep * w_begin * kstage, kstage, kStep, kstage);
        cp_async_commit();
    }
    for (int w = w_begin, st = 0; w < w_end; ++w, st ^= 1) {
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();  // step w's W^T slice has landed; the previous step's products are done
        if constexpr (TERMS) {
            load_tile_tf32(Bs, Wk + (size_t)kb * KN * Mps + kStep * w, Mps, KN, kStep);
            cp_async_commit();
        }
        if (w + 1 < w_end)
            load_tile_tf32(Sbuf + (st ^ 1) * kStep * kstage, WT + (size_t)kStep * (w + 1) * kstage,
                           kstage, kStep, kstage);
        cp_async_commit();
        const float* Ss = Sbuf + st * kStep * kstage;

        // ---- phase A: D1 (64 columns x 32 data rows) = H_tile^T W_slice;
        // the first product overwrites d (scale_d 0)
        float d[16];
        wgmma_fence();
#pragma unroll 1
        for (int j = 0; j < ksteps; ++j)
            wgmma_m64n32k8_tf32_ss(d, desc_tf32(Xs, kTile, 0, j), desc_tf32(Ss, kStep, 0, j), j > 0);
        wgmma_commit();

        // The data of this thread's entries while the products run: local
        // data row frag_n(i) is bit frag_n(i) of word row w.
        float ym[16], yc[16];
        uint32_t word[2] = {0u, 0u}, word2[2] = {0u, 0u};
        if constexpr (kDense) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int col = c0 + frag_m(i);
                const bool ok = col < Np;
                const size_t row = (size_t)word_row_bit(w, frag_n(i), bm, bmw);
                ym[i] = ok ? dense_value(y + row * Np + col) : 0.f;
                if constexpr (SECOND) yc[i] = ok ? dense_value(y2 + row * Np + col) : 0.f;
            }
        } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = c0 + mrow + 8 * h;
                const bool ok = col < Np;
                word[h] = ok ? (uint32_t)__ldg(y + (size_t)w * Np + col) : 0u;
                if constexpr (SECOND) word2[h] = ok ? (uint32_t)__ldg(y2 + (size_t)w * Np + col) : 0u;
            }
        }
        wgmma_wait0();
        fence_regs(d);

        // ---- the elementwise step: p, q (as TF32 bits), ll
        uint32_t pa[16], qa[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int b = frag_n(i), h = (i >> 1) & 1;
            const int col = c0 + frag_m(i);
            const bool valid = col < Np;
            const float v = d[i];
            const float a = v + eps;
            const float bb = fmaxf(1.f - v, 0.f) + eps;
            const float rr = 1.f / (a * bb);
            const bool in_region = valid && word_row_bit(w, b, bm, bmw) < m_real && col < n_real;
            float p, q;
            if constexpr (kDense) {
                const float c = SECOND ? yc[i] : 1.f - ym[i];
                p = ym[i] * (bb * rr);
                q = c * (a * rr);
                if (LOSS && in_region) ll += (double)fmaf(ym[i], logf(a), c * logf(bb));
            } else {
                const bool bit = (word[h] >> b) & 1u;
                p = bit ? bb * rr : 0.f;
                float sel;
                if constexpr (SECOND) {
                    const bool bit2 = (word2[h] >> b) & 1u;
                    q = bit2 ? a * rr : 0.f;
                    sel = bit ? a : (bit2 ? bb : 1.f);
                } else {
                    q = bit ? 0.f : a * rr;
                    sel = bit ? a : bb;
                }
                if (LOSS && in_region) ll += (double)logf(sel);
            }
            pa[i] = tf32_bits(valid ? p : 0.f);
            qa[i] = tf32_bits(valid ? q : 0.f);
        }

        // ---- phase B: Num^T += P^T W_slice^T, Den^T += Q^T W_slice^T
        if constexpr (TERMS) {
            cp_async_wait_1();  // the W slice has landed (the next W^T slice may not have)
            fence_proxy_async();
            __syncthreads();
            wgmma_fence();
            phase_b_tf32<KN>(acc1, pa, Bs);
            phase_b_tf32<KN>(acc2, qa, Bs);
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
// chunk of plan_w_split (whole 32-column tiles), walked one tile a step
// (columns past Np are masked).  Phase A reads W^T's rows (resident) and the
// step's H^T tile (two stages); phase B the step's [KN][32] tiles of H and
// 1 - H (one stage each, fetched at the top of the step).
template <int KN, bool SECOND, typename Y>
__global__ void __launch_bounds__(kWg, KN == 128 ? 2 : 3)
wpass_tf32_wgmma_kernel(const float* __restrict__ WT, const float* __restrict__ HT,
                        const float* __restrict__ Hk, const float* __restrict__ Hck,
                        const Y* __restrict__ y, const Y* __restrict__ y2,
                        float* __restrict__ dst, int k, int Mp, int Np, int bm, int n_real,
                        int kstage, int Mps, int Nps, int nrb, float eps) {
    constexpr bool kDense = !std::is_same<Y, int32_t>::value;
    extern __shared__ uint8_t smem_raw[];
    float* Xs = reinterpret_cast<float*>(align1024(smem_raw));  // W^T rows [kstage/32][64][32]
    float* Sbuf = Xs + kTile * kstage;  // H^T tile, two stages of [kstage/32][32][32]
    float* Bs = Sbuf + 2 * kStep * kstage;  // H's phase-B tile [KN][32], then 1 - H's

    const int bmw = bm / 32, Mw = Mp / 32;
    const size_t z = blockIdx.z;
    WT += z * Mps * kstage;
    HT += z * Nps * kstage;
    Hk += z * kstage * Nps;
    Hck += z * kstage * Nps;
    const int rb = blockIdx.x % nrb, kb = blockIdx.x / nrb;
    const int w0 = 2 * rb;
    const int nt = (Np + 31) / 32;
    const int S = gridDim.y, s = blockIdx.y;
    const int t_begin = s * (nt / S) + min(s, nt % S);
    const int t_end = t_begin + nt / S + (s < nt % S ? 1 : 0);
    const int c_begin = 32 * t_begin, c_end = min(32 * t_end, Np);
    const int ksteps = (k + 7) / 8;

    // This thread's data rows: local m = mrow, mrow + 8, both bits of one
    // word row.
    const int mrow = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
    const int wr = w0 + (mrow >> 5);
    const bool row_ok = wr < Mw;

    float tp[KN / 2], tq[KN / 2];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) tp[i] = tq[i] = 0.f;

    if (c_begin < c_end) {
        load_tile_tf32(Xs, WT + (size_t)kTile * rb * kstage, kstage, kTile, kstage);
        load_tile_tf32(Sbuf, HT + (size_t)c_begin * kstage, kstage, kStep, kstage);
        cp_async_commit();
    }
    for (int c = c_begin, st = 0; c < c_end; c += kStep, st ^= 1) {
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();  // step c's H^T tile has landed; the previous step's products are done
        load_tile_tf32(Bs, Hk + (size_t)kb * KN * Nps + c, Nps, KN, kStep);
        load_tile_tf32(Bs + KN * kStep, Hck + (size_t)kb * KN * Nps + c, Nps, KN, kStep);
        cp_async_commit();
        if (c + kStep < c_end)
            load_tile_tf32(Sbuf + (st ^ 1) * kStep * kstage, HT + (size_t)(c + kStep) * kstage,
                           kstage, kStep, kstage);
        cp_async_commit();
        const float* Hs = Sbuf + st * kStep * kstage;

        // ---- phase A: D1 (64 data rows x 32 columns) = W_rows^T H_tile (the
        // first product overwrites d)
        float d[16];
        wgmma_fence();
#pragma unroll 1
        for (int j = 0; j < ksteps; ++j)
            wgmma_m64n32k8_tf32_ss(d, desc_tf32(Xs, kTile, 0, j), desc_tf32(Hs, kStep, 0, j), j > 0);
        wgmma_commit();

        // The data of this thread's entries while the products run: columns
        // c + frag_n(i), rows mrow and mrow + 8.
        float ym[16], ym2[16];
        uint32_t word[8], word2[8];
        if constexpr (kDense) {
            const size_t row0 = (size_t)word_row_bit(wr, mrow & 31, bm, bmw);
            const size_t row1 = (size_t)word_row_bit(wr, (mrow + 8) & 31, bm, bmw);
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int col = c + frag_n(i);
                const bool ok = row_ok && col < c_end;
                const size_t row = ((i >> 1) & 1) ? row1 : row0;
                ym[i] = ok ? dense_value(y + row * Np + col) : 0.f;
                if constexpr (SECOND) ym2[i] = ok ? dense_value(y2 + row * Np + col) : 0.f;
            }
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
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

        // ---- the elementwise step: p, q (as TF32 bits)
        uint32_t pa[16], qa[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int col = c + frag_n(i);
            const bool col_in = row_ok && col < c_end;
            const float v = d[i];
            const float a = v + eps;
            const float bb = fmaxf(1.f - v, 0.f) + eps;
            const float rr = 1.f / (a * bb);
            float pv, qv;
            if constexpr (kDense) {
                const float cm = SECOND ? ym2[i] : (col < n_real ? 1.f - ym[i] : 0.f);
                pv = col_in ? ym[i] * (bb * rr) : 0.f;
                qv = col_in ? cm * (a * rr) : 0.f;
            } else {
                const int j = 2 * (i >> 2) + (i & 1);  // the word of this entry
                const int b = frag_m(i) & 31;
                const bool bit = (word[j] >> b) & 1u;
                const bool bit2 = SECOND ? ((word2[j] >> b) & 1u) : (!bit && col < n_real);
                pv = (col_in && bit) ? bb * rr : 0.f;
                qv = (col_in && bit2) ? a * rr : 0.f;
            }
            pa[i] = tf32_bits(pv);
            qa[i] = tf32_bits(qv);
        }

        // ---- phase B: T^T += P H_tile^T and += Q (1 - H)_tile^T, apart
        cp_async_wait_1();  // the H and 1 - H tiles have landed
        fence_proxy_async();
        __syncthreads();
        wgmma_fence();
        phase_b_tf32<KN>(tp, pa, Bs);
        phase_b_tf32<KN>(tq, qa, Bs + KN * kStep);
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
// Shared memory a block asks for (cuda_sweep.wgmma_shape mirrors it): the
// resident phase-A tile (64 rows), two stages of the streamed one (32 rows),
// the phase-B tiles ([KN][32]: W's for the H pass with TERMS, H's and
// 1 - H's for the W pass), 1024-byte aligned.
__host__ __device__ inline size_t tf32_smem(int kstage, int kn, int phase_b_tiles) {
    return sizeof(float) * ((size_t)(kTile + 2 * kStep) * kstage + (size_t)phase_b_tiles * kn * kStep) +
           1024;
}

// The TF32 copies of one call, each lane's at plan_wgmma's geometry: W^T
// (wt, Mps x kstage) and, where given, W's phase-B copy (wk, kstage x Mps);
// H^T (ht, Nps x kstage) and, where given, H's and 1 - H's phase-B copies
// (hk, hck, kstage x Nps).
cudaError_t stage_tf32(const float* W, const float* H, float* wt, float* wk, float* ht, float* hk,
                       float* hck, int k, int Mp, int Np, int bm, int lanes, cudaStream_t stream) {
    const WgmmaPlan pl = plan_wgmma(k, Mp, Np);
    const dim3 block(32, 8);
    stage_w_tf32_kernel<<<dim3(pl.Mps / 32, pl.kstage / 32, lanes), block, 0, stream>>>(
        W, wt, wk, k, Mp, bm, pl.kstage, pl.Mps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    stage_h_tf32_kernel<<<dim3(pl.Nps / 32, pl.kstage / 32, lanes), block, 0, stream>>>(
        H, ht, hk, hck, k, Np, pl.kstage, pl.Nps);
    return cudaGetLastError();
}

template <class Kernel>
cudaError_t occupancy_of(Kernel kernel, size_t smem, int* blocks) {
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kWg, smem);
}

template <bool SECOND, typename Y, bool TERMS, bool LOSS>
struct HpassTf32Launcher {
    template <int KN>
    static cudaError_t occupancy(int k, int* blocks, int* smem) {
        const size_t bytes = tf32_smem(plan_wgmma(k, 1, 1).kstage, KN, TERMS ? 1 : 0);
        *smem = (int)bytes;
        return occupancy_of(hpass_tf32_wgmma_kernel<KN, SECOND, Y, TERMS, LOSS>, bytes, blocks);
    }
    template <int KN>
    static cudaError_t launch(const float* wt, const float* wk, const float* ht, const Y* y,
                              const Y* y2, float* num, float* den, double* ll_part, int k, int Mp,
                              int Np, int bm, int m_real, int n_real, int nsplit, int lanes,
                              float eps, cudaStream_t stream) {
        const WgmmaPlan pl = plan_wgmma(k, Mp, Np);
        auto kernel = hpass_tf32_wgmma_kernel<KN, SECOND, Y, TERMS, LOSS>;
        const size_t smem = tf32_smem(pl.kstage, KN, TERMS ? 1 : 0);
        cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        const int ncb = (Np + kTile - 1) / kTile;
        const dim3 grid(ncb * (TERMS ? pl.nkb : 1), nsplit, lanes);
        kernel<<<grid, kWg, smem, stream>>>(wt, wk, ht, y, y2, num, den, ll_part, k, Mp, Np, bm,
                                            m_real, n_real, pl.kstage, pl.Mps, pl.Nps, ncb, eps);
        return cudaGetLastError();
    }
};

template <bool SECOND, typename Y>
struct WpassTf32Launcher {
    template <int KN>
    static cudaError_t occupancy(int k, int* blocks, int* smem) {
        const size_t bytes = tf32_smem(plan_wgmma(k, 1, 1).kstage, KN, 2);
        *smem = (int)bytes;
        return occupancy_of(wpass_tf32_wgmma_kernel<KN, SECOND, Y>, bytes, blocks);
    }
    template <int KN>
    static cudaError_t launch(const float* wt, const float* ht, const float* hk, const float* hck,
                              const Y* y, const Y* y2, float* dst, int k, int Mp, int Np, int bm,
                              int n_real, int nsplit, int lanes, float eps, cudaStream_t stream) {
        const WgmmaPlan pl = plan_wgmma(k, Mp, Np);
        auto kernel = wpass_tf32_wgmma_kernel<KN, SECOND, Y>;
        const size_t smem = tf32_smem(pl.kstage, KN, 2);
        cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        const int nrb = (Mp / 32 + 1) / 2;
        const dim3 grid(nrb * pl.nkb, nsplit, lanes);
        kernel<<<grid, kWg, smem, stream>>>(wt, ht, hk, hck, y, y2, dst, k, Mp, Np, bm, n_real,
                                            pl.kstage, pl.Mps, pl.Nps, nrb, eps);
        return cudaGetLastError();
    }
};

template <class L>
cudaError_t occupancy_kn(int k, int* blocks, int* smem) {
    if (k <= 32) return L::template occupancy<32>(k, blocks, smem);
    if (k <= 64) return L::template occupancy<64>(k, blocks, smem);
    return L::template occupancy<128>(k, blocks, smem);
}

// The H pass of the TF32 form with its fixed-order reductions: the contract
// of run_hloss_as (sweep_kernels.cuh) with the TF32 copies of W (wt, lanes x
// Mps x kstage; wk, lanes x kstage x Mps) and H (ht, lanes x Nps x kstage)
// as scratch in place of wperm (cuda_sweep.plan_wgmma gives the sizes).
template <bool SECOND, typename Y, bool TERMS, bool LOSS>
int run_hloss_tf32_as(const float* W, const float* H, const Y* y, const Y* y2, float* num,
                      float* den, float* num_part, float* den_part, double* ll_part, float* ll,
                      float* wt, float* wk, float* ht, int k, int Mp, int Np, int bm, int m_real,
                      int n_real, int nsplit, int lanes, float eps, int device, void* stream_ptr) {
    const auto misaligned = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
    const bool split = TERMS && nsplit > 1;
    if (!geometry_ok(k, Mp, Np, bm, lanes) || Np % 4 || nsplit < 1 || nsplit > Mp / 32 ||
        wt == nullptr || ht == nullptr || (TERMS && wk == nullptr) || misaligned(wt) ||
        misaligned(wk) || misaligned(ht) || misaligned(y) || misaligned(y2) ||
        (TERMS && (num == nullptr || den == nullptr)) ||
        (split && (num_part == nullptr || den_part == nullptr)) ||
        (LOSS && (ll_part == nullptr || ll == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    err = stage_tf32(W, H, wt, TERMS ? wk : nullptr, ht, nullptr, nullptr, k, Mp, Np, bm, lanes,
                     stream);
    if (err != cudaSuccess) return (int)err;
    using L = HpassTf32Launcher<SECOND, Y, TERMS, LOSS>;
    if constexpr (TERMS)
        err = dispatch_kn<L>(k, wt, wk, ht, y, y2, split ? num_part : num, split ? den_part : den,
                             ll_part, k, Mp, Np, bm, m_real, n_real, nsplit, lanes, eps, stream);
    else  // no phase B: one width
        err = L::template launch<32>(wt, wk, ht, y, y2, num, den, ll_part, k, Mp, Np, bm, m_real,
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
int run_hloss_tf32(const float* W, const float* H, const Y* y, const Y* y2, float* num, float* den,
                   float* num_part, float* den_part, double* ll_part, float* ll, float* wt,
                   float* wk, float* ht, int k, int Mp, int Np, int bm, int m_real, int n_real,
                   int nsplit, int lanes, float eps, int device, void* stream_ptr) {
    if (y2 != nullptr)
        return run_hloss_tf32_as<true, Y, TERMS, LOSS>(W, H, y, y2, num, den, num_part, den_part,
                                                       ll_part, ll, wt, wk, ht, k, Mp, Np, bm,
                                                       m_real, n_real, nsplit, lanes, eps, device,
                                                       stream_ptr);
    return run_hloss_tf32_as<false, Y, TERMS, LOSS>(W, H, y, y2, num, den, num_part, den_part,
                                                    ll_part, ll, wt, wk, ht, k, Mp, Np, bm,
                                                    m_real, n_real, nsplit, lanes, eps, device,
                                                    stream_ptr);
}

// The W pass of the TF32 form: the contract of run_wterms_as with the TF32
// copies W^T (wt), H^T (ht) and H's and 1 - H's phase-B copies (hk, hck,
// lanes x kstage x Nps) as scratch.
template <bool SECOND, typename Y>
int run_wterms_tf32_as(const float* W, const float* H, const Y* y, const Y* y2, float* T,
                       float* part, float* wt, float* ht, float* hk, float* hck, int k, int Mp,
                       int Np, int bm, int n_real, int nsplit, int lanes, float eps, int device,
                       void* stream_ptr) {
    const auto misaligned = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
    if (!geometry_ok(k, Mp, Np, bm, lanes) || Np % 4 || nsplit < 1 ||
        nsplit > (Np + kWCols - 1) / kWCols || (nsplit > 1 && part == nullptr) ||
        wt == nullptr || ht == nullptr || hk == nullptr || hck == nullptr || misaligned(wt) ||
        misaligned(ht) || misaligned(hk) || misaligned(hck) || misaligned(y) || misaligned(y2))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    err = stage_tf32(W, H, wt, nullptr, ht, hk, hck, k, Mp, Np, bm, lanes, stream);
    if (err != cudaSuccess) return (int)err;
    err = dispatch_kn<WpassTf32Launcher<SECOND, Y>>(k, wt, ht, hk, hck, y, y2,
                                                    nsplit > 1 ? part : T, k, Mp, Np, bm, n_real,
                                                    nsplit, lanes, eps, stream);
    if (err != cudaSuccess) return (int)err;
    if (nsplit > 1) {
        const size_t count = (size_t)k * Mp;
        const dim3 blocks((unsigned)((count + kThreads - 1) / kThreads), lanes);
        sum_parts_kernel<<<blocks, kThreads, 0, stream>>>(part, T, nsplit, count);
    }
    return (int)cudaGetLastError();
}

template <typename Y>
int run_wterms_tf32(const float* W, const float* H, const Y* y, const Y* y2, float* T, float* part,
                    float* wt, float* ht, float* hk, float* hck, int k, int Mp, int Np, int bm,
                    int n_real, int nsplit, int lanes, float eps, int device, void* stream_ptr) {
    if (y2 != nullptr)
        return run_wterms_tf32_as<true, Y>(W, H, y, y2, T, part, wt, ht, hk, hck, k, Mp, Np, bm,
                                           n_real, nsplit, lanes, eps, device, stream_ptr);
    return run_wterms_tf32_as<false, Y>(W, H, y, y2, T, part, wt, ht, hk, hck, k, Mp, Np, bm,
                                        n_real, nsplit, lanes, eps, device, stream_ptr);
}

// Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
// instance's shared memory) and that shared memory, of the instance a pass
// launches for rank k, with y2 given (second) or not.
template <typename Y, bool TERMS, bool LOSS>
cudaError_t hpass_tf32_occupancy(int k, int second, int* blocks, int* smem) {
    if constexpr (!TERMS)  // one width
        return second ? HpassTf32Launcher<true, Y, false, LOSS>::template occupancy<32>(k, blocks, smem)
                      : HpassTf32Launcher<false, Y, false, LOSS>::template occupancy<32>(k, blocks, smem);
    else
        return second ? occupancy_kn<HpassTf32Launcher<true, Y, true, LOSS>>(k, blocks, smem)
                      : occupancy_kn<HpassTf32Launcher<false, Y, true, LOSS>>(k, blocks, smem);
}
template <typename Y>
cudaError_t wpass_tf32_occupancy(int k, int second, int* blocks, int* smem) {
    return second ? occupancy_kn<WpassTf32Launcher<true, Y>>(k, blocks, smem)
                  : occupancy_kn<WpassTf32Launcher<false, Y>>(k, blocks, smem);
}

}  // namespace

// The C entry points of the TF32 form.  The f32 entry points' signatures
// (sweep_packed.cu, sweep_dense.cu) with the TF32 copies as scratch: the H
// passes take wt, wk, ht in place of wperm; the W pass takes wt, ht, hk, hck
// after part.
#define NBMF_TF32_H_ENTRY(NAME, Y, TERMS, LOSS)                                                   \
    int NAME(const float* W, const float* H, const Y* y, const Y* y2, float* num, float* den,     \
             float* num_part, float* den_part, double* ll_part, float* ll, float* wt, float* wk,  \
             float* ht, int k, int Mp, int Np, int bm, int m_real, int n_real, int nsplit,        \
             int lanes, float eps, int device, void* stream_ptr) {                                \
        return run_hloss_tf32<Y, TERMS, LOSS>(W, H, y, y2, num, den, num_part, den_part, ll_part, \
                                              ll, wt, wk, ht, k, Mp, Np, bm, m_real, n_real,      \
                                              nsplit, lanes, eps, device, stream_ptr);            \
    }
#define NBMF_TF32_W_ENTRY(NAME, Y)                                                                \
    int NAME(const float* W, const float* H, const Y* y, const Y* y2, float* T, float* part,      \
             float* wt, float* ht, float* hk, float* hck, int k, int Mp, int Np, int bm,          \
             int n_real, int nsplit, int lanes, float eps, int device, void* stream_ptr) {        \
        return run_wterms_tf32<Y>(W, H, y, y2, T, part, wt, ht, hk, hck, k, Mp, Np, bm, n_real,   \
                                  nsplit, lanes, eps, device, stream_ptr);                        \
    }
