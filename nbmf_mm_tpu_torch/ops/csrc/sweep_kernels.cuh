// NBMF-MM sweep passes for NVIDIA Hopper (sm_90a): the kernel templates
// shared by the bit-packed entry points (sweep_packed.cu) and the dense ones
// (sweep_dense.cu).
//
// Two passes per sweep, each templated on its operand type Y:
//   hpass_kernel  Num = W.P, Den = W.Q (k, Np) and the Bernoulli
//                 log-likelihood ll of the current (W, H); with TERMS=false
//                 only ll (the loglik_sum pass);
//   wpass_kernel  T = H.P^T + (1-H).Q^T (k, Mp) with the new H.
// The H pass also takes LOSS (false: the logs compiled out, h_terms) and
// both take a per-entry policy E (struct Sweep below); the defaults are the
// production passes, and the measurement probes of probes.cu set the rest.
// Y = int32_t reads bit-packed words, Y = float reads dense (Mp, Np) f32
// operands.  The loaders yield the 32 data rows of word row w in the same
// bit-plane order (row0 + b*bmw for bit b), so the two instances share the
// block split, the register accumulators and the fixed-order sums, and on
// exactly-binary operands the dense instance gives the packed one's outputs
// bitwise (the select identities of the JAX package's
// pallas_sweep.py:744-752: 1*x = x, 0*x + y = y).
//
// Notation: WH = W^T H, a = WH + eps, b = max(1 - WH, 0) + eps,
// r = 1/(a b), p = ym (b r), q = yc (a r), ll = ym log a + yc log b; packed
// operands collapse each to a select.  Layout (kept bit-identical to
// pallas_sweep.py::pack_bits): word row w = j*bmw + i, bit b holds data row
// j*bm + b*bmw + i, bmw = bm/32.
//
// What bounds them on an H100: at m = n = 1e4, k = 128 each pass forms
// three m x n x k products, 3 m n k FMAs = 6 m n k = 7.7e10 flops (the H
// pass WH, W.P and W.Q; the W pass WH, H.P^T and (1-H).Q^T), against
// 12.5 MB of words or 400 MB of dense f32 (0.12 ms of HBM time at
// 3.35 TB/s), so both are bound by fp32 arithmetic, not by device memory:
// 1.146 ms each at the 67 TFLOP/s fp32 CUDA-core peak.  (The reference's
// cost estimate for the H pass, 8 m n k at pallas_sweep.py:321, counts
// work the pass does not do; its h_terms estimate, :192, counts 6 m n k.)
//
// The H pass (hpass_kernel) replaces the TPU kernels hloss_terms_packed
// (pallas_sweep.py:843), hloss_terms (:212), hloss_terms_stripe (:546),
// loglik_sum (:444) and h_terms (:122).  It is the mirror image of the W
// pass, designed against what held back the first port of it (one 32 x 32
// tile per word row, 27% of its bound):
//   - FMAs per shared load: register micro-tiles for both products with
//     16-byte shared loads.  Phase A (the 32 x 64 WH tile, 4 rows x 2
//     columns a thread) issues 6 loads per 32 FMAs where the first port
//     issued 5 per 4; phase B (Num/Den, 8 k rows x 4 columns a thread, one
//     float4 of W feeding both sums) 16 loads per 256 FMAs where it issued
//     18 per 32;
//   - the strided W gather: a (k, Mp) copy of W in bit-plane order (column
//     32 w + b holds data row b of word row w), made once per call by a
//     small kernel, so each step's W slice is 8 contiguous 16-byte runs per
//     k row for every stripe bm from 32 to Mp (bf16 rounding, where a probe
//     asks for it, is folded into the copy);
//   - stalls on loads: the next step's W slice and operand tile arrive by
//     cp.async into a second buffer while the current step accumulates; one
//     barrier per phase, two per word row;
//   - filling the card: 64-column blocks times S chunks of whole word rows,
//     S planned on the host (cuda_sweep.plan_h_split) for at least two
//     rounds of resident blocks, the S partials added in a fixed order by a
//     second kernel;
//   - registers: __launch_bounds__ keeps two 256-thread blocks on an SM up
//     to k = 128 (one above), for every instance, h_terms included;
//   - serialised phases at TK = 16 (k = 129..256).  There one block an SM
//     (128 accumulators a thread) leaves no second block to fill the FMA
//     pipes while a word row's phase A, logs and barriers run, so the
//     production pass (TERMS, policy Sweep) is warp-specialised
//     (hpass_split): a warpgroup of producers runs phase A of word row v
//     (4 x 4 register tiles of WH: 8 loads per 64 FMAs), the reciprocals,
//     the logs and the cp.async copies, while two warpgroups of consumers
//     run phase B of row v - 1; they meet on named barriers in a ring of
//     three W slices and two stages each of Ps/Qs and of the operand tiles
//     (193 KiB a block packed, 224 KiB dense with two operands), and
//     setmaxnreg moves registers from the producers (120 a thread) to the
//     consumers (192).  A consumer loads k row kg + 16 (i + 1) of W before
//     the FMAs of row kg + 16 i: behind the loop's dead-row exit test (as
//     the turn-taking body still has it) each load waited for its data.
//     Both bodies call one copy of the stage copies, the per-entry p, q and
//     ll terms, the phase-B sums and the write-out (hpass_stage,
//     hpass_column, hpass_accumulate, hpass_write), so their Num and Den
//     stay bitwise equal.
//     K1 at 10240^2, k = 256, 16 lanes: 79.66 ms against the turn-taking
//     body's 93.56 (48% of the 38.46 ms bound; H100 SXM, 700 W).  What
//     bounds it is latency, not a pipe: one producer and two consumer warps
//     an SM sub-partition issue about half the cycles, and each role alone
//     runs at twice its share of the FMA time; a 16-byte shared load costs
//     an SM about 2 to 2.5 cycles whatever its addresses (8 or 16 warps
//     loading).  Measured slower (ms, same calls): two 32-column
//     turn-taking blocks an SM (100.8); 256 producer threads of 4 x 2 tiles
//     (90.9 to 100.5); every role at the launch's 168 registers (101.7,
//     spilling); consumers at 200 to 216 registers (95.9 to 103.2: the
//     producers' loop schedules worse in what is left); p and q loaded a
//     step ahead (104.5 to 107.8); W loaded behind the exit test (80.68).
//
// The W pass (wpass_kernel) replaces the TPU kernels w_terms_packed
// (pallas_sweep.py:947), w_terms (:333) and w_terms_stripe (:650).  Its work
// is two products of different shapes with an elementwise step between:
// phase A, the 64 x 32 WH tile of a block (contraction over k, a third of
// the FMAs), then p and q, then phase B, the k x 64 sums of H.P^T and
// (1-H).Q^T held in registers across every column (two thirds).  What
// bounds it on this card, and what the design does about each:
//   - shared-memory loads.  A 16-byte load is served a quarter-warp at a
//     time, about a cycle for each 128 distinct bytes the quarters ask for,
//     broadcasts merging only inside a quarter.  So the register tiles are
//     large (phase A 4 x 4 a thread, 8 loads per 64 FMAs; phase B 8 k rows x
//     8 data rows, 16 loads per 256 FMAs), and lanes are laid out so that a
//     quarter-warp reads at most 4 distinct chunks a load;
//   - registers: 64 accumulators a thread in phase B.  A thread holds a
//     step's 8 float4 of h and streams p one row at a time, so the next
//     row's load runs behind the FMAs of this one within 128 registers;
//   - serialised phases.  With phase A, the elementwise step and the copies
//     in the same warps as phase B, every barrier idles the FMA pipes unless
//     another block fills them, and two blocks of large tiles do not fit in
//     shared memory.  So at k = 65..128 a block is warp-specialised: two
//     groups of 4 producer warps take alternate tiles (phase A, the IEEE
//     reciprocals, 1 - h, the cp.async copies) and 8 consumer warps run
//     phase B, meeting on named barriers in a ring of tiles that fills one
//     SM's shared memory (224 KiB with two dense operands).  At other k one
//     group of 8 warps runs the phases in turn, two blocks per SM up to
//     k = 64 and one above;
//   - filling the card: 64-row blocks times S column chunks, S planned on
//     the host (cuda_sweep.plan_w_split, from the pass's own occupancy) for
//     at least two rounds of resident blocks, the S partials added in a
//     fixed order by a second kernel.
// Designs measured slower at 10240^2, k = 128 (H100 SXM, 700 W): the first port (one block per
// word row walking every column, 9 TFLOP/s); 2 x 4 phase-A tiles and 8 x 4
// phase-B tiles of both sums a thread at two 256-thread blocks per SM (128
// registers; 2.82 ms); the same at one block per SM with 168 registers
// (3.51 ms: more registers, same loads per FMA, half the warps); 4 x 4 and 8
// x 8 tiles on 64-column tiles at one 256-thread block per SM (2.91 ms: the
// loads per FMA fell, but the serialised phases grew from 0.18 to 0.67 ms);
// one group of 4 producer warps (2.62 ms: its own latency paced the
// pipeline); consumers that hold p and load h per k row (2.51 ms: each h
// load waited on its FMAs).
// fp32 FMA on the CUDA cores throughout.  The reduced-precision forms
// (precision "default" and "high", the bf16-data mode; ops/tiers.py) run on
// the tensor cores (sweep_wgmma.cuh, sweep_wgmma_tf32.cuh).
//
// Lanes: every kernel here takes a leading lane axis R on the factors from
// its grid (blockIdx.z of the two passes, blockIdx.y of the small kernels
// around them): lane r reads W[r] (k, Mp) and H[r] (k, Np) and writes its own
// outputs, partials and ll, while the data operands are shared by all lanes.
// This is the batch dimension jax.vmap gives the TPU kernels for restarts and
// hyperparameter grids.  The block split does not depend on R, so a lane adds
// its partials in the order a one-lane launch does and equals it bitwise.
//
// Determinism: no float atomics.  Every output element and every partial is
// written by one thread, and the cross-block sums (the H pass's split over
// m and its ll partials, the W pass's split over n) run in a fixed order in
// separate small kernels, so a launch on the same inputs gives bitwise the
// same outputs.
//
// Numerics follow the TPU kernels: one IEEE reciprocal r = 1/(a b), logf,
// two nonnegative accumulations in the W pass (never the one-matmul identity
// H (P - Q)^T + sum Q, which cancels when q ~ 1e8 near WH -> 1).  Dense ll
// takes both logs (ym log a + yc log b), never log of a select.  Build
// without --use_fast_math.  ll is masked exactly to row < m_real and
// col < n_real (the TPU stripe and packed kernels add log(1 + eps) per pad
// entry instead).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Launches of the warp-specialised H pass (HPass::kSplit) since the library
// was loaded, counted by its launcher (defined in sweep_packed.cu), so that
// a caller can tell which body a launch ran.
extern "C" long long nbmf_h_split_launches;

namespace {

// Rounding of the product operands (the bf16 probes).
enum class Round : int { kNone = 0, kBf16 = 1 };

// Per-entry policy of the two passes.  Sweep is the production policy; the
// measurement probes of probes.cu derive from it and change single values,
// so every production instance compiles to the code it had without them.
struct Sweep {
    // b = max(1 - WH, 0) + eps; false: 1 - WH + eps (the tools/ probes).
    static constexpr bool kClampB = true;
    // Packed operands: p, q and ll as selects on the bit, one log; false:
    // ym = (float)bit, products and two logs (tools/bench_packed.py).
    static constexpr bool kSelect = true;
    // H pass with the ratios replaced by an identity step (matmul-only
    // probes): 0 none; 1 p = WH, q = WH + 1; 2 p = WH + y, q = WH - y;
    // 3 p = WH, q = (S - j) WH for stripe j of S (o2 += o1 per stripe).
    static constexpr int kIdentity = 0;
    // W pass: 0 T = H.P^T + (1-H).Q^T; 1 the one-matmul probe
    // T = H.(P-Q)^T + sum_n Q; 2 chain3_tile, T = H.WH^T and
    // T2 = H.(WH+1)^T written as rows k..2k-1 of T.
    static constexpr int kWForm = 0;
    // Round every operand of every product before the fp32 FMA (sums stay
    // fp32): kBf16 to bf16, nearest even (the bf16 probes round W, H, the
    // tile values and the W pass's 1 - h as round(1 - h)).
    static constexpr Round kRound = Round::kNone;
};

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <Round R>
__device__ __forceinline__ float mxu_operand(float x) {
    if constexpr (R == Round::kBf16) return round_bf16(x);
    return x;
}

constexpr int kThreads = 256;

// out[e] = sum over s of part[s][e], s in order (the H pass's split over m),
// for lane blockIdx.y of (R, nsplit, count) partials and (R, count) outputs.
__global__ void sum_splits_kernel(const float* __restrict__ num_part,
                                  const float* __restrict__ den_part, float* __restrict__ num,
                                  float* __restrict__ den, int nsplit, size_t count) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= count) return;
    const size_t z = blockIdx.y;
    num_part += z * nsplit * count;
    den_part += z * nsplit * count;
    num += z * count;
    den += z * count;
    float sn = 0.f, sd = 0.f;
    for (int s = 0; s < nsplit; ++s) {
        sn += num_part[(size_t)s * count + e];
        sd += den_part[(size_t)s * count + e];
    }
    num[e] = sn;
    den[e] = sd;
}

// ll[r] = sum of lane r's per-block partials, in a fixed order (one block
// per lane, r = blockIdx.x, of (R, count) partials).
__global__ void sum_ll_kernel(const double* __restrict__ part, int count, float* __restrict__ ll) {
    __shared__ double s[kThreads];
    part += (size_t)blockIdx.x * count;
    ll += blockIdx.x;
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
// T = H.P^T + (1-H).Q^T (k, Mp), redesigned for the H100 (see the note at
// the head of this file for what it replaces, its bounds and the designs
// measured before this one).
//
// Grid (ceil(Mw/2), S, R): lane z = blockIdx.z reads W[z], H[z] and writes
// its own partials.  Block (x, s) of a lane owns the kWRows = 64 data rows
// of word rows 2x and 2x+1 (local row lr is bit lr % 32 of word row
// 2x + lr / 32, the bit-plane order of word_row_bit) and column chunk s of
// S, a run of whole 32-column tiles (the first nt % S chunks take one tile
// more).  Each block writes its (n_out k, 64) partial of T once, into T
// itself when S = 1 or into scratch (S, n_out k, Mp) per lane;
// sum_parts_kernel then adds the S partials in order s = 0, 1, ...: no float
// atomics, and a launch on the same inputs gives bitwise the same T.
//
// Per 32-column tile, two phases:
//   A  the 64 x 32 tile of WH, every phase-A thread kRA rows x 4 columns,
//      contraction over k in ascending order; then p and q written to
//      Ps/Qs, and 1 - h staged once into Hc;
//   B  the (k x 64) accumulation over the tile's columns, in column order,
//      by two groups of 128 threads, one product each: group 0 H.P^T,
//      group 1 (1-H).Q^T.  A thread holds k rows kg + 16 i (i < TK) and
//      data rows rg + 8 j (j < 8) of its product in registers.  The two
//      nonnegative sums meet once, at the end, through shared memory
//      (tp + tq, never the one-matmul identity).
// Warp-specialised (kSplit) the two phases run in different warps on
// different tiles (see the kernel); else they take turns between barriers,
// the next tile's H and operand tiles arriving by cp.async during phase B.
// Each row's arithmetic, and the order of every sum, is the same in both
// forms and in every geometry, so a T depends only on the split S.
// Shared tiles whose rows are read at one column chunk by many threads
// swizzle their 16-byte chunks (chunk c of row r stored at c ^ (r & 7)), so
// those reads are free of bank conflicts.
constexpr int kWRows = 64;  // data rows per block: two word rows
constexpr int kWCols = 32;  // columns per tile

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
    const int src_size = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
                 "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Data row of bit b of word row w for stripe bm (bmw = bm / 32).
__device__ __forceinline__ int word_row_bit(int w, int b, int bm, int bmw) {
    const int j = w / bmw;
    return j * bm + (w - j * bmw) + b * bmw;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 f4(const float v[4]) { return make_float4(v[0], v[1], v[2], v[3]); }

// A dense operand type (f32 here; bf16 in sweep_wgmma.cuh's bf16-data
// mode); int32 words are the packed operand.
template <typename Y>
constexpr bool dense_operand() { return !std::is_same<Y, int32_t>::value; }

// Named barriers (0 is __syncthreads): the W pass's producer and consumer
// warps meet on these; bar.arrive and bar.sync order shared-memory accesses
// like __syncthreads among the threads they count.
__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
enum WBarrier : int { kWFull = 1, kWEmpty = 4, kWProducers = 6, kWConsumers = 8 };

// Shapes of one W-pass instance: TK k rows per thread (kpad = 16 TK >= k).
template <int TK, bool SECOND, typename Y, class E>
struct WPass {
    static constexpr bool kDense = dense_operand<Y>();
    static constexpr bool kReads = E::kWForm != 2;  // chain3_tile reads no operand
    static constexpr bool kHc = E::kWForm == 0;     // (1 - H).Q^T
    // The second group's product: (1 - H).Q^T, or H.(WH + 1)^T for
    // chain3_tile; the one-matmul probe has none (its first group adds the
    // row sums of Q).
    static constexpr bool kTwo = E::kWForm != 1;
    static constexpr int kpad = 16 * TK;
    // Warp-specialised at TK = 8: two groups of 4 producer warps (phase A)
    // on alternate tiles and 8 consumer warps (phase B); else one group of 8
    // warps does both phases in turn.
    static constexpr bool kSplit = TK == 8;
    static constexpr int kProducers = kSplit ? 128 : kThreads;  // phase A threads of a tile
    static constexpr int kBlock = kSplit ? 512 : kThreads;
    static constexpr int kRowGroups = kProducers / 8;       // phase A: row groups
    static constexpr int kRA = kWRows / kRowGroups;          // phase A: rows a thread
    static constexpr int kOperands = kReads ? (SECOND ? 2 : 1) : 0;
    // Stages in flight: of H, the tile a copy fills, the two the producer
    // groups read and the consumers' tile; of Hc and Ps/Qs, the producers'
    // two and the consumers' one; of the operand tiles, one per producer
    // group.
    static constexpr int kHStages = kSplit ? 4 : 2;
    static constexpr int kStages = kSplit ? 3 : 1;
    static constexpr int kYStages = kSplit ? 2 : 1;
    // Shared memory in floats: Ws [kpad/4][64][4] (after the last tile, the
    // second group's sums); kHStages of Hs [kpad][32]; kStages each of Hc
    // [kpad][32] and of Ps and Qs [64][32]; kYStages of the operand tiles,
    // dense [64][32] or words [2][32], each.
    static constexpr int kWs = kpad * kWRows;
    static constexpr int kHs = kpad * kWCols;
    static constexpr int kPQ = kWRows * kWCols;
    static constexpr int kYs = kDense ? kWRows * kWCols : 2 * kWCols;
    static constexpr size_t kSmem =
        sizeof(float) * (size_t)(kWs + kHStages * kHs + kStages * ((kHc ? kHs : 0) + 2 * kPQ) +
                                 kYStages * kOperands * kYs);
    // Two blocks per SM (<= 128 registers a thread) up to TK = 4; one above
    // (at TK = 8, 512 threads of <= 128 registers).
    static constexpr int kMinBlocks = TK <= 4 ? 2 : 1;
    static_assert(128 * TK * 8 <= kWs, "Ws holds the second group's sums");
};

template <int TK, bool SECOND, typename Y, class E>
__global__ void __launch_bounds__((WPass<TK, SECOND, Y, E>::kBlock),
                                  (WPass<TK, SECOND, Y, E>::kMinBlocks))
wpass_kernel(const float* __restrict__ W, const float* __restrict__ H,
             const Y* __restrict__ y, const Y* __restrict__ y2, float* __restrict__ dst, int k,
             int Mp, int Np, int bm, int n_real, float eps) {
    using P = WPass<TK, SECOND, Y, E>;
    constexpr bool kDense = P::kDense;
    constexpr int kpad = P::kpad, kQ = kWCols / 4, kRG = P::kRowGroups, kRA = P::kRA;
    constexpr int kPQStage = 2 * P::kPQ, kYStage = P::kOperands * P::kYs;
    extern __shared__ __align__(16) float smem[];
    float* Ws = smem;
    float* Hring = Ws + P::kWs;
    float* Hcs = Hring + P::kHStages * P::kHs;
    float* PQs = Hcs + (P::kHc ? P::kStages * P::kHs : 0);
    float* Yring = PQs + P::kStages * kPQStage;  // y's tile, then y2's, a stage

    const int tid = threadIdx.x;
    const int bmw = bm / 32, Mw = Mp / 32;
    const size_t z = blockIdx.z;  // the lane: its W, H and partials
    W += z * k * Mp;
    H += z * k * Np;
    const int w0 = 2 * blockIdx.x;
    const int nt = (Np + kWCols - 1) / kWCols;
    const int S = gridDim.y, s = blockIdx.y;
    const int t_begin = s * (nt / S) + min(s, nt % S);
    const int t_end = t_begin + nt / S + (s < nt % S ? 1 : 0);
    const int kw = (k + 7) & ~7;  // k rows phase A visits (rows >= k are zero)

    for (int e = tid; e < kpad * kWRows; e += P::kBlock) {
        const int kk = e / kWRows, lr = e % kWRows;
        const int w = w0 + lr / 32;
        const float v =
            (kk < k && w < Mw) ? W[(size_t)kk * Mp + word_row_bit(w, lr % 32, bm, bmw)] : 0.f;
        Ws[((kk >> 2) * kWRows + lr) * 4 + (kk & 3)] = mxu_operand<E::kRound>(v);
    }

    // A 16-byte shared load is served a quarter-warp (8 lanes) at a time,
    // and costs about a cycle for every 128 distinct bytes the quarters ask
    // for together, with no merging across quarters: so each quarter-warp
    // here reads at most 4 distinct chunks per load, and no two of them in
    // one bank.  Lane l of a warp takes the pair (l & 3) + 4 ((l >> 3) & 1)
    // (8 values, 4 in a quarter) and ((l >> 2) & 1) + 2 (l >> 4) (4 values,
    // 2 in a quarter).
    // Phase B: group grp (0: H.P^T, 1: the second product), k rows
    // kg + 16 i, data rows rg + 8 j.  Row rg + 8 j has the swizzle key rg,
    // k row kg + 16 i the key kg & 7.
    const int ct = P::kSplit ? tid - 2 * P::kProducers : tid;  // phase B thread
    const int grp = ct >> 7, lt = ct & 127;
    const int rg = (lt & 3) + 4 * ((lt >> 3) & 1);
    const int kg = ((lt >> 2) & 1) + 2 * ((lt >> 4) & 1) + 4 * (lt >> 5);

    // Issue producer thread pt's cp.async copies of tile `tile` into Hs and
    // the operand tiles Ys (either may be null: not copied); zero beyond k,
    // Np and the word rows.
    auto stage = [&](int tile, float* Hs, float* Ys, int pt) {
        const int c0 = tile * kWCols;
        for (int e = pt; Hs != nullptr && e < kpad * kQ; e += P::kProducers) {
            const int kk = e / kQ, ch = e % kQ, col = c0 + 4 * ch;
            const bool ok = kk < k && col < Np;
            cp_async16(Hs + kk * kWCols + 4 * (ch ^ (kk & 7)),
                       ok ? H + (size_t)kk * Np + col : H, ok);
        }
        if constexpr (P::kReads) {
            constexpr int kRowsY = kDense ? kWRows : 2;
            for (int e = pt; Ys != nullptr && e < kRowsY * kQ * P::kOperands; e += P::kProducers) {
                const int op = e / (kRowsY * kQ), rem = e % (kRowsY * kQ);
                const int r = rem / kQ, ch = rem % kQ, col = c0 + 4 * ch;
                const int w = kDense ? w0 + r / 32 : w0 + r;
                const bool ok = w < Mw && col < Np;
                const Y* src = op ? y2 : y;
                const size_t row = kDense ? (size_t)word_row_bit(w, r % 32, bm, bmw) : (size_t)w;
                cp_async16(Ys + op * P::kYs + r * kWCols + 4 * ch,
                           ok ? src + row * Np + col : src, ok);
            }
        }
    };

    // The tile's 1 - h into Hc; with rounding, h and round(1 - h) rounded in
    // place first (the caller then waits for every producer before phase A).
    auto prepare = [&](float* Hs, float* Hc, int pt) {
        if constexpr (E::kRound != Round::kNone && P::kHc) {
            for (int e = pt; e < P::kHs / 4; e += P::kProducers) {
                float4 v = reinterpret_cast<const float4*>(Hs)[e];
                float h[4] = {v.x, v.y, v.z, v.w}, c[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float r = mxu_operand<E::kRound>(h[i]);
                    c[i] = mxu_operand<E::kRound>(1.f - h[i]);
                    h[i] = r;
                }
                reinterpret_cast<float4*>(Hs)[e] = f4(h);
                reinterpret_cast<float4*>(Hc)[e] = f4(c);
            }
        } else if constexpr (E::kRound != Round::kNone) {
            for (int e = pt; e < P::kHs; e += P::kProducers) Hs[e] = mxu_operand<E::kRound>(Hs[e]);
        } else if constexpr (P::kHc) {
            for (int e = pt; e < P::kHs / 4; e += P::kProducers) {
                float4 v = reinterpret_cast<const float4*>(Hs)[e];
                v.x = 1.f - v.x;
                v.y = 1.f - v.y;
                v.z = 1.f - v.z;
                v.w = 1.f - v.w;
                reinterpret_cast<float4*>(Hc)[e] = v;
            }
        }
    };

    // ---- phase A: the WH tile, then p and q into Ps/Qs; producer thread pt
    // takes columns 4 cq .. 4 cq + 3 and rows rw + kRG j (j < kRA)
    auto produce = [&](int tile, const float* Hs, float* Ps, float* Qs, const float* Ys, int pt) {
        const int cq = (pt & 3) + 4 * ((pt >> 3) & 1);
        const int rw = ((pt >> 2) & 1) + 2 * ((pt >> 4) & 1) + 4 * (pt >> 5);
        float wh[kRA][4];
#pragma unroll
        for (int j = 0; j < kRA; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) wh[j][c] = 0.f;
        // Unrolled over 16 k rows a step, so every load is a register plus
        // an immediate: the 8 swizzled column chunks of this thread, per row
        // key.
        const float4* Ws4 = reinterpret_cast<const float4*>(Ws);
#pragma unroll 2
        for (int k8 = 0; k8 < kw; k8 += 8) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int kq = (k8 >> 2) + half;
                float4 wa[kRA];
#pragma unroll
                for (int j = 0; j < kRA; ++j) wa[j] = Ws4[kq * kWRows + rw + kRG * j];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int key = 4 * half + jj;  // (k8 + key) & 7
                    const float4 h =
                        reinterpret_cast<const float4*>(Hs + (k8 + key) * kWCols)[cq ^ key];
#pragma unroll
                    for (int j = 0; j < kRA; ++j)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            wh[j][c] = fmaf(lane(wa[j], jj), lane(h, c), wh[j][c]);
                }
            }
        }

        const int c0 = tile * kWCols + 4 * cq;
#pragma unroll
        for (int j = 0; j < kRA; ++j) {
            const int lr = rw + kRG * j;
            const int wr = lr >> 5, b32 = lr & 31;  // word row of the block, bit
            float ym[4] = {0.f, 0.f, 0.f, 0.f}, ym2[4] = {0.f, 0.f, 0.f, 0.f};
            uint32_t word[4] = {0u, 0u, 0u, 0u}, word2[4] = {0u, 0u, 0u, 0u};
            if constexpr (P::kReads && kDense) {
                const float4 v = reinterpret_cast<const float4*>(Ys + lr * kWCols)[cq];
                ym[0] = v.x, ym[1] = v.y, ym[2] = v.z, ym[3] = v.w;
                if constexpr (SECOND) {
                    const float4 v2 =
                        reinterpret_cast<const float4*>(Ys + P::kYs + lr * kWCols)[cq];
                    ym2[0] = v2.x, ym2[1] = v2.y, ym2[2] = v2.z, ym2[3] = v2.w;
                }
            } else if constexpr (P::kReads) {
                const int4 v = reinterpret_cast<const int4*>(Ys + wr * kWCols)[cq];
                word[0] = v.x, word[1] = v.y, word[2] = v.z, word[3] = v.w;
                if constexpr (SECOND) {
                    const int4 v2 = reinterpret_cast<const int4*>(Ys + P::kYs + wr * kWCols)[cq];
                    word2[0] = v2.x, word2[1] = v2.y, word2[2] = v2.z, word2[3] = v2.w;
                }
            }
            float pv[4], qv[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int col = c0 + c;
                const bool col_in = col < Np;
                const float v = wh[j][c];
                if constexpr (E::kWForm == 2) {
                    pv[c] = col_in ? mxu_operand<E::kRound>(v) : 0.f;
                    qv[c] = col_in ? mxu_operand<E::kRound>(v + 1.f) : 0.f;
                    continue;
                }
                const float a = v + eps;
                const float b = (E::kClampB ? fmaxf(1.f - v, 0.f) : 1.f - v) + eps;
                const float rr = 1.f / (a * b);
                if constexpr (kDense) {
                    const float cm = SECOND ? ym2[c] : (col < n_real ? 1.f - ym[c] : 0.f);
                    pv[c] = col_in ? mxu_operand<E::kRound>(ym[c] * (b * rr)) : 0.f;
                    qv[c] = col_in ? mxu_operand<E::kRound>(cm * (a * rr)) : 0.f;
                } else {
                    const bool bit = (word[c] >> b32) & 1u;
                    const bool bit2 = SECOND ? ((word2[c] >> b32) & 1u) : (!bit && col < n_real);
                    float p, q;
                    if constexpr (E::kSelect) {
                        p = (col_in && bit) ? b * rr : 0.f;
                        q = (col_in && bit2) ? a * rr : 0.f;
                    } else {
                        // ym unpacked to a float (tools/bench_packed.py): products
                        static_assert(!SECOND, "the product form takes one operand");
                        const float ymf = (float)bit;
                        p = col_in ? ymf * (b * rr) : 0.f;
                        q = col_in ? (col < n_real ? 1.f - ymf : 0.f) * (a * rr) : 0.f;
                    }
                    if constexpr (E::kWForm == 1) {
                        // P - Q, where(bit, b r, -q) in the select form; both
                        // forms give the same bits.  Q itself stays fp32.
                        pv[c] = mxu_operand<E::kRound>(E::kSelect ? (bit ? p : -q) : p - q);
                        qv[c] = q;
                    } else {
                        pv[c] = mxu_operand<E::kRound>(p);
                        qv[c] = mxu_operand<E::kRound>(q);
                    }
                }
            }
            const int chunk = lr * kQ + (cq ^ (lr & 7));
            reinterpret_cast<float4*>(Ps)[chunk] = f4(pv);
            reinterpret_cast<float4*>(Qs)[chunk] = f4(qv);
        }
    };

    float acc[TK][8], qsum[8];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) qsum[j] = 0.f;

    // ---- phase B: each group's product over the tile's 32 columns, 4 at a
    // time.  With `all` (every k row a thread holds is below k) a thread
    // holds its TK float4 of h (or 1 - h) and streams its 8 of p (or q) one
    // data row at a time, with no branch, so each load waits behind the FMAs
    // of the row before.  Else it holds its 8 of p and loads h row by row,
    // skipping the rows from k on.  Timed on the H100 (wpass_tune's hold_h
    // and row_by_row): where a thread holds a dead k row, row by row is 5-17%
    // faster in the warp-specialised block, about even at TK = 4, faster at
    // TK = 16 with 6 or more dead rows and 4-10% slower with 3 or fewer.
    auto consume_rows = [&](auto all, const float* Hs, const float* Hc, const float* Ps,
                            const float* Qs) {
        if (!P::kTwo && grp == 1) return;
        const float4* P4 = reinterpret_cast<const float4*>(grp == 0 ? Ps : Qs);
        const float4* H4 = reinterpret_cast<const float4*>(grp == 1 && P::kHc ? Hc : Hs);
        const float4* Q4 = reinterpret_cast<const float4*>(Qs);
        auto row_sums = [&](int c4, int j) {
            const int chunk = (rg + 8 * j) * kQ + (c4 ^ rg);
            if constexpr (E::kWForm == 1) {
                const float4 q = Q4[chunk];
                qsum[j] = (((qsum[j] + q.x) + q.y) + q.z) + q.w;
            }
            return P4[chunk];
        };
#pragma unroll
        for (int c4 = 0; c4 < kQ; ++c4) {
            if constexpr (decltype(all)::value) {
                float4 h[TK];
#pragma unroll
                for (int i = 0; i < TK; ++i) h[i] = H4[(kg + 16 * i) * kQ + (c4 ^ (kg & 7))];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float4 p = row_sums(c4, j);
#pragma unroll
                    for (int i = 0; i < TK; ++i)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            acc[i][j] = fmaf(lane(h[i], c), lane(p, c), acc[i][j]);
                }
            } else {
                float4 p[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) p[j] = row_sums(c4, j);
#pragma unroll
                for (int i = 0; i < TK; ++i) {
                    if (i > 0 && 16 * i >= k) break;  // uniform: every row kg + 16 i >= k
                    const float4 h = H4[(kg + 16 * i) * kQ + (c4 ^ (kg & 7))];
#pragma unroll
                    for (int c = 0; c < 4; ++c)
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            acc[i][j] = fmaf(lane(h, c), lane(p[j], c), acc[i][j]);
                }
            }
        }
    };
    const bool all_rows = 16 * (TK - 1) < k;
    auto consume = [&](const float* Hs, const float* Hc, const float* Ps, const float* Qs) {
        if (all_rows) {
            consume_rows(std::true_type{}, Hs, Hc, Ps, Qs);
        } else {
            consume_rows(std::false_type{}, Hs, Hc, Ps, Qs);
        }
    };

    if constexpr (P::kSplit) {
        // Producer group g (threads 128 g .. 128 g + 127) takes the tiles v
        // (from t_begin) with v % 2 == g and the consumers take every tile in
        // order: tile v reads H stage v % 4, stage v % 3 of Hc and Ps/Qs and
        // operand stage g.  Group g starts tile v once the consumers are done
        // with tile v - 2 (barrier kWEmpty + g), copies tile v + 2's H then,
        // its operand tiles after phase A of tile v, and reports tile v
        // filled on kWFull + v % 3.
        constexpr int kMeet = P::kProducers + 256;  // a producer group and the consumers
        __syncthreads();  // Ws
        if (tid < 2 * P::kProducers) {
            const int g = tid / P::kProducers, pt = tid % P::kProducers;
            const int n = t_end - t_begin;
            float* Ys = Yring + g * kYStage;
            if (g < n) stage(t_begin + g, Hring + g * P::kHs, Ys, pt);
            cp_async_commit();
            for (int v = g; v < n; v += 2) {
                const int t = t_begin + v;
                if (v >= 2) named_sync(kWEmpty + g, kMeet);
                cp_async_wait_all();
                named_sync(kWProducers + g, P::kProducers);  // tile v has landed
                if (v + 2 < n) stage(t + 2, Hring + (v + 2) % 4 * P::kHs, nullptr, pt);
                cp_async_commit();
                float* Hs = Hring + v % 4 * P::kHs;
                float* Hc = Hcs + v % 3 * P::kHs;
                float* Ps = PQs + v % 3 * kPQStage;
                prepare(Hs, Hc, pt);
                if constexpr (E::kRound != Round::kNone) named_sync(kWProducers + g, P::kProducers);
                produce(t, Hs, Ps, Ps + P::kPQ, Ys, pt);
                named_arrive(kWFull + v % 3, kMeet);
                if (v + 2 < n) {
                    named_sync(kWProducers + g, P::kProducers);  // the operand tile is consumed
                    stage(t + 2, nullptr, Ys, pt);
                }
                cp_async_commit();
            }
            return;
        }
        for (int t = t_begin; t < t_end; ++t) {
            const int v = t - t_begin;
            named_sync(kWFull + v % 3, kMeet);
            const float* Ps = PQs + v % 3 * kPQStage;
            consume(Hring + v % 4 * P::kHs, Hcs + v % 3 * P::kHs, Ps, Ps + P::kPQ);
            if (v + 2 < t_end - t_begin) named_arrive(kWEmpty + (v & 1), kMeet);
        }
    } else {
        // One group, the phases in turn: H double-buffered, the next tile's
        // copies in flight during phase B.
        if (t_begin < t_end) stage(t_begin, Hring, Yring, tid);
        cp_async_commit();
        for (int t = t_begin; t < t_end; ++t) {
            float* Hs = Hring + ((t - t_begin) & 1) * P::kHs;
            cp_async_wait_all();
            __syncthreads();  // tile t has landed; the previous phase B is done
            prepare(Hs, Hcs, tid);
            if constexpr (E::kRound != Round::kNone) __syncthreads();
            produce(t, Hs, PQs, PQs + P::kPQ, Yring, tid);
            __syncthreads();  // Ps, Qs, Hc written; the operand tile is consumed
            if (t + 1 < t_end) stage(t + 1, Hring + ((t + 1 - t_begin) & 1) * P::kHs, Yring, tid);
            cp_async_commit();
            consume(Hs, Hcs, PQs, PQs + P::kPQ);
        }
    }

    // The consumers' epilogue: T = tp + tq, the second group's sums through
    // Ws (last read by phase A of the last tile, which every consumer has
    // waited for).
    float* out = dst + (z * gridDim.y + blockIdx.y) * (E::kWForm == 2 ? 2 : 1) * k * Mp;
    if constexpr (E::kWForm == 0) {
        if (grp == 1) {
#pragma unroll
            for (int i = 0; i < TK; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) Ws[(i * 8 + j) * 128 + lt] = acc[i][j];
        }
        if constexpr (P::kSplit) {
            named_sync(kWConsumers, 256);
        } else {
            __syncthreads();
        }
        if (grp == 1) return;
    } else if constexpr (E::kWForm == 1) {
        if (grp == 1) return;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int lr = rg + 8 * j;
        const int w = w0 + lr / 32;
        if (w >= Mw) continue;
        const int row = word_row_bit(w, lr % 32, bm, bmw);
#pragma unroll
        for (int i = 0; i < TK; ++i) {
            const int kk = kg + 16 * i;
            if (kk >= k) continue;
            if constexpr (E::kWForm == 0) {
                out[(size_t)kk * Mp + row] = acc[i][j] + Ws[(i * 8 + j) * 128 + lt];
            } else if constexpr (E::kWForm == 1) {
                out[(size_t)kk * Mp + row] = acc[i][j] + qsum[j];
            } else {
                out[(size_t)(grp * k + kk) * Mp + row] = acc[i][j];
            }
        }
    }
}

// out[e] = sum over s of part[s][e], s in order (the W pass's column split),
// for lane blockIdx.y of (R, nsplit, count) partials and (R, count) outputs.
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int nsplit, size_t count) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= count) return;
    part += (size_t)blockIdx.y * nsplit * count;
    out += (size_t)blockIdx.y * count;
    float acc = part[e];
    for (int s = 1; s < nsplit; ++s) acc += part[(size_t)s * count + e];
    out[e] = acc;
}

// ------------------------------------------------------------ launchers
constexpr int kMaxLanes = 65535;  // gridDim.z (and gridDim.y) can be no larger

bool geometry_ok(int k, int Mp, int Np, int bm, int lanes) {
    return k >= 1 && k <= 256 && Np >= 1 && bm >= 32 && bm % 32 == 0 && Mp >= bm &&
           Mp % bm == 0 && lanes >= 1 && lanes <= kMaxLanes;
}

template <bool SECOND, typename Y, class E>
struct WpassLauncher {
    // One W-pass launch, grid ceil(Mw/2) x nsplit x lanes, into dst (T, or
    // the (lanes, nsplit, n_out k, Mp) partials).
    template <int TK>
    static cudaError_t launch(const float* W, const float* H, const Y* y, const Y* y2, float* dst,
                              int k, int Mp, int Np, int bm, int n_real, int nsplit, int lanes,
                              float eps, cudaStream_t stream) {
        using P = WPass<TK, SECOND, Y, E>;
        auto kernel = wpass_kernel<TK, SECOND, Y, E>;
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)P::kSmem);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        const dim3 grid((Mp / 32 + 1) / 2, nsplit, lanes);
        kernel<<<grid, P::kBlock, P::kSmem, stream>>>(W, H, y, y2, dst, k, Mp, Np, bm, n_real, eps);
        return cudaGetLastError();
    }
};

// Both passes keep TK = kpad / 16 k rows per thread: kpad = 16 TK >= k.
template <class L, class... A>
cudaError_t dispatch_tk(int k, A... args) {
    if (k <= 16) return L::template launch<1>(args...);
    if (k <= 32) return L::template launch<2>(args...);
    if (k <= 64) return L::template launch<4>(args...);
    if (k <= 128) return L::template launch<8>(args...);
    return L::template launch<16>(args...);
}

// ------------------------------------------------------------ H pass
// Num = W.P, Den = W.Q (k, Np) and ll, redesigned for the H100 (see the note
// at the head of this file for what it replaces and its bound).
//
// W is read from its bit-plane copy Wp (k, Mp): column 32 w + b of Wp is
// data row word_row_bit(w, b) of W, so word row w's 32 data rows are 128
// contiguous bytes of every k row, whatever the stripe bm.
//
// Grid (ceil(Np/64), S, R): lane z = blockIdx.z reads Wp[z], H[z] and writes
// its own partials.  Block (x, s) of a lane owns the kHCols = 64 columns
// [64 x, 64 x + 64) and chunk s of S, a run of whole word rows (the first
// Mw % S chunks take one word row more).  It walks its word rows in order,
// one step of 32 data rows each, and writes its (k, 64) partials of Num and
// Den once, into Num/Den themselves when S = 1 or into scratch (S, k, Np);
// sum_splits_kernel then adds the S partials in order s = 0, 1, ..., and
// sum_ll_kernel the per-block ll partials in block order: no float atomics,
// and a launch on the same inputs gives bitwise the same outputs.
//
// Per step, two phases between barriers:
//   A  the 32 x 64 tile of WH (each thread 4 data rows x 2 columns, W and H
//      read as 16-byte shared loads, contraction over k in ascending
//      order), then p and q written to Ps/Qs (column-major, 4 rows per
//      16-byte store) and the thread's ll terms added to its fp64 sum;
//   B  the (k x 64) accumulation over the step's 32 rows: each thread owns
//      k rows kg + 16 i (i < TK) and columns cg + 16 c (c < 4) as two
//      register sums, Num and Den.  Per 4 rows it loads 4 float4 of p, 4 of
//      q and one float4 of W per k row, which feeds both sums: 256 FMAs for
//      16 shared loads at TK = 8.
// The next step's W slice and operand tile arrive by cp.async while phase
// B runs: the W slice is double-buffered, the operand tile is consumed in
// phase A.  H's (k x 64) tile is loaded once per block.  Shared tiles whose
// rows are read at one chunk by many threads swizzle their 16-byte chunks
// (chunk c of row r stored at c ^ (r & 7); the dense operand tile by
// (r >> 2) & 7), so those reads are free of bank conflicts.
constexpr int kHCols = 64;  // columns per block
constexpr int kHRows = 32;  // data rows per step: one word row

// Shapes of one H-pass instance: TK k rows per thread (kpad = 16 TK >= k).
template <int TK, bool SECOND, typename Y, bool TERMS, class E>
struct HPass {
    static constexpr bool kDense = dense_operand<Y>();
    // Identity forms 1 and 3 read no data operand.
    static constexpr bool kReads = E::kIdentity == 0 || E::kIdentity == 2;
    static constexpr int kpad = 16 * TK;
    static constexpr int kOperands = kReads ? (SECOND ? 2 : 1) : 0;
    static constexpr bool kTerms = TERMS;
    // Shared memory in floats: Hs [kpad/4][64][4]; Ws two stages of
    // [kpad][32]; Ps, Qs [64][32] (TERMS only); operand tiles, dense
    // [32][64] or words [64], each.
    static constexpr int kHs = kpad * kHCols;
    static constexpr int kWs = kpad * kHRows;
    static constexpr int kPQ = TERMS ? kHCols * kHRows : 0;
    static constexpr int kYs = kDense ? kHRows * kHCols : kHCols;
    // Warp-specialised at TK = 16 in the production pass (hpass_split):
    // kProducers threads of producers (phase A) and two warpgroups of
    // consumers (phase B), one block an SM; else 256 threads take the
    // phases in turn.
    static constexpr bool kSplit = TK == 16 && TERMS && std::is_same<E, Sweep>::value;
    static constexpr int kProducers = 128;
    static constexpr int kBlock = kSplit ? kProducers + 256 : kThreads;
    // Registers a thread of each role (setmaxnreg): the consumers' 128
    // accumulators take what the producers give up of the 64K an SM has.
    static constexpr int kProducerRegs = 120, kConsumerRegs = 192;
    static_assert(kProducers * kProducerRegs + 256 * kConsumerRegs <=
                      kBlock * (65536 / kBlock / 8 * 8),
                  "the roles take more registers than the block is launched with");
    static_assert(kProducerRegs % 8 == 0 && kConsumerRegs % 8 == 0 && kProducerRegs >= 24 &&
                      kConsumerRegs <= 256,
                  "setmaxnreg takes a multiple of 8 from 24 to 256");
    // Stages: of the W slice, the consumers' word row, the producers' and
    // the one a copy fills; of Ps/Qs, the consumers' and the producers'; of
    // the operand tiles, the producers' and the one a copy fills.
    static constexpr int kWStages = kSplit ? 3 : 2;
    static constexpr int kPQStages = kSplit ? 2 : 1;
    static constexpr int kYStages = kSplit ? 2 : 1;
    static constexpr size_t kSmem =
        sizeof(float) * (size_t)(kHs + kWStages * kWs + kPQStages * 2 * kPQ +
                                 kYStages * kOperands * kYs);
    // Two blocks per SM (<= 128 registers a thread) while the accumulators
    // leave room; one at TK = 16.
    static constexpr int kMinBlocks = TK <= 8 ? 2 : 1;
};

enum HBarrier : int { kHFull = 1, kHEmpty = 3, kHProducers = 5 };

// Wp[kk][32 w + b] = W[kk][data row of bit b of word row w], rounded to bf16
// where the policy asks: the H pass's W in bit-plane order, one copy per lane
// (blockIdx.y) of W (R, k, Mp).
template <bool BF16>
__global__ void bitplane_w_kernel(const float* __restrict__ W, float* __restrict__ Wp, int k,
                                  int Mp, int bm) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (size_t)k * Mp) return;
    const size_t lane0 = (size_t)blockIdx.y * k * Mp;
    const int kk = (int)(e / Mp), c = (int)(e % Mp);
    Wp[lane0 + e] = mxu_operand<BF16 ? Round::kBf16 : Round::kNone>(
        W[lane0 + (size_t)kk * Mp + word_row_bit(c >> 5, c & 31, bm, bm / 32)]);
}

// The steps both H-pass bodies (the turn-taking body of hpass_kernel and
// hpass_split) take alike: Num and Den of the two are bitwise equal because
// they run this one copy of every per-entry term and every sum.

// H's (k x 64) tile of the block into Hs [kpad/4][64][4], by threads t,
// t + NT, ...; zero beyond k and Np.
template <class P, class E, int NT>
__device__ __forceinline__ void hpass_load_h(float* Hs, const float* H, int t, int k, int Np,
                                             int c0) {
    for (int e = t; e < P::kpad * kHCols; e += NT) {
        const int kk = e / kHCols, c = e % kHCols;
        const float v = (kk < k && c0 + c < Np) ? H[(size_t)kk * Np + c0 + c] : 0.f;
        Hs[((kk >> 2) * kHCols + c) * 4 + (kk & 3)] = mxu_operand<E::kRound>(v);
    }
}

// The cp.async copies of word row w's W slice into Ws and of its operand
// tiles into Ys (y's tile, then y2's), by threads t, t + NT, ...; zero
// beyond k and Np; one commit group.
template <class P, int NT, typename Y>
__device__ __forceinline__ void hpass_stage(float* Ws, float* Ys, const float* Wp, const Y* y,
                                            const Y* y2, int w, int t, int k, int Mp, int Np,
                                            int bm, int bmw, int c0) {
    for (int e = t; e < P::kpad * 8; e += NT) {
        const int kk = e >> 3, ch = e & 7;
        const bool ok = kk < k;
        cp_async16(Ws + kk * kHRows + 4 * (ch ^ (kk & 7)),
                   ok ? Wp + (size_t)kk * Mp + kHRows * w + 4 * ch : Wp, ok);
    }
    if constexpr (P::kReads) {
        constexpr int kRowsY = P::kDense ? kHRows : 1;
        const int row0 = word_row_bit(w, 0, bm, bmw);
        for (int e = t; e < kRowsY * 16 * P::kOperands; e += NT) {
            const int op = e / (kRowsY * 16), rem = e % (kRowsY * 16);
            const int b = rem >> 4, ch = rem & 15, col = c0 + 4 * ch;
            const bool ok = col < Np;
            const Y* src = op ? y2 : y;
            const size_t row = P::kDense ? (size_t)(row0 + b * bmw) : (size_t)w;
            const int dst = P::kDense ? b * kHCols + 4 * (ch ^ ((b >> 2) & 7)) : 4 * ch;
            cp_async16(Ys + op * P::kYs + dst, ok ? src + row * Np + col : src, ok);
        }
    }
    cp_async_commit();
}

// Phase A past the WH tile, for the data rows 4 rq .. 4 rq + 3 (bits of the
// word row whose bit 0 is data row row0) of the block's column cl (col in
// the matrix), wh their four WH values: read the operands from Ys, form p
// and q by policy E, add the ll terms of the entries inside the real region
// to ll, and store p and q to Ps/Qs (TERMS).
template <class P, class E, bool SECOND, bool LOSS>
__device__ __forceinline__ void hpass_column(const float wh[4], const float* Ys, float* Ps,
                                             float* Qs, int rq, int cl, int col, int row0,
                                             int bmw, int stripe, int Mp, int bm, int m_real,
                                             int n_real, float eps, double& ll) {
    constexpr bool kDense = P::kDense;
    float ym[4] = {0.f, 0.f, 0.f, 0.f}, yc[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t word = 0u, word2 = 0u;
    if constexpr (P::kReads && kDense) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int at = (4 * rq + r) * kHCols + 4 * ((cl >> 2) ^ rq) + (cl & 3);
            ym[r] = Ys[at];
            if constexpr (SECOND) yc[r] = Ys[P::kYs + at];
        }
    } else if constexpr (P::kReads) {
        word = reinterpret_cast<const uint32_t*>(Ys)[cl];
        if constexpr (SECOND) word2 = reinterpret_cast<const uint32_t*>(Ys + P::kYs)[cl];
    }
    float pv[4], qv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int b = 4 * rq + r;  // bit of the word row, local data row
        const float v = wh[r];
        float p, q;
        if constexpr (E::kIdentity == 1) {
            p = v;
            q = v + 1.f;
        } else if constexpr (E::kIdentity == 2) {
            p = v + ym[r];
            q = v - ym[r];
        } else if constexpr (E::kIdentity == 3) {
            // o2 sums o1 after each stripe: weight stripe j's rounded
            // WH by S - j, exactly (8 significant bits times S < 2^16).
            p = mxu_operand<E::kRound>(v);
            q = (float)(Mp / bm - stripe) * p;
        } else {
            const float a = v + eps;
            const float bb = (E::kClampB ? fmaxf(1.f - v, 0.f) : 1.f - v) + eps;
            const float rr = 1.f / (a * bb);
            const bool in_region = row0 + b * bmw < m_real && col < n_real;
            if constexpr (kDense) {
                const float c = SECOND ? yc[r] : 1.f - ym[r];
                p = ym[r] * (bb * rr);
                q = c * (a * rr);
                // Explicit fmaf: one rounding, the same in every instance.
                if (LOSS && in_region) ll += (double)fmaf(ym[r], logf(a), c * logf(bb));
            } else if constexpr (E::kSelect) {
                const bool bit = (word >> b) & 1u;
                p = bit ? bb * rr : 0.f;
                float sel;
                if (SECOND) {
                    const bool bit2 = (word2 >> b) & 1u;
                    q = bit2 ? a * rr : 0.f;
                    sel = bit ? a : (bit2 ? bb : 1.f);
                } else {
                    q = bit ? 0.f : a * rr;
                    sel = bit ? a : bb;
                }
                if (LOSS && in_region) ll += (double)logf(sel);
            } else {
                // ym unpacked to a float; the products and both logs
                // give the select form's values bitwise (1*x = x,
                // 0*x + y = y).
                static_assert(!SECOND, "the product form takes one operand");
                const float ymf = (float)((word >> b) & 1u);
                const float c = 1.f - ymf;
                p = ymf * (bb * rr);
                q = c * (a * rr);
                if (LOSS && in_region) ll += (double)fmaf(ymf, logf(a), c * logf(bb));
            }
        }
        pv[r] = mxu_operand<E::kRound>(p);
        qv[r] = mxu_operand<E::kIdentity == 3 ? Round::kNone : E::kRound>(q);
    }
    if constexpr (P::kTerms) {
        const int chunk = cl * (kHRows / 4) + (rq ^ (cl & 7));
        reinterpret_cast<float4*>(Ps)[chunk] = f4(pv);
        reinterpret_cast<float4*>(Qs)[chunk] = f4(qv);
    }
}

// Phase B of one word row: Num += W.P and Den += W.Q over its 32 data rows
// in ascending order, for the thread's k rows kg + 16 i (i < TK; rows from k
// on are skipped) and columns cg + 16 c (c < 4); swp, swk are the swizzle
// keys of those rows.  AHEAD loads k row kg + 16 (i + 1) of W before the
// FMAs of row kg + 16 i (hpass_split: a load behind the exit test waits for
// its data at every row); the FMAs and their order are the same either way.
template <int TK, bool AHEAD>
__device__ __forceinline__ void hpass_accumulate(const float* Ps, const float* Qs,
                                                 const float* Ws, int cg, int kg, int swp,
                                                 int swk, int k, float num[TK][4],
                                                 float den[TK][4]) {
    const float4* P4 = reinterpret_cast<const float4*>(Ps);
    const float4* Q4 = reinterpret_cast<const float4*>(Qs);
    const float4* W4 = reinterpret_cast<const float4*>(Ws);
#pragma unroll
    for (int r4 = 0; r4 < kHRows / 4; ++r4) {
        float4 p[4], q[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int chunk = (cg + 16 * c) * (kHRows / 4) + (r4 ^ swp);
            p[c] = P4[chunk];
            q[c] = Q4[chunk];
        }
        const auto row = [&](int i, const float4& wv) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    num[i][c] = fmaf(lane(wv, r), lane(p[c], r), num[i][c]);
                    den[i][c] = fmaf(lane(wv, r), lane(q[c], r), den[i][c]);
                }
        };
        if constexpr (AHEAD) {
            float4 wv = W4[kg * (kHRows / 4) + (r4 ^ swk)];
#pragma unroll
            for (int i = 0; i < TK; ++i) {
                float4 next;
                if (i + 1 < TK) next = W4[(kg + 16 * (i + 1)) * (kHRows / 4) + (r4 ^ swk)];
                if (i == 0 || 16 * i < k) row(i, wv);  // uniform: skips the rows kg + 16 i >= k
                wv = next;
            }
        } else {
#pragma unroll
            for (int i = 0; i < TK; ++i) {
                if (i > 0 && 16 * i >= k) break;  // uniform: every row kg + 16 i >= k
                row(i, W4[(kg + 16 * i) * (kHRows / 4) + (r4 ^ swk)]);
            }
        }
    }
}

// The thread's Num/Den sums to the block's (k, 64) partials at base.
template <int TK>
__device__ __forceinline__ void hpass_write(const float num[TK][4], const float den[TK][4],
                                            float* num_out, float* den_out, size_t base, int c0,
                                            int cg, int kg, int k, int Np) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int col = c0 + cg + 16 * c;
        if (col >= Np) continue;
#pragma unroll
        for (int i = 0; i < TK; ++i) {
            const int kk = kg + 16 * i;
            if (kk >= k) continue;
            num_out[base + (size_t)kk * Np + col] = num[i][c];
            den_out[base + (size_t)kk * Np + col] = den[i][c];
        }
    }
}

// The block's ll from the ll of its NT threads t = 0 .. NT - 1 that hold
// one, in a fixed order: a warp tree, then thread 0 over the warps (after
// sync(), which orders ll_warp among those threads), into ll_part.
template <int NT, class Sync>
__device__ __forceinline__ void hpass_ll_sum(double ll, double* ll_warp, int t, Sync sync,
                                             double* ll_part, size_t z) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ll += __shfl_down_sync(0xffffffffu, ll, off);
    if ((t & 31) == 0) ll_warp[t >> 5] = ll;
    sync();
    if (t == 0) {
        double acc = 0.0;
        for (int i = 0; i < NT / 32; ++i) acc += ll_warp[i];
        ll_part[(z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = acc;
    }
}

// The production H pass at TK = 16 (HPass::kSplit), warp-specialised: the
// block's first warpgroup (the producers) runs phase A of word row v while
// the other two (the consumers) run phase B of word row v - 1.  They meet on
// named barriers: the producers report row v's Ps/Qs written on
// kHFull + v % 2, the consumers report row v done on kHEmpty + v % 2, which
// the producers wait for before they overwrite its stages at row v + 2.
// Row v reads W stage v % 3 (in both phases: a slice lives until its
// consumers are done), Ps/Qs stage v % 2 and operand stage v % 2; the
// producers copy row v + 1's W slice and operand tiles by cp.async during
// phase A of row v.
//   A  the 32 x 64 WH tile, a producer 4 data rows x 4 columns (4 loads of W
//      and 4 of H per 4 k rows for 64 FMAs; a quarter-warp reads 2 chunks of
//      W and 4 of H a load), contraction over k in ascending order as in the
//      turn-taking body; then hpass_column for each of its 4 columns;
//   B  hpass_accumulate in consumer thread ct = tid - 128, each k row of W
//      loaded one k row ahead.
// The stage copies, every p and q and every Num/Den sum are the shared
// steps above, so Num and Den are bitwise the turn-taking body's; ll adds
// the same terms in another order.
template <int TK, bool SECOND, typename Y, bool LOSS>
__device__ __forceinline__ void hpass_split(float* smem, const float* __restrict__ Wp,
                                            const float* __restrict__ H,
                                            const Y* __restrict__ y, const Y* __restrict__ y2,
                                            float* __restrict__ num_out,
                                            float* __restrict__ den_out,
                                            double* __restrict__ ll_part, int k, int Mp, int Np,
                                            int bm, int m_real, int n_real, float eps) {
    using P = HPass<TK, SECOND, Y, true, Sweep>;
    constexpr int kMeet = P::kBlock, kYStage = P::kOperands * P::kYs;
    float* Hs = smem;
    float* Wring = Hs + P::kHs;
    float* PQring = Wring + P::kWStages * P::kWs;
    float* Yring = PQring + P::kPQStages * 2 * P::kPQ;  // y's tile, then y2's, a stage
    __shared__ double ll_warp[P::kProducers / 32];

    const int tid = threadIdx.x;
    const int bmw = bm / 32, Mw = Mp / 32;
    const size_t z = blockIdx.z;  // the lane: its W, H, partials and ll
    Wp += z * k * Mp;
    H += z * k * Np;
    const int c0 = blockIdx.x * kHCols;
    const int S = gridDim.y, s = blockIdx.y;
    const int w_begin = s * (Mw / S) + min(s, Mw % S);
    const int n = Mw / S + (s < Mw % S ? 1 : 0);  // word rows of the chunk
    const int kw = (k + 7) & ~7;  // k rows phase A visits (rows >= k are zero)

    hpass_load_h<P, Sweep, P::kBlock>(Hs, H, tid, k, Np, c0);
    __syncthreads();

    if (tid < P::kProducers) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::kProducerRegs));
        const int pt = tid, l = tid & 31;
        // Data rows 4 rq .. 4 rq + 3, columns cw + kCG j (j < kPC): a warp
        // takes two row quads and every column group, a quarter-warp two
        // row quads and four consecutive column groups.
        constexpr int kPC = kHCols * kHRows / 4 / P::kProducers;  // columns a producer
        constexpr int kCG = kHCols / kPC;                         // column groups
        static_assert(P::kProducers == 4 * 32 && kCG == 16, "four producer warps");
        const int rq = ((l >> 2) & 1) | ((pt >> 5) << 1);
        const int cw = (l & 3) | (((l >> 3) & 3) << 2);
        const auto stage = [&](int v) {
            hpass_stage<P, P::kProducers>(Wring + v % P::kWStages * P::kWs,
                                          Yring + v % P::kYStages * kYStage, Wp, y, y2,
                                          w_begin + v, pt, k, Mp, Np, bm, bmw, c0);
        };

        double ll = 0.0;
        if (n > 0) stage(0);
        for (int v = 0; v < n; ++v) {
            const int w = w_begin + v;
            cp_async_wait_all();
            named_sync(kHProducers, P::kProducers);  // row v has landed; row v - 1's tiles are read
            if (v >= 2) named_sync(kHEmpty + (v & 1), kMeet);  // the consumers are done with v - 2
            if (v + 1 < n) stage(v + 1);
            const float* Ws = Wring + v % P::kWStages * P::kWs;
            const float* Ys = Yring + v % P::kYStages * kYStage;
            float* Ps = PQring + v % P::kPQStages * 2 * P::kPQ;

            // ---- phase A: the WH tile, p and q, the ll terms
            float wh[kPC][4];
#pragma unroll
            for (int j = 0; j < kPC; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) wh[j][r] = 0.f;
            const float4* Hs4 = reinterpret_cast<const float4*>(Hs);
            const float4* W4 = reinterpret_cast<const float4*>(Ws);
#pragma unroll 1
            for (int k8 = 0; k8 < kw; k8 += 8) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int kq = (k8 >> 2) + half;
                    float4 h[kPC];
#pragma unroll
                    for (int j = 0; j < kPC; ++j) h[j] = Hs4[kq * kHCols + cw + kCG * j];
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        const int key = 4 * half + jj;  // (k8 + key) & 7
                        const float4 wv = W4[(k8 + key) * (kHRows / 4) + (rq ^ key)];
#pragma unroll
                        for (int r = 0; r < 4; ++r)
#pragma unroll
                            for (int j = 0; j < kPC; ++j)
                                wh[j][r] = fmaf(lane(wv, r), lane(h[j], jj), wh[j][r]);
                    }
                }
            }

            const int stripe = w / bmw;
            const int row0 = stripe * bm + (w - stripe * bmw);  // data row of bit 0
#pragma unroll
            for (int j = 0; j < kPC; ++j) {
                const int cl = cw + kCG * j;
                hpass_column<P, Sweep, SECOND, LOSS>(wh[j], Ys, Ps, Ps + P::kPQ, rq, cl, c0 + cl,
                                                     row0, bmw, stripe, Mp, bm, m_real, n_real,
                                                     eps, ll);
            }
            named_arrive(kHFull + (v & 1), kMeet);
        }

        if constexpr (LOSS)
            hpass_ll_sum<P::kProducers>(
                ll, ll_warp, pt, [] { named_sync(kHProducers, P::kProducers); }, ll_part, z);
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::kConsumerRegs));
    const int ct = tid - P::kProducers;  // consumer thread
    // Phase B layout: k rows kg + 16 i, columns cg + 16 c; a warp holds 8
    // column groups and 4 k groups, so each of its p, q and W loads reads at
    // most 128 distinct bytes (one shared-memory wavefront).
    const int cg = (ct & 7) | ((ct >> 5 & 1) << 3), kg = (ct >> 3 & 3) | ((ct >> 6) << 2);
    float num[TK][4], den[TK][4];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) num[i][c] = den[i][c] = 0.f;

    for (int v = 0; v < n; ++v) {
        named_sync(kHFull + (v & 1), kMeet);  // row v's Ps/Qs are written
        const float* Ps = PQring + v % P::kPQStages * 2 * P::kPQ;
        // ---- phase B: the accumulation over the row's 32 data rows
        hpass_accumulate<TK, true>(Ps, Ps + P::kPQ, Wring + v % P::kWStages * P::kWs, cg, kg,
                                   cg & 7, kg & 7, k, num, den);
        if (v + 2 < n) named_arrive(kHEmpty + (v & 1), kMeet);  // its stages are free
    }
    hpass_write<TK>(num, den, num_out, den_out, (z * S + s) * k * Np, c0, cg, kg, k, Np);
}

// SECOND: an explicit second operand (corrected mode's Yc); otherwise
// yc = 1 - ym.  LOSS=false compiles the logs and the ll partials out
// (h_terms); TERMS=false phase B and Num/Den (loglik_sum).
template <int TK, bool SECOND, typename Y, bool TERMS, bool LOSS, class E>
__global__ void __launch_bounds__((HPass<TK, SECOND, Y, TERMS, E>::kBlock),
                                  (HPass<TK, SECOND, Y, TERMS, E>::kMinBlocks))
hpass_kernel(const float* __restrict__ Wp, const float* __restrict__ H,
             const Y* __restrict__ y, const Y* __restrict__ y2, float* __restrict__ num_out,
             float* __restrict__ den_out, double* __restrict__ ll_part, int k, int Mp, int Np,
             int bm, int m_real, int n_real, float eps) {
    using P = HPass<TK, SECOND, Y, TERMS, E>;
    extern __shared__ __align__(16) float smem[];
    if constexpr (P::kSplit) {
        hpass_split<TK, SECOND, Y, LOSS>(smem, Wp, H, y, y2, num_out, den_out, ll_part, k, Mp,
                                         Np, bm, m_real, n_real, eps);
    } else {
        float* Hs = smem;
        float* Wbuf = Hs + P::kHs;
        float* Ps = Wbuf + 2 * P::kWs;
        float* Qs = Ps + P::kPQ;
        float* Ys = Qs + P::kPQ;  // y's tile, then y2's
        __shared__ double ll_warp[kThreads / 32];

        const int tid = threadIdx.x;
        const int bmw = bm / 32, Mw = Mp / 32;
        const size_t z = blockIdx.z;  // the lane: its W, H, partials and ll
        Wp += z * k * Mp;
        H += z * k * Np;
        const int c0 = blockIdx.x * kHCols;
        const int S = gridDim.y, s = blockIdx.y;
        const int w_begin = s * (Mw / S) + min(s, Mw % S);
        const int w_end = w_begin + Mw / S + (s < Mw % S ? 1 : 0);
        const int kw = (k + 7) & ~7;  // k rows phase A visits (rows >= k are zero)

        hpass_load_h<P, E, kThreads>(Hs, H, tid, k, Np, c0);

        // Phase A layout: data rows 4 rq .. 4 rq + 3 (bits of the word row),
        // columns cw and cw + 32.
        const int rq = tid & 7, cw = tid >> 3;
        // Phase B layout: k rows kg + 16 i, columns cg + 16 c; a warp holds 8
        // column groups and 4 k groups, so each of its p, q and W loads reads at
        // most 128 distinct bytes (one shared-memory wavefront).
        const int cg = (tid & 7) | ((tid >> 5 & 1) << 3), kg = (tid >> 3 & 3) | ((tid >> 6) << 2);
        const int swp = cg & 7, swk = kg & 7;  // the swizzle keys of those rows

        float num[TK][4], den[TK][4];
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) num[i][c] = den[i][c] = 0.f;
        double ll = 0.0;

        if (w_begin < w_end)
            hpass_stage<P, kThreads>(Wbuf, Ys, Wp, y, y2, w_begin, tid, k, Mp, Np, bm, bmw, c0);
        for (int w = w_begin; w < w_end; ++w) {
            const int st = (w - w_begin) & 1;
            const float* Ws = Wbuf + st * P::kWs;
            cp_async_wait_all();
            __syncthreads();  // step w has landed; the previous phase B is done

            // ---- phase A: the WH tile, p and q, the ll terms
            float wh[2][4];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) wh[j][r] = 0.f;
            const float4* Hs4 = reinterpret_cast<const float4*>(Hs);
#pragma unroll 4
            for (int k8 = 0; k8 < kw; k8 += 8) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int kq = (k8 >> 2) + half;
                    const float4 ha = Hs4[kq * kHCols + cw];
                    const float4 hb = Hs4[kq * kHCols + cw + 32];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int key = 4 * half + j;  // (k8 + key) & 7
                        const float4 wv =
                            reinterpret_cast<const float4*>(Ws + (k8 + key) * kHRows)[rq ^ key];
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            wh[0][r] = fmaf(lane(wv, r), lane(ha, j), wh[0][r]);
                            wh[1][r] = fmaf(lane(wv, r), lane(hb, j), wh[1][r]);
                        }
                    }
                }
            }

            const int stripe = w / bmw;
            const int row0 = stripe * bm + (w - stripe * bmw);  // data row of bit 0
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int cl = cw + 32 * j;
                hpass_column<P, E, SECOND, LOSS>(wh[j], Ys, Ps, Qs, rq, cl, c0 + cl, row0, bmw,
                                                 stripe, Mp, bm, m_real, n_real, eps, ll);
            }
            __syncthreads();  // Ps, Qs written; the operand tile is consumed
            if (w + 1 < w_end)
                hpass_stage<P, kThreads>(Wbuf + (st ^ 1) * P::kWs, Ys, Wp, y, y2, w + 1, tid, k,
                                         Mp, Np, bm, bmw, c0);

            // ---- phase B: the accumulation over the step's 32 data rows
            if constexpr (TERMS)
                hpass_accumulate<TK, false>(Ps, Qs, Ws, cg, kg, swp, swk, k, num, den);
        }

        if constexpr (TERMS)
            hpass_write<TK>(num, den, num_out, den_out, (z * S + s) * k * Np, c0, cg, kg, k, Np);
        if constexpr (LOSS)
            hpass_ll_sum<kThreads>(ll, ll_warp, tid, [] { __syncthreads(); }, ll_part, z);
    }
}

template <bool SECOND, typename Y, bool TERMS, bool LOSS, class E>
struct HpassLauncher {
    // One H-pass launch, grid ceil(Np/64) x nsplit x lanes, into num/den
    // (Num/Den, or the (lanes, nsplit, k, Np) partials).
    template <int TK>
    static cudaError_t launch(const float* Wp, const float* H, const Y* y, const Y* y2,
                              float* num, float* den, double* ll_part, int k, int Mp, int Np,
                              int bm, int m_real, int n_real, int nsplit, int lanes, float eps,
                              cudaStream_t stream) {
        using P = HPass<TK, SECOND, Y, TERMS, E>;
        auto kernel = hpass_kernel<TK, SECOND, Y, TERMS, LOSS, E>;
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)P::kSmem);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        if constexpr (P::kSplit) {
            // setmaxnreg.inc waits until the block holds the registers it
            // asks for: refuse a build that launches the block with fewer
            // than the two roles take together.
            cudaFuncAttributes attr;
            err = cudaFuncGetAttributes(&attr, kernel);
            if (err != cudaSuccess) return err;
            if (attr.numRegs * P::kBlock < P::kProducers * P::kProducerRegs +
                                               (P::kBlock - P::kProducers) * P::kConsumerRegs)
                return cudaErrorInvalidConfiguration;
        }
        const dim3 grid((Np + kHCols - 1) / kHCols, nsplit, lanes);
        kernel<<<grid, P::kBlock, P::kSmem, stream>>>(Wp, H, y, y2, num, den, ll_part, k, Mp, Np,
                                                      bm, m_real, n_real, eps);
        err = cudaGetLastError();
        if constexpr (P::kSplit) {
            if (err == cudaSuccess) ++nbmf_h_split_launches;
        }
        return err;
    }
};

// The H pass of one instance with its fixed-order reductions, for `lanes`
// pairs of factors W (lanes, k, Mp), H (lanes, k, Np) over shared operands
// (1 <= lanes <= 65535): Num/Den (lanes, k, Np) and ll (lanes), over nsplit
// chunks of word rows (1 <= nsplit <= Mp/32).  wperm is (lanes, k, Mp)
// scratch for W's bit-plane copies; with nsplit > 1 the caller passes
// (lanes, nsplit, k, Np) scratch in num_part/den_part (else they may be
// NULL), and ll_part holds lanes * ceil(Np/64) * nsplit doubles.  TERMS=false
// writes ll only, LOSS=false Num/Den only (ll_part and ll may then be
// NULL).  The operand rows are copied as 16-byte vectors: Np % 4 == 0 and
// y, y2 16-byte aligned.
template <bool SECOND, typename Y, bool TERMS, bool LOSS = true, class E = Sweep>
int run_hloss_as(const float* W, const float* H, const Y* y, const Y* y2, float* num, float* den,
                 float* num_part, float* den_part, double* ll_part, float* ll, float* wperm, int k,
                 int Mp, int Np, int bm, int m_real, int n_real, int nsplit, int lanes, float eps,
                 int device, void* stream_ptr) {
    const auto misaligned = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
    const bool split = TERMS && nsplit > 1;
    if (!geometry_ok(k, Mp, Np, bm, lanes) || Np % 4 || nsplit < 1 || nsplit > Mp / 32 ||
        wperm == nullptr || misaligned(wperm) || misaligned(y) || misaligned(y2) ||
        (TERMS && (num == nullptr || den == nullptr)) ||
        (split && (num_part == nullptr || den_part == nullptr)) ||
        (LOSS && (ll_part == nullptr || ll == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const size_t count = (size_t)k * Mp;
    const dim3 copy_grid((unsigned)((count + kThreads - 1) / kThreads), lanes);
    bitplane_w_kernel<E::kRound == Round::kBf16><<<copy_grid, kThreads, 0, stream>>>(
        W, wperm, k, Mp, bm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = dispatch_tk<HpassLauncher<SECOND, Y, TERMS, LOSS, E>>(
        k, wperm, H, y, y2, split ? num_part : num, split ? den_part : den, ll_part, k, Mp, Np,
        bm, m_real, n_real, nsplit, lanes, eps, stream);
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
        const int nparts = ((Np + kHCols - 1) / kHCols) * nsplit;
        sum_ll_kernel<<<lanes, kThreads, 0, stream>>>(ll_part, nparts, ll);
    }
    return (int)cudaGetLastError();
}

// The production H pass (or a probe form of it, policy E) from the operands
// y and, when given, y2.
template <typename Y, bool TERMS, bool LOSS = true, class E = Sweep>
int run_hloss(const float* W, const float* H, const Y* y, const Y* y2, float* num, float* den,
              float* num_part, float* den_part, double* ll_part, float* ll, float* wperm, int k,
              int Mp, int Np, int bm, int m_real, int n_real, int nsplit, int lanes, float eps,
              int device, void* stream_ptr) {
    if (y2 != nullptr)
        return run_hloss_as<true, Y, TERMS, LOSS, E>(W, H, y, y2, num, den, num_part, den_part,
                                                     ll_part, ll, wperm, k, Mp, Np, bm, m_real,
                                                     n_real, nsplit, lanes, eps, device,
                                                     stream_ptr);
    return run_hloss_as<false, Y, TERMS, LOSS, E>(W, H, y, y2, num, den, num_part, den_part,
                                                  ll_part, ll, wperm, k, Mp, Np, bm, m_real,
                                                  n_real, nsplit, lanes, eps, device, stream_ptr);
}

// The W pass of one instance for `lanes` pairs of factors W (lanes, k, Mp),
// H (lanes, k, Np) over shared operands (1 <= lanes <= 65535): T
// (lanes, k, Mp), or (2k, Mp) a lane for chain3_tile, over nsplit column
// chunks (1 <= nsplit <= ceil(Np/32)); with nsplit > 1 the caller passes
// (lanes, nsplit, n_out k, Mp) scratch in part, else it may be NULL.
// The operand rows are copied as 16-byte vectors: Np % 4 == 0 and H, y, y2
// 16-byte aligned.
template <bool SECOND, typename Y, class E = Sweep>
int run_wterms_as(const float* W, const float* H, const Y* y, const Y* y2, float* T, float* part,
                  int k, int Mp, int Np, int bm, int n_real, int nsplit, int lanes, float eps,
                  int device, void* stream_ptr) {
    const auto misaligned = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
    if (!geometry_ok(k, Mp, Np, bm, lanes) || Np % 4 || nsplit < 1 || nsplit > (Np + kWCols - 1) / kWCols
        || (nsplit > 1 && part == nullptr) || misaligned(H) || misaligned(y) || misaligned(y2))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    err = dispatch_tk<WpassLauncher<SECOND, Y, E>>(k, W, H, y, y2, nsplit > 1 ? part : T, k, Mp,
                                                   Np, bm, n_real, nsplit, lanes, eps, stream);
    if (err != cudaSuccess) return (int)err;
    if (nsplit > 1) {
        const size_t count = (size_t)(E::kWForm == 2 ? 2 : 1) * k * Mp;
        const dim3 blocks((unsigned)((count + kThreads - 1) / kThreads), lanes);
        sum_parts_kernel<<<blocks, kThreads, 0, stream>>>(part, T, nsplit, count);
    }
    return (int)cudaGetLastError();
}

// The production W pass (or a probe form of it, policy E): T (k, Mp) from
// the operands y and, when given, y2.
template <typename Y, class E = Sweep>
int run_wterms(const float* W, const float* H, const Y* y, const Y* y2, float* T, float* part,
               int k, int Mp, int Np, int bm, int n_real, int nsplit, int lanes, float eps,
               int device, void* stream_ptr) {
    if (y2 != nullptr)
        return run_wterms_as<true, Y, E>(W, H, y, y2, T, part, k, Mp, Np, bm, n_real, nsplit,
                                         lanes, eps, device, stream_ptr);
    return run_wterms_as<false, Y, E>(W, H, y, y2, T, part, k, Mp, Np, bm, n_real, nsplit, lanes,
                                      eps, device, stream_ptr);
}

}  // namespace
