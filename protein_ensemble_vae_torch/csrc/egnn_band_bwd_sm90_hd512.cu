// EGNN band backward on Hopper (sm_90a), the shared-tile kernel: the
// gradient of egnn_band_fwd_sm90_hd512.cu's function at the native width
// 512 (decoder widths 257 to 512, zero-padded to it) in the fp32 model's
// 3xTF32 mode (PASSES = 3), the bf16 model's one-pass mode (PASSES = 1) and
// the bf16 chain (CB: one bf16 pass), and at the native widths 32 to 256
// (and the widths padded to them) in 3xTF32; fp32 or bf16 a / bs. The
// one-pass mode and the bf16 chain up to 256 run on egnn_band_bwd_sm90.cu.
//
// Replaces the TPU kernel `_bwd_merged_kernel` (egnn_band.py:235, with
// `_edge_chain_cotangents`) of the JAX package's ops/pallas/egnn_band.py.
// Per valid edge it recomputes the forward chain and runs the cotangent
// chain of egnn_band_bwd_sm90.cu's header, and emits d_a, d_bs, d_x, dW_e2 =
// sum m1^T cot_u, dW_x1 = sum m^T cot_v and the vector grads.
//
// What bounds it: operations, 12 Hd^2 FLOP per valid edge (at B4/L256 0.464
// ms at Hd 512 and 0.116 ms at Hd 256 in one TF32 pass, three times that in
// 3xTF32), then the weight stream (four weights of Hd^2 fp32 per 64-row
// step, once per image: 4 images in one pass, 12 in 3xTF32 at 512, 8 in
// 3xTF32 up to 256) and the per-edge scratch round trip (m1, m, cot_u,
// cot_v, cot_pre: 5 x 64 x Hd fp32 per valid step, written and read back
// once).
//
// Design (egnn_sm90.cuh holds the building blocks; the node and reduce
// passes are egnn_passes.cuh's):
//   1. edge pass: egnn_band_fwd_sm90_hd512.cu's block (a producer
//      warpgroup, two consumer warpgroups sharing one [64][Hd] activation
//      tile, each computing its Hd / 2 output columns from its own ring of
//      m64nNWk8 chunks, NW = 64 or Hd / 2 below 128) runs the four products
//      of a step: W_e2 and W_x1 as x @ W (IMG_T), then W_x1 and W_e2 as
//      x @ W^T (IMG_N), each in the mode's passes (product_half at 512,
//      product_split with the split tile beside the activation tile up to
//      256: no rewrite of the tile, two images per product, the small terms
//      in their own accumulator). A persistent grid walks the steps (work
//      items) g, g + G, ... Each activation of the chain is written into the
//      tile (TF32-rounded in one pass, exact in 3xTF32, with its small part
//      into the split tile up to 256) after both consumers have retired the
//      product that read the last one. The step's m1, m, cot_v and cot_u go
//      from the tile to the scratch in the weight-grad layout ([2][Hd][32],
//      egnn_band_bwd_sm90.cu) while the first pass that reads the same tile
//      runs; cot_pre [64][Hd] and d_rel [64][3] keep the row layout the node
//      pass reads, silu'(pre) and silu'(u) wait in the step's cot_pre and
//      cot_u rows. The w_x2 and w_d row dot products span both halves: the
//      second consumer's partial meets the first's in shared memory, added
//      in that order. The vector grads' column sums: a shuffle
//      reduce-scatter per warp, then one fire-and-forget add (red.global)
//      per column into the warp's own sums in device memory ([8 warps][NVEC]
//      [Hd / 2] a block: one writer per address, so the adds land in program
//      order), added in warp order at the block's end; shared memory keeps
//      the tile(s) and a deeper ring.
//   2. node pass (egnn_passes.cuh): d_a, d_bs, d_x gathered per residue.
//   3. weight-grad pass: dW_e2 = M1^T @ COT_U, dW_x1 = M^T @ COT_V as
//      split-K wgmma products, a block per 64 x TN output tile (TN = 64, or
//      Hd below 64) and slice of the steps: a producer warp brings each
//      valid step's two 32-row K blocks of both operands with bulk copies
//      into a WSTAGES ring, one consumer warpgroup runs m64nTNk8 into a step
//      sum over WGRAD_SPAN rows (each k8 step at 512, a 32-row chunk below)
//      and adds it to the running sum in round-to-nearest fp32 (the tensor
//      cores truncate: at ~9,000 rows a sum a truncating accumulator
//      drifted past the model's gradient tolerance at Hd 512, PERF.md). In 3xTF32 it splits each stage in
//      shared memory (Xs = rna(X - trunc(X)), Ys likewise; the next stage's
//      split while this one's products run) and adds Xs.Yt + Xt.Ys + Xt.Yt.
//      (Splitting X in registers for wgmma's register-A form instead
//      measured slower, PERF.md.)
//   4. reduce pass (egnn_passes.cuh): the slices' and blocks' partials
//      summed in index order.
// No atomics: two launches give bitwise-identical outputs.
// The bf16 chain at 512: the one-pass design with a bf16 tile, bf16 images
// and bf16 scratch rows, m64nNk16 products, and the rounding of
// egnn_band_bwd_sm90.cu's bf16 chain; a step's weight-grad operands are one
// bf16 K block per feature ([Hd][64 rows], egnn_sm90.cuh: wgrad_copy_bf16),
// one chunk a valid step in the weight-grad pass, each k16 step its own sum.
//
// Shared memory of the edge pass (bytes; + 1 KiB alignment slack):
//   Hd  | tile(s)            | rings (2 x STAGES x NW x 128) | rows, dot products, flags, barriers | total
//   512 | 131,072 (one)      | 81,920 (NW 64)                | 2,480 | 216,496  (of 232,448)
//   256 | 131,072 (A and As) | 81,920 (NW 64)                | 2,480 | 216,496
//   128 |  65,536            | 81,920 (NW 64)                | 2,480 | 150,960
//    64 |  32,768            | 40,960 (NW 32)                | 2,480 |  77,232
//    32 |  16,384            | 20,480 (NW 16)                | 2,480 |  40,368
// and in the bf16 chain:
//   512 |  65,536 (one, bf16) | 81,920 (NW 64)               | 2,480 | 150,960  (bf16)
// and of the weight-grad pass: WSTAGES x (8 KiB + TN x 128) + (3xTF32) two
// split stages + barriers and the slice's step list, at TN 64:
// 50,224 / 82,992 + 4 x steps, two blocks per SM.

#include "egnn_passes.cuh"
#include "egnn_sm90.cuh"

namespace {

using namespace egnn;
namespace s9 = egnn::sm90;

constexpr int STAGES = 5;                      // chunks of each consumer's ring
constexpr int WSTAGES = 3;                     // stages of the weight-grad ring
constexpr int BAR_ALL = 1;                     // named barrier of both consumer warpgroups
constexpr int CT = s9::CONSUMERS * s9::WG;     // consumer threads
constexpr int WGRAD_THREADS = s9::WG + 32;     // one consumer warpgroup and a producer warp
// edge rows (K) a weight-grad step sum spans: each k8 step at 512 (~9,000
// rows a slice drifted past the gradient tolerance summed whole, PERF.md),
// a 32-row chunk up to 256 (0.4 of kernel 2's 1.6 ms was this pass with
// per-k8 sums, 0.31 with per-chunk ones)
template <int HD>
constexpr int WGRAD_SPAN = HD == 512 ? 8 : 32;

// output columns per product of the edge pass: 64, or a consumer's Hd / 2 below 128
template <int HD>
constexpr int NW_OF = HD / 2 < 64 ? HD / 2 : 64;
template <int HD, bool CB = false>
using HalfOf = s9::Half<HD, NW_OF<HD>, CB>;
// the split tile beside the activation tile (3xTF32 up to 256)
template <int HD>
constexpr bool SPLIT = HD < 512;
// the fill's sigmoid in the fast form (egnn_sm90.cuh: sigmoid_m; the
// epilogues' always are): one pass, and 3xTF32 up to 256
template <int HD, int PASSES>
constexpr bool FAST_SILU = PASSES == 1 || SPLIT<HD>;

template <int PASSES>
constexpr int PARTS = PASSES == 3 ? 2 : 1;     // images per weight: Wb (and Ws)

// The scratch of one call (floats), carved from `base` when given.
struct Scratch {
    float *m1, *mm, *cotu, *cotv, *cotpre, *drel, *vpart, *wpart, *img, *cols;
    int* flags;
};

// the eight warps' column sums of a block (each over its consumer's Hd / 2)
__host__ __device__ constexpr int cols_per_block(int hd) { return 4 * NVEC * hd; }

// passes 0: the bf16 chain (activations and images in bf16, two to a word)
inline size_t scratch_floats(int B, int L, int hd, int W, int G, int nsplit, int passes,
                             Scratch* s, float* base) {
    const size_t R = (size_t)n_items(B, L, W) * M;
    const size_t act = passes == 0 ? R * hd / 2 : R * hd;
    size_t off = 0;
    auto take = [&](size_t n) {
        float* p = base ? base + off : nullptr;
        off += (n + 255) & ~size_t(255);   // 1 KiB apart: bulk copies need 16-byte alignment
        return p;
    };
    s->m1 = take(act);
    s->mm = take(act);
    s->cotu = take(act);
    s->cotv = take(act);
    s->cotpre = take(act);
    s->drel = take(R * 3);
    s->flags = reinterpret_cast<int*>(take((size_t)n_items(B, L, W)));
    s->vpart = take((size_t)G * vpart_stride(hd));
    s->img = take(4 * (passes == 0 ? s9::image_words_bf16(hd) : (size_t)(passes == 3 ? 2 : 1) * hd * hd));
    s->cols = take((size_t)G * cols_per_block(hd));
    const size_t n_wpart = (size_t)2 * nsplit * hd * hd;
    s->wpart = n_wpart <= act ? s->cotpre : take(n_wpart);
    return off;
}

template <int HD, bool CB = false>
struct EdgeLayout {
    using H = HalfOf<HD, CB>;
    static constexpr int TILE = M * H::KW * 4;
    static constexpr int A = 0;                                     // [64][HD]
    static constexpr int AS = A + TILE;                             // [64][HD] (SPLIT)
    static constexpr int RING = AS + (SPLIT<HD> ? TILE : 0);        // [2][STAGES][CHUNK]
    static constexpr int ROWS = RING + 2 * STAGES * H::CHUNK * 4;   // [7][64]
    static constexpr int PART = ROWS + 7 * M * 4;                   // [2][64]
    static constexpr int FLAGS = PART + 2 * M * 4;                  // int [4]
    static constexpr int BARS = FLAGS + 4 * 4;
    static constexpr int SMEM = BARS + 4 * STAGES * 8 + 1024;
    static_assert(SMEM <= 232448, "shared memory of one block");
    static_assert(BARS % 8 == 0, "mbarriers are 8-byte aligned");
};

// Part q (< Hd / 64, or 0 below 64) of the step's tile (A: [64][Hd],
// K-major swizzled) into dst in the weight-grad layout ([2][Hd][32],
// egnn_band_bwd_sm90.cu: tile_to_scratch): a 4 x 4 block (rows 4m..,
// features 4cf..) per thread and part, read as four 16-byte row chunks and
// written as four 16-byte feature chunks. A warp takes 4 row blocks x one
// 32-feature K block (Hd / 8 warp tasks, 8 a part): its quarter-warps read
// the 8 chunks of one tile row (no bank conflict), and each store fills two
// whole 32-byte sectors of 8 feature rows.
template <int HD>
__device__ __forceinline__ void tile_to_scratch(const float* A, float* __restrict__ dst, int tid,
                                                int q) {
    const int lane = tid % 32, wi = tid / 32 + 8 * q;   // wi: HD / 8 warp tasks
    if (wi >= HD / 8) return;
    const int m = 4 * (wi % 4) + lane / 8, cf = 8 * (wi / 4) + lane % 8;
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int r = 4 * m + j;
        v[j] = *reinterpret_cast<const float4*>(A + (cf / 8) * M * s9::KB + r * s9::KB +
                                                (((cf % 8) ^ (r & 7)) << 2));
    }
    const float* w = reinterpret_cast<const float*>(v);
    const int h = m / 8, mr = m % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = 4 * cf + i;
        *reinterpret_cast<float4*>(dst + (size_t)h * HD * s9::KB + k * s9::KB + ((mr ^ (k & 7)) << 2)) =
            make_float4(w[i], w[4 + i], w[8 + i], w[12 + i]);
    }
}

// egnn_band_bwd_sm90.cu's add_cols8: eight column values (four column
// pairs, 8 apart) summed over the warp's rows, lane g adding one of them to
// the warp's sums in device memory (a red.global: the warp is their only
// writer); only the first `pairs` column pairs exist (fewer than four where
// a consumer's columns end first: Hd 32).
__device__ __forceinline__ void add_cols8(float* __restrict__ col, const float (&v)[8], int g,
                                          int pairs = 4) {
    const bool b0 = g & 1, b1 = g & 2, b2 = g & 4;
    float x[4], y[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        x[i] = (b0 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, b0 ? v[i] : v[i + 4], 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
        y[i] = (b1 ? x[i + 2] : x[i]) + __shfl_xor_sync(0xffffffffu, b1 ? x[i] : x[i + 2], 8);
    const float sum = (b2 ? y[1] : y[0]) + __shfl_xor_sync(0xffffffffu, b2 ? y[0] : y[1], 16);
    const int k = 4 * b0 + 2 * b1 + b2;
    if ((k >> 1) < pairs) atomicAdd(col + 8 * (k >> 1) + (k & 1), sum);
}

// Part q (< 8) of the bf16 chain's copy of the step's bf16 tile (A: [64][Hd
// / 2] words) into dst in its weight-grad layout ([Hd][32] words): task tid
// + 256 q of the Hd / 64 x 32 x 8 tasks (K block, word column fp, 8-row
// group c) of egnn_sm90.cuh's wgrad_copy_bf16, in wgrad_task_bf16's order
// within a K block.
template <int HD>
__device__ __forceinline__ void tile_to_scratch_bf16(const float* A, float* __restrict__ dst,
                                                     int tid, int q) {
    static_assert(HD / 64 * s9::KB * 8 == 8 * CT, "eight parts of one task a thread");
    if (q >= 8) return;
    const int task = tid + q * CT, kb = task / (s9::KB * 8);
    int fp, c;
    s9::wgrad_task_bf16(task % (s9::KB * 8), s9::KB, fp, c);
    s9::wgrad_copy_bf16(A + kb * M * s9::KB, dst, 64 * kb, fp, c);
}

template <int PASSES>
__device__ __forceinline__ float2 act2(float v0, float v1) {
    return PASSES == 1 ? make_float2(s9::tf32(v0), s9::tf32(v1)) : make_float2(v0, v1);
}

template <int HD, int PASSES, class In, bool CB>
__global__ void __launch_bounds__(s9::THREADS, 1)
egnn_bwd_edges_sm90_hd512(const In* __restrict__ a, const In* __restrict__ bs,
                          const float* __restrict__ x, const float* __restrict__ cmask,
                          const float* __restrict__ w_d, const float* __restrict__ b_e2,
                          const float* __restrict__ b_x1, const float* __restrict__ w_x2,
                          const float* __restrict__ b_x2, const float* __restrict__ g_agg,
                          const float* __restrict__ g_delta, Scratch s, int B, int L, int W) {
    static_assert(PASSES == 3 || !SPLIT<HD>, "one pass up to 256 runs on egnn_band_bwd_sm90.cu");
    static_assert(!CB || (PASSES == 1 && HD == 512), "the bf16 chain here: one pass at 512");
    using LY = EdgeLayout<HD, CB>;
    using H = HalfOf<HD, CB>;
    constexpr int NW = H::NW, NH = H::NH;
    using Act = typename std::conditional<CB, __nv_bfloat16, float>::type;   // scratch rows
    // column pairs of a column-sum flush: four (32 columns), or a group's NW / 8
    constexpr int PAIRS = NW / 8 < 4 ? NW / 8 : 4;
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    float* A = reinterpret_cast<float*>(sm + LY::A);
    float* As = reinterpret_cast<float*>(sm + LY::AS);
    int* flags = reinterpret_cast<int*>(sm + LY::FLAGS);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BARS);   // [2][STAGES]
    uint64_t* empty = full + 2 * STAGES;
    const int tid = threadIdx.x, wg = tid / s9::WG, lane = tid % 32;
    if (tid == 0) {
        for (int q = 0; q < 2 * STAGES; ++q) {
            s9::mbar_init(&full[q], 1);
            s9::mbar_init(&empty[q], s9::WG / 32);
        }
        s9::fence_mbar_init();
    }
    __syncthreads();

    const int n_steps = (2 * W + OPS - 1) / OPS, n_tiles = (L + T - 1) / T;
    const int items = B * n_tiles * n_steps;

    if (wg == s9::CONSUMERS) {   // the producer warpgroup: warp h streams half h
        s9::setmaxnreg_dec<s9::PRODUCER_REGS>();
        const int half = (tid % s9::WG) / 32;
        if (half < s9::CONSUMERS) {
            float* ring = reinterpret_cast<float*>(sm + LY::RING) + half * STAGES * H::CHUNK;
            s9::RingPos rp;
            for (int item = blockIdx.x; item < items; item += gridDim.x) {
                const int step = item % n_steps, i0 = ((item / n_steps) % n_tiles) * T;
                const size_t row0 = (size_t)(item / (n_steps * n_tiles)) * L;
                bool v = false;
                for (int r = lane; r < M; r += 32) {
                    int i, j;
                    v |= s9::edge_row(cmask, row0, i0, step, r, L, W, i, j);
                }
                if (!__any_sync(0xffffffffu, v)) continue;   // the consumers skip it too
                if (lane == 0)
                    for (int q = 0; q < 4; ++q) {   // e2 (T), x1 (T), x1 (N), e2 (N)
                        const float* big = s.img + (size_t)q * PARTS<PASSES> * H::IMG;
                        if constexpr (SPLIT<HD>) {
                            const size_t off = (size_t)half * (H::IMG / 2);
                            s9::produce_split<H::NQ, H::CHUNK, STAGES>(
                                big + off, big + H::IMG + off, ring, full + half * STAGES,
                                empty + half * STAGES, rp);
                        } else {
                            s9::produce_half<PASSES, NW, STAGES, CB>(big, big + H::IMG, half, ring,
                                                                     full + half * STAGES,
                                                                     empty + half * STAGES, rp);
                        }
                    }
                __syncwarp();
            }
        }
    } else {   // the consumer warpgroups
        s9::setmaxnreg_inc<s9::CONSUMER_REGS>();
        float* ring = reinterpret_cast<float*>(sm + LY::RING) + wg * STAGES * H::CHUNK;
        uint64_t* my_full = full + wg * STAGES;
        uint64_t* my_empty = empty + wg * STAGES;
        float* row_valid = reinterpret_cast<float*>(sm + LY::ROWS);
        float* row_d2 = row_valid + M;
        float* row_cw = row_valid + 2 * M;
        int* row_j = reinterpret_cast<int*>(row_valid + 3 * M);
        float* row_rel = row_valid + 4 * M;
        float* part_wsc = reinterpret_cast<float*>(sm + LY::PART);   // the second consumer's
        float* part_cd2 = part_wsc + M;
        const int t = tid % s9::WG, warp = t / 32, g = lane / 4, tq = lane % 4;
        const int col0 = wg * H::N;
        const int rw = 16 * warp + g;   // the lane's rows: rw, rw + 8
        const float bx2 = CB ? rbf(b_x2[0]) : b_x2[0];
        s9::RingPos rp;
        float acc[NH][H::ACC];
        float tmp[2][H::ACC];     // unused: the kc-major products need no step sums
        float sml[NH][H::ACC];    // 3xTF32 up to 256: the small terms (product_split)
        // this warp's column sums of the vector grads (w_d, b_e2, b_x1, w_x2)
        // over the consumer's columns, [NVEC][Hd / 2], zeroed by the launch
        float* cols = s.cols + (size_t)blockIdx.x * cols_per_block(HD) + (wg * 4 + warp) * NVEC * H::N;
        // one product of the tile into acc, in the mode's passes; side(q)
        // copies part q of the tile to the scratch
        auto product = [&](float* dst) {
            auto side = [&](int q) {
                if constexpr (CB) tile_to_scratch_bf16<HD>(A, dst, tid, q);
                else tile_to_scratch<HD>(A, dst, tid, q);
            };
            if constexpr (SPLIT<HD>)
                s9::product_split<HD, NW, NH, STAGES, 0, false>(A, As, ring, my_full, my_empty,
                                                               rp, acc, tmp, sml, lane, side);
            else
                s9::product_half<PASSES, NW, STAGES, false, CB>(A, ring, my_full, my_empty, rp,
                                                                acc, tmp[0], lane, tid, BAR_ALL,
                                                                side);
        };
        // the activation (v0, v1) at columns (col, col + 1) of row r: rounded to
        // TF32 in one pass, exact in 3xTF32 with its small part in As up to 256,
        // bf16 in the bf16 chain
        auto put2 = [&](int r, int col, float v0, float v1) {
            if constexpr (CB) {
                s9::put2_bf16(A, r, col, s9::bf2r(v0, v1));
                return;
            }
            *reinterpret_cast<float2*>(A + s9::sw_off(r, col, M)) = act2<PASSES>(v0, v1);
            if constexpr (SPLIT<HD>)
                *reinterpret_cast<float2*>(As + s9::sw_off(r, col, M)) =
                    make_float2(s9::tf32_lo(v0), s9::tf32_lo(v1));
        };
        // add_cols8's flush after column pair jj of group h: the sums of the
        // flush's columns, from the first of them
        auto flush = [&](int jj) { return (jj & 3) == PAIRS - 1; };
        float cw_sum = 0.f;   // first consumer, tq == 0: the b_x2 grad over the lane's rows

        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const int i0 = ((item / n_steps) % n_tiles) * T, step = item % n_steps;
            const size_t row0 = (size_t)(item / (n_steps * n_tiles)) * L;
            const size_t erow = (size_t)item * M;
            const In* a_b = a + row0 * HD;
            const In* bs_b = bs + row0 * HD;

            s9::named_sync(BAR_ALL, CT);   // the last step's rows, flags, parts and A are consumed
            if (tid < M) {                 // the first two warps: row tid
                int i, j;
                const bool v = s9::edge_row(cmask, row0, i0, step, tid, L, W, i, j);
                float rel[3] = {0.f, 0.f, 0.f}, d2 = 0.f, cw = 0.f;
                if (v) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                    d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                    const float* gd = g_delta + (row0 + i) * 3;
                    cw = gd[0] * rel[0] + gd[1] * rel[1] + gd[2] * rel[2];
                }
                row_valid[tid] = v ? 1.f : 0.f;
                row_d2[tid] = d2;
                row_cw[tid] = cw;
                row_j[tid] = j;
#pragma unroll
                for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
                const unsigned any = __ballot_sync(0xffffffffu, v);
                if (lane == 0) flags[tid / 32] = any != 0u;
            }
            s9::named_sync(BAR_ALL, CT);
            const bool any = flags[0] | flags[1];
            if (tid == 0) s.flags[item] = any;
            if (!any) continue;   // no valid edge in the step: skipped by all
            const size_t ework = CB ? erow * HD / 2 : erow * HD;   // the step's scratch rows (words)
            float* m1_i = s.m1 + ework;
            float* mm_i = s.mm + ework;
            float* cotu_i = s.cotu + ework;
            float* cotv_i = s.cotv + ework;
            float* cotpre_i = s.cotpre + ework;
            // row r's columns (col, col + 1) of a row-major [64][HD] scratch array in Act
            auto at2 = [&](float* rows, int r, int col) {
                return reinterpret_cast<Act*>(rows) + (size_t)r * HD + col;
            };
            const float vr[2] = {row_valid[rw], row_valid[rw + 8]};

            // m1 = silu(pre) into A; silu'(pre) waits in the cot_pre rows
            if constexpr (CB)
                s9::fill_pre_bf16<In, CT>(A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, HD, tid,
                                          cotpre_i);
            else
                s9::fill_pre<HD, In, CT, PASSES == 1, FAST_SILU<HD, PASSES>>(
                    A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, tid, cotpre_i,
                    SPLIT<HD> ? As : nullptr);
            s9::fence_async_smem();
            s9::named_sync(BAR_ALL, CT);

            // u = m1 @ W_e2 + b_e2: silu'(u) waits in the cot_u rows; m = silu(u) -> A
            product(m1_i);
            s9::named_sync(BAR_ALL, CT);   // both consumers' products (and the copy) have read A
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col0 + h * NW + 8 * jj + 2 * tq;
                    const float2 be = __ldg(reinterpret_cast<const float2*>(b_e2 + col));
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const float a0 = acc[h][4 * jj + 2 * hh], a1 = acc[h][4 * jj + 2 * hh + 1];
                        if constexpr (CB) {   // the column pair in bf16x2
                            const s9::bf2 u = s9::bias2(a0, a1, s9::bf2r(be.x, be.y));
                            const s9::bf2 sg = s9::sigmoid2(u);
                            *reinterpret_cast<s9::bf2*>(at2(cotu_i, rw + 8 * hh, col)) = s9::dsilu2(u, sg);
                            s9::put2_bf16(A, rw + 8 * hh, col, s9::silu2(u, sg));
                        } else {
                            const float u0 = a0 + be.x, u1 = a1 + be.y;
                            const float s0 = s9::sigmoid_fast(u0), s1 = s9::sigmoid_fast(u1);
                            *reinterpret_cast<float2*>(at2(cotu_i, rw + 8 * hh, col)) =
                                make_float2(s9::dsilu_of(u0, s0), s9::dsilu_of(u1, s1));
                            put2(rw + 8 * hh, col, u0 * s0, u1 * s1);
                        }
                    }
                }
            s9::fence_async_smem();
            s9::named_sync(BAR_ALL, CT);

            // v = m @ W_x1 + b_x1; wsc = silu(v) . w_x2 + b_x2 per row; cot_v -> A
            product(mm_i);
            s9::named_sync(BAR_ALL, CT);
            // cot_wsc: cast to bf16 in the bf16 chain
            const float cw[2] = {CB ? rbf(row_cw[rw]) : row_cw[rw],
                                 CB ? rbf(row_cw[rw + 8]) : row_cw[rw + 8]};
            float sw[2] = {0.f, 0.f};
#pragma unroll
            for (int h = 0; h < NH; ++h) {
                float gw8[8], gb8[8];   // four column pairs' sums over the lane's rows
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col0 + h * NW + 8 * jj + 2 * tq;
                    const float2 bx = __ldg(reinterpret_cast<const float2*>(b_x1 + col));
                    float2 wx = __ldg(reinterpret_cast<const float2*>(w_x2 + col));
                    float cot[2][2], gw[2] = {0.f, 0.f}, gb[2] = {0.f, 0.f};
                    if constexpr (CB) {   // the column pair in bf16x2
                        const s9::bf2 wx2 = s9::bf2r(wx.x, wx.y);
                        wx = s9::f2(wx2);
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const s9::bf2 v = s9::bias2(acc[h][4 * jj + 2 * hh],
                                                        acc[h][4 * jj + 2 * hh + 1],
                                                        s9::bf2r(bx.x, bx.y));
                            const s9::bf2 sg = s9::sigmoid2(v);
                            const float2 w1 = s9::f2(s9::silu2(v, sg));
                            const s9::bf2 ct = s9::mul2(s9::mul2(s9::bf2r(cw[hh], cw[hh]), wx2),
                                                       s9::dsilu2(v, sg));
                            s9::put2_bf16(A, rw + 8 * hh, col, ct);
                            const float2 cf = s9::f2(ct);
                            cot[hh][0] = cf.x;
                            cot[hh][1] = cf.y;
                            sw[hh] = fmaf(w1.y, wx.y, fmaf(w1.x, wx.x, sw[hh]));
                            gw[0] += w1.x * cw[hh];   // w_x2 grad
                            gw[1] += w1.y * cw[hh];
                        }
                    } else {
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                            for (int c = 0; c < 2; ++c) {
                                const float wx2 = c ? wx.y : wx.x;
                                const float vv = acc[h][4 * jj + 2 * hh + c] + (c ? bx.y : bx.x);
                                const float sg = s9::sigmoid_fast(vv), w1 = vv * sg;
                                cot[hh][c] = cw[hh] * wx2 * s9::dsilu_of(vv, sg);
                                sw[hh] = fmaf(w1, wx2, sw[hh]);
                                gw[c] += w1 * cw[hh];    // w_x2 grad
                            }
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) put2(rw + 8 * hh, col, cot[hh][0], cot[hh][1]);
                    }
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                        for (int c = 0; c < 2; ++c) gb[c] += cot[hh][c];   // b_x1 grad
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        gw8[2 * (jj & 3) + c] = gw[c];
                        gb8[2 * (jj & 3) + c] = gb[c];
                    }
                    if (flush(jj)) {   // the sums of columns col - 8 (PAIRS - 1) .. col + 1
                        add_cols8(cols + 3 * H::N + col - col0 - 8 * (PAIRS - 1), gw8, g, PAIRS);
                        add_cols8(cols + 2 * H::N + col - col0 - 8 * (PAIRS - 1), gb8, g, PAIRS);
                    }
                }
            }
            const float wsc[2] = {quad_sum(sw[0]), quad_sum(sw[1])};
            if (wg == 1 && tq == 0) {
                part_wsc[rw] = wsc[0];
                part_wsc[rw + 8] = wsc[1];
            }
            s9::fence_async_smem();
            s9::named_sync(BAR_ALL, CT);

            // cot_m = valid * g_agg + cot_v @ W_x1^T; cot_u = cot_m * silu'(u) -> A
            product(cotv_i);
            s9::named_sync(BAR_ALL, CT);
            const int my_i = i0 + g;
#pragma unroll
            for (int h = 0; h < NH; ++h) {
                float gb8[8];
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col0 + h * NW + 8 * jj + 2 * tq;
                    const float2 gv = my_i < L
                        ? __ldg(reinterpret_cast<const float2*>(g_agg + (row0 + my_i) * HD + col))
                        : make_float2(0.f, 0.f);   // the bf16 chain rounds it to bf16 (bf2r)
                    float gb[2] = {0.f, 0.f};
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const float a0 = acc[h][4 * jj + 2 * hh], a1 = acc[h][4 * jj + 2 * hh + 1];
                        float cu0, cu1;
                        if constexpr (CB) {   // the column pair in bf16x2
                            const s9::bf2 ds = *reinterpret_cast<const s9::bf2*>(at2(cotu_i, rw + 8 * hh, col));
                            const s9::bf2 ct = s9::mul2(s9::add2(s9::bf2r(vr[hh] * gv.x, vr[hh] * gv.y),
                                                               s9::bf2r(a0, a1)), ds);
                            const float2 cf = s9::f2(ct);
                            cu0 = cf.x;
                            cu1 = cf.y;
                        } else {
                            const float2 ds = *reinterpret_cast<const float2*>(at2(cotu_i, rw + 8 * hh, col));
                            cu0 = (vr[hh] * gv.x + a0) * ds.x;
                            cu1 = (vr[hh] * gv.y + a1) * ds.y;
                        }
                        gb[0] += cu0;   // b_e2 grad
                        gb[1] += cu1;
                        put2(rw + 8 * hh, col, cu0, cu1);
                    }
                    gb8[2 * (jj & 3)] = gb[0];
                    gb8[2 * (jj & 3) + 1] = gb[1];
                    if (flush(jj))
                        add_cols8(cols + 1 * H::N + col - col0 - 8 * (PAIRS - 1), gb8, g, PAIRS);
                }
            }
            s9::fence_async_smem();
            s9::named_sync(BAR_ALL, CT);   // silu'(u) read by every lane before cot_u replaces it

            // cot_pre = (cot_u @ W_e2^T) * silu'(pre); cot_d2 = cot_pre . w_d per row
            product(cotu_i);
            float sd[2] = {0.f, 0.f};
            const float d2r[2] = {row_d2[rw], row_d2[rw + 8]};
#pragma unroll
            for (int h = 0; h < NH; ++h) {
                float gd8[8];
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col0 + h * NW + 8 * jj + 2 * tq;
                    const float2 wd = __ldg(reinterpret_cast<const float2*>(w_d + col));
                    float gd[2] = {0.f, 0.f};
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        Act* p = at2(cotpre_i, rw + 8 * hh, col);
                        float cp[2] = {0.f, 0.f};
                        if (vr[hh] > 0.f) {
                            if constexpr (CB) {   // silu'(pre) from the fill; the pair in bf16x2
                                const s9::bf2 c2 = s9::mul2(s9::bf2r(acc[h][4 * jj + 2 * hh],
                                                                    acc[h][4 * jj + 2 * hh + 1]),
                                                           *reinterpret_cast<const s9::bf2*>(p));
                                // cot_d2: an fp32 sum of the bf16 products cot_pre w_d
                                const float2 cf = s9::f2(c2), pd = s9::f2(s9::mul2(c2, s9::bf2r(wd.x, wd.y)));
                                cp[0] = cf.x;
                                cp[1] = cf.y;
                                sd[hh] += pd.x;
                                sd[hh] += pd.y;
                            } else {
                                const float2 ds = *reinterpret_cast<const float2*>(p);   // silu'(pre), from the fill
#pragma unroll
                                for (int c = 0; c < 2; ++c) {
                                    cp[c] = acc[h][4 * jj + 2 * hh + c] * (c ? ds.y : ds.x);
                                    sd[hh] = fmaf(cp[c], c ? wd.y : wd.x, sd[hh]);
                                }
                            }
#pragma unroll
                            for (int c = 0; c < 2; ++c) gd[c] += cp[c] * d2r[hh];   // w_d grad
                        }
                        if constexpr (CB)
                            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(cp[0], cp[1]);
                        else
                            *reinterpret_cast<float2*>(p) = make_float2(cp[0], cp[1]);
                    }
                    gd8[2 * (jj & 3)] = gd[0];
                    gd8[2 * (jj & 3) + 1] = gd[1];
                    if (flush(jj))
                        add_cols8(cols + 0 * H::N + col - col0 - 8 * (PAIRS - 1), gd8, g, PAIRS);
                }
            }
            const float cd2[2] = {quad_sum(sd[0]), quad_sum(sd[1])};
            if (wg == 1 && tq == 0) {
                part_cd2[rw] = cd2[0];
                part_cd2[rw + 8] = cd2[1];
            }
            s9::named_sync(BAR_ALL, CT);
            // d_rel = valid * wsc * g_delta_i + 2 * rel * cot_d2, per row
            if (wg == 0 && tq == 0) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int row = rw + 8 * hh;
                    const float vw = vr[hh] * (CB ? rbf(rbf(wsc[hh] + part_wsc[row]) + bx2)
                                                  : wsc[hh] + part_wsc[row] + bx2);
                    const float c2 = cd2[hh] + part_cd2[row];
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float gdc = vr[hh] > 0.f ? g_delta[(row0 + my_i) * 3 + c] : 0.f;
                        s.drel[(erow + row) * 3 + c] = vw * gdc + 2.f * row_rel[row * 3 + c] * c2;
                    }
                    cw_sum += row_cw[row];   // b_x2 grad (fp32 cot_wsc)
                }
            }
        }

        // The block's vector-grad partial: the warps' column sums added in
        // warp order; the b_x2 grad over the threads in order.
        __threadfence();   // this thread's column adds, before the block reads them
        s9::named_sync(BAR_ALL, CT);
        float* red_cw = A;   // [256]
        red_cw[tid] = cw_sum;
        s9::named_sync(BAR_ALL, CT);
        const float* all_cols = s.cols + (size_t)blockIdx.x * cols_per_block(HD);
        float* vp = s.vpart + (size_t)blockIdx.x * vpart_stride(HD);
        for (int k = tid; k < NVEC * HD; k += CT) {
            const int v = k / HD, c = k % HD, half = c / H::N;
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                sum += __ldcg(all_cols + ((half * 4 + q) * NVEC + v) * H::N + c % H::N);
            vp[k] = sum;
        }
        if (tid == 0) {
            float v = 0.f;
            for (int q = 0; q < CT; ++q) v += red_cw[q];
            vp[NVEC * HD] = v;
        }
    }
}

// Split-K weight grads on wgmma: part[z][sl] = X_z^T @ Y_z over the valid
// steps of slice sl (z = 0: (m1, cot_u) -> dW_e2, z = 1: (m, cot_v) ->
// dW_x1), a block per 64 x TN output tile (rows m0.., columns n0..; TN = 64,
// or Hd below 64, where X brings Hd of the m64 operand's rows and the rest
// go unread into unwritten output rows): X's and Y's feature rows of one
// 32-row K block are contiguous in the [2][Hd][32] layout, one bulk copy
// each.
template <int HD>
struct WgradLayout {
    static constexpr int TN = HD < 64 ? HD : 64;                 // output columns of a tile
    static constexpr int ROWS_X = HD < 64 ? HD : 64;             // feature rows X brings
    static constexpr int X_BYTES = 64 * s9::KB * 4;              // the m64 operand
    static constexpr int Y_BYTES = TN * s9::KB * 4;
    static constexpr int STAGE = X_BYTES + Y_BYTES;              // X, Y
    static constexpr int LOADED = ROWS_X * s9::KB * 4 + Y_BYTES; // bytes a stage's copies bring
    static constexpr int SPLIT = WSTAGES * STAGE;                // [2][Xs, Ys] (3xTF32)
    static constexpr int TILES_N = HD / TN, TILES = ((HD + 63) / 64) * TILES_N;
    template <int PASSES>
    __host__ __device__ static constexpr int bars() { return SPLIT + (PASSES == 3 ? 2 * STAGE : 0); }
    template <int PASSES>
    static constexpr size_t smem(int per) {
        return bars<PASSES>() + 2 * WSTAGES * 8 + sizeof(int) * per + 1024;
    }
};

template <int HD, int PASSES, bool CB>
__global__ void __launch_bounds__(WGRAD_THREADS, 2)
egnn_wgrad_sm90_hd512(const float* __restrict__ x0, const float* __restrict__ y0,
                      const float* __restrict__ x1, const float* __restrict__ y1,
                      const int* __restrict__ flags, float* __restrict__ part, int items,
                      int nsplit) {
    using LY = WgradLayout<HD>;
    constexpr int TN = LY::TN, ACC = TN / 2;   // m64nTN fp32 accumulator floats per thread
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::template bars<PASSES>());
    uint64_t* empty = full + WSTAGES;
    int* list = reinterpret_cast<int*>(full + 2 * WSTAGES);
    float* split = reinterpret_cast<float*>(sm + LY::SPLIT);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int m0 = (blockIdx.x / LY::TILES_N) * 64, n0 = (blockIdx.x % LY::TILES_N) * TN;
    const int sl = blockIdx.y, z = blockIdx.z;
    const float* X = z ? x1 : x0;
    const float* Y = z ? y1 : y0;
    if (tid == 0) {
        for (int q = 0; q < WSTAGES; ++q) {
            s9::mbar_init(&full[q], 1);
            s9::mbar_init(&empty[q], s9::WG / 32);
        }
        s9::fence_mbar_init();
    }
    // chunks of a valid step: two 32-row K blocks, or one bf16 K block of 64 rows
    constexpr int PER_STEP = CB ? 1 : 2;
    const int nchunk = PER_STEP * valid_items(flags, items, nsplit, sl, list);   // synchronises the block

    if (warp == s9::WG / 32) {   // the producer warp
        if (lane == 0) {
            s9::RingPos rp;
            for (int q = 0; q < nchunk; ++q) {
                const size_t base = CB ? (size_t)list[q] * M * HD / 2
                                       : (size_t)list[q / 2] * M * HD + (size_t)(q % 2) * s9::KB * HD;
                float* st = reinterpret_cast<float*>(sm + rp.stage * LY::STAGE);
                s9::mbar_wait(&empty[rp.stage], rp.phase ^ 1u);
                s9::mbar_expect_tx(&full[rp.stage], LY::LOADED);
                s9::bulk_load(st, X + base + (size_t)m0 * s9::KB, LY::ROWS_X * s9::KB * 4,
                              &full[rp.stage]);
                s9::bulk_load(st + LY::X_BYTES / 4, Y + base + (size_t)n0 * s9::KB, LY::Y_BYTES,
                              &full[rp.stage]);
                rp.next<WSTAGES>();
            }
        }
        return;
    }
    constexpr int SPAN = WGRAD_SPAN<HD>, NSUM = s9::KB / SPAN;   // step sums a chunk
    float sum[ACC], step[NSUM][ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) sum[i] = 0.f;
    // 3xTF32: Xs, Ys = rna(v - trunc(v)) of a stage into split buffer b;
    // chunk q + 1's split runs while chunk q's products are in flight
    auto split_stage = [&](int stage, int b) {
        const float4* src = reinterpret_cast<const float4*>(sm + stage * LY::STAGE);
        float4* dst = reinterpret_cast<float4*>(split + b * (LY::STAGE / 4));
        for (int i = tid; i < LY::STAGE / 16; i += s9::WG) {
            const float4 v = src[i];
            dst[i] = make_float4(s9::tf32_lo(v.x), s9::tf32_lo(v.y), s9::tf32_lo(v.z),
                                 s9::tf32_lo(v.w));
        }
        s9::fence_async_smem();
    };
    s9::RingPos rp;
    if (PASSES == 3 && nchunk > 0) {
        s9::mbar_wait(&full[rp.stage], rp.phase);
        split_stage(rp.stage, 0);
    }
    for (int q = 0; q < nchunk; ++q) {
        const float* xa = reinterpret_cast<const float*>(sm + rp.stage * LY::STAGE);
        const float* yb = xa + LY::X_BYTES / 4;
        if constexpr (PASSES == 3)   // chunk q's split written, chunk q - 1's products done
            s9::named_sync(1, s9::WG);
        else
            s9::mbar_wait(&full[rp.stage], rp.phase);
#pragma unroll
        for (int j = 0; j < NSUM; ++j) s9::pin(step[j]);
        s9::wg_fence();
#pragma unroll
        for (int k8 = 0; k8 < s9::KB / 8; ++k8) {
            const uint64_t dx = s9::desc(xa + 8 * k8), dy = s9::desc(yb + 8 * k8);
            float(&st)[ACC] = step[8 * k8 / SPAN];
            const bool first = (8 * k8) % SPAN == 0;
            if constexpr (PASSES == 3) {
                const float* xs = split + (q & 1) * (LY::STAGE / 4);
                const float* ys = xs + LY::X_BYTES / 4;
                s9::Wgmma<TN>::mma(st, s9::desc(xs + 8 * k8), dy, first ? 0 : 1);
                s9::Wgmma<TN>::mma(st, dx, s9::desc(ys + 8 * k8), 1);
                s9::Wgmma<TN>::mma(st, dx, dy, 1);
            } else {   // one TF32 pass, or a k16 step of 16 rows in the bf16 chain
                s9::Wgmma<TN, CB>::mma(st, dx, dy, first ? 0 : 1);
            }
        }
        s9::wg_commit();
        if (PASSES == 3 && q + 1 < nchunk) {
            s9::RingPos nx = rp;
            nx.next<WSTAGES>();
            s9::mbar_wait(&full[nx.stage], nx.phase);
            split_stage(nx.stage, (q + 1) & 1);
        }
        s9::wg_wait<0>();
#pragma unroll
        for (int j = 0; j < NSUM; ++j) s9::pin(step[j]);
        if (lane == 0) s9::mbar_arrive(&empty[rp.stage]);
        rp.next<WSTAGES>();
        // each step sum (SPAN rows) added in round-to-nearest fp32, in order
#pragma unroll
        for (int j = 0; j < NSUM; ++j)
#pragma unroll
            for (int i = 0; i < ACC; ++i) sum[i] += step[j][i];
    }

    float* out = part + ((size_t)z * nsplit + sl) * HD * HD;
    const int g = lane / 4, tq = lane % 4;
#pragma unroll
    for (int jj = 0; jj < TN / 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int i = m0 + 16 * warp + g + 8 * hh;
            if (i < HD)
                *reinterpret_cast<float2*>(out + (size_t)i * HD + n0 + 8 * jj + 2 * tq) =
                    make_float2(sum[4 * jj + 2 * hh], sum[4 * jj + 2 * hh + 1]);
        }
}

template <int HD, int PASSES, class In, bool CB>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const float* const* w, const float* g_agg, const float* g_delta, In* da,
                   In* dbs, float* dx, float* dw_e2, float* dw_x1, float* dvec, float* scratch,
                   int B, int L, int W, int G, int nsplit, cudaStream_t stream) {
    using Act = typename std::conditional<CB, __nv_bfloat16, float>::type;
    if (G < 1 || nsplit < 1 || !scratch) return cudaErrorInvalidValue;
    Scratch s;
    scratch_floats(B, L, HD, W, G, nsplit, CB ? 0 : PASSES, &s, scratch);
    const int items = n_items(B, L, W);
    // x @ W_e2, x @ W_x1 (the recomputed products), x @ W_x1^T, x @ W_e2^T
    // (the cotangents), each as Wb (and Ws), or as its bf16 image
    const float* srcs[4] = {w[1], w[3], w[3], w[1]};
    const int orients[4] = {s9::IMG_T, s9::IMG_T, s9::IMG_N, s9::IMG_N};
    cudaError_t err;
    if constexpr (CB) {
        const s9::Bf16ImageSet set{{srcs[0], srcs[1], srcs[2], srcs[3]},
                                   {orients[0], orients[1], orients[2], orients[3]}, 4, HD,
                                   NW_OF<HD>, 2, 0};
        err = s9::launch_images_bf16(set, s.img, stream);
    } else {
        s9::HalfImageSet set{};
        for (int q = 0; q < 4; ++q)
            for (int p = 0; p < PARTS<PASSES>; ++p) {
                set.src[set.n] = srcs[q];
                set.orient[set.n] = orients[q];
                set.part[set.n++] = p;
            }
        err = s9::launch_images_half<HD, NW_OF<HD>>(set, s.img, stream);
    }
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(s.cols, 0, sizeof(float) * G * cols_per_block(HD), stream);
    if (err != cudaSuccess) return err;
    auto edges = egnn_bwd_edges_sm90_hd512<HD, PASSES, In, CB>;
    constexpr int SMEM = EdgeLayout<HD, CB>::SMEM;
    err = cudaFuncSetAttribute(edges, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    edges<<<G, s9::THREADS, SMEM, stream>>>(a, bs, x, cmask, w[0], w[2], w[4], w[5], w[6], g_agg,
                                            g_delta, s, B, L, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    egnn_bwd_nodes<In, Act><<<dim3(L, B), egnn::THREADS, 2 * 2 * W * sizeof(int), stream>>>(
        reinterpret_cast<const Act*>(s.cotpre), s.drel, s.flags, da, dbs, dx, L, HD, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int per = (items + nsplit - 1) / nsplit;
    const size_t wsmem = WgradLayout<HD>::template smem<PASSES>(per);
    auto wgrad = egnn_wgrad_sm90_hd512<HD, PASSES, CB>;
    err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
    if (err != cudaSuccess) return err;
    const dim3 wgrid(WgradLayout<HD>::TILES, nsplit, 2);
    wgrad<<<wgrid, WGRAD_THREADS, wsmem, stream>>>(s.m1, s.cotu, s.mm, s.cotv, s.flags, s.wpart,
                                                   items, nsplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t n_out = 2 * (size_t)HD * HD + NVEC * HD + 1;
    egnn_bwd_reduce<<<(unsigned)((n_out + egnn::THREADS - 1) / egnn::THREADS), egnn::THREADS, 0,
                      stream>>>(s.wpart, s.vpart, dw_e2, dw_x1, dvec, HD, G, nsplit);
    return cudaGetLastError();
}

// f(Int<HD>{}, Int<PASSES>{}, Type<In>{}, std::bool_constant<CB>{}) for the
// modes this kernel takes: width 512 in 1 or 3 passes or in the bf16 chain
// (passes 0: one bf16 pass, CB), the widths 32 to 256 in 3; the input type.
template <class F>
cudaError_t dispatch(int hd, int passes, int bf16_in, F&& f) {
    auto by_in = [&](auto h, auto p, auto cb) -> cudaError_t {
        return bf16_in ? f(h, p, Type<__nv_bfloat16>{}, cb) : f(h, p, Type<float>{}, cb);
    };
    const std::false_type fp32_chain{};
    if (hd == 512 && passes == 0) return by_in(Int<512>{}, Int<1>{}, std::true_type{});
    if (hd == 512 && passes == 1) return by_in(Int<512>{}, Int<1>{}, fp32_chain);
    if (passes != 3) return cudaErrorInvalidValue;
    switch (hd) {
        case 32:  return by_in(Int<32>{}, Int<3>{}, fp32_chain);
        case 64:  return by_in(Int<64>{}, Int<3>{}, fp32_chain);
        case 128: return by_in(Int<128>{}, Int<3>{}, fp32_chain);
        case 256: return by_in(Int<256>{}, Int<3>{}, fp32_chain);
        case 512: return by_in(Int<512>{}, Int<3>{}, fp32_chain);
        default:  return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Floats of scratch one call needs (the caller allocates it), at width hd,
// for G edge-pass blocks, nsplit weight-grad slices and passes (1 or 3).
size_t egnn_band_bwd_sm90_hd512_scratch_floats(int B, int L, int hd, int W, int G, int nsplit,
                                               int passes) {
    Scratch s;
    return scratch_floats(B, L, hd, W, G, nsplit, passes, &s, nullptr);
}

// Edge-pass blocks that one SM holds, or a negative CUDA error code.
int egnn_band_bwd_sm90_hd512_blocks_per_sm(int hd, int bf16_in, int passes) {
    int n = 0;
    const cudaError_t err = dispatch(hd, passes, bf16_in,
                                     [&](auto h_c, auto p_c, auto in_c, auto cb_c) {
        constexpr int HD = decltype(h_c)::value;
        constexpr bool CB = decltype(cb_c)::value;
        auto kernel = egnn_bwd_edges_sm90_hd512<HD, decltype(p_c)::value,
                                                typename decltype(in_c)::type, CB>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             EdgeLayout<HD, CB>::SMEM);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, s9::THREADS,
                                                             EdgeLayout<HD, CB>::SMEM);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch the four passes on `stream`; returns the CUDA error code (0 =
// success). As egnn_band_bwd_sm90_launch, at hd 512 with passes 1 or 3 (TF32
// passes per product) or 0 (the bf16 chain), at hd 32..256 with passes 3;
// scratch as sized above.
int egnn_band_bwd_sm90_hd512_launch(const void* a, const void* bs, const float* x,
                                    const float* cmask, const float* w_d, const float* w_e2,
                                    const float* b_e2, const float* w_x1, const float* b_x1,
                                    const float* w_x2, const float* b_x2, const float* g_agg,
                                    const float* g_delta, void* da, void* dbs, float* dx,
                                    float* dw_e2, float* dw_x1, float* dvec, float* scratch, int B,
                                    int L, int hd, int W, int G, int nsplit, int bf16_in,
                                    int passes, void* stream) {
    const float* w[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(hd, passes, bf16_in, [&](auto h_c, auto p_c, auto in_c, auto cb_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(h_c)::value, decltype(p_c)::value, In, decltype(cb_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, w, g_agg, g_delta,
            static_cast<In*>(da), static_cast<In*>(dbs), dx, dw_e2, dw_x1, dvec, scratch, B, L, W,
            G, nsplit, s);
    });
}

const char* egnn_band_bwd_sm90_hd512_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
