// EGNN band backward on Hopper (sm_90a): the gradient of
// egnn_band_fwd_sm90.cu's function at the native widths 32 to 256, in the
// one-pass fp32-chain mode (precision=None, a bf16 model) and in the bf16
// chain (chain_dtype=bfloat16, CB); bf16 or fp32 a / bs.
//
// Replaces the TPU kernel `_bwd_merged_kernel` (egnn_band.py:235, with
// `_edge_chain_cotangents`) of the JAX package's ops/pallas/egnn_band.py,
// entered through `_fused_bwd`. Per valid edge it recomputes the forward
// chain and runs the cotangent chain, as egnn_band_bwd.cu describes:
//     u = m1 @ W_e2 + b_e2, m = silu(u), v = m @ W_x1 + b_x1,
//     cot_v = cot_wsc * w_x2 * silu'(v), cot_m = valid * g_agg + cot_v @ W_x1^T,
//     cot_u = cot_m * silu'(u), cot_pre = (cot_u @ W_e2^T) * silu'(pre)
// and emits d_a, d_bs, d_x, dW_e2 = sum m1^T cot_u, dW_x1 = sum m^T cot_v
// and the vector grads. Every product's operands are rounded to TF32
// (cvt.rna's rounding) and summed in fp32, as egnn_band_bwd.cu's one pass.
// In the bf16 chain the recomputed forward and the cotangent chain round as
// JAX's `_edge_chain_cotangents` does (egnn_band_bwd.cu's header: g_agg and
// cot_wsc cast to bf16, every elementwise op in bf16, each product's fp32
// sum rounded once; cot_d2, d_rel, the node sums, the weight-grad products
// of the bf16 operands and the vector grads summed in fp32), on bf16 wgmma
// (egnn_sm90.cuh: "the bf16 chain").
//
// What bounds it: operations, 12 Hd^2 FLOP per valid edge at the TF32
// tensor-core rate (0.108 ms at the flagship's B8/L128), and, while the
// weight grads go through device memory, the per-edge scratch: m1, m,
// cot_u, cot_v and cot_pre, 5 x 64 x Hd fp32 per step (420 MB at B8/L128),
// written and read back, 0.27 ms at the card's HBM rate.
//
// Design (egnn_sm90.cuh holds the building blocks; the node and reduce
// passes are egnn_passes.cuh's, shared with egnn_band_bwd.cu):
//   1. edge pass: egnn_band_fwd_sm90.cu's block (a producer warpgroup, two
//      consumer warpgroups, one 64-row step each, a persistent grid over
//      pairs of steps) runs the four products of a step on wgmma. The
//      producer streams four weight images per pair through the mbarrier
//      ring, each chunk read by both consumers: W_e2 and W_x1 as x @ W
//      (IMG_T), then W_x1 and W_e2 as x @ W^T (IMG_N). Each activation of
//      the chain is written, TF32-rounded, into the consumer's A tile and
//      fenced to the async proxy before the next product reads it. The
//      step's m1, m, cot_v and cot_u go from the A tile to the scratch in
//      the layout the weight-grad products read: tf32 wgmma takes K-major
//      operands only, and K is the step's 64 edge rows there, so each is
//      stored feature-major, [2][Hd][32] (two 32-row K blocks, each row of
//      a feature's 32 edge values in the 128-byte swizzle), which one bulk
//      copy per operand lands as a descriptor reads it. cot_pre [64][Hd]
//      and d_rel [64][3] keep the row layout the node pass reads;
//      silu'(pre) waits in the step's cot_pre rows from the fill (which
//      computes pre) and silu'(u) in its cot_u rows, each until the
//      cotangent overwrites it.
//      The vector grads' column sums are summed over a warp's rows by a
//      shuffle reduce-scatter into the warp's own sums in shared memory
//      (registers hold the m64n256 accumulator: ptxas spilled 1.7 KB a
//      thread when the sums stayed there); the b_x2 grad per lane. At the
//      block's end they are added in warp order into its partial. The
//      scratch copies of a step's tile run while the product that reads
//      the same tile is in flight. A step with no valid edge writes its
//      flag 0 and nothing else.
//   2. node pass (egnn_passes.cuh): d_a, d_bs, d_x gathered per residue.
//   3. weight-grad pass: dW_e2 = M1^T @ COT_U, dW_x1 = M^T @ COT_V as
//      split-K wgmma products, a block per 64 x NW output tile and slice of
//      the steps: a producer warp brings each valid step's two 32-row K
//      blocks of both operands with bulk copies into a STAGES-deep ring,
//      one consumer warpgroup runs m64nNWk8; each slice writes its own
//      partial.
//   4. reduce pass (egnn_passes.cuh): the slices' and blocks' partials
//      summed in index order.
// No atomics: two launches give bitwise-identical outputs.
// The bf16 chain: the same passes with bf16 tiles, images and scratch (m1,
// m, cot_u, cot_v, cot_pre and the waiting silu' values in bf16: half the
// round trip). The weight-grad layout of a step is one bf16 K block per
// feature, [Hd][64 edge rows] swizzled (egnn_sm90.cuh: wgrad_copy_bf16), so
// the weight-grad pass brings one chunk per operand and valid step into
// m64nNWk16 products. wgmma could read the tile transposed (its bf16 form
// has imm-trans bits) and skip the copy; the copy keeps the one K-major
// layout every other product here reads.
//
// Shared memory of the edge pass (bytes; + 1 KiB alignment slack):
//   Hd | A tiles | ring (STAGES x NW x 128) | column sums (8 x 4 x Hd x 4) | rows, flags, barriers | total
//   32 |  16,384 | 12,288 |  4,096 | 3,664 |  37,456
//   64 |  32,768 | 24,576 |  8,192 | 3,664 |  70,224
//  128 |  65,536 | 49,152 | 16,384 | 3,664 | 135,760
//  256 | 131,072 | 49,152 | 32,768 | 3,664 | 217,680  (of 232,448)
// and in the bf16 chain (A tiles 2 x 64 x max(Hd / 2, 32) x 4):
//   Hd | A tiles | ring | column sums | rows, flags, barriers | total
//   32 |  16,384 | 12,288 |  4,096 | 3,664 |  37,456  (bf16)
//   64 |  16,384 | 24,576 |  8,192 | 3,664 |  53,840  (bf16)
//  128 |  32,768 | 49,152 | 16,384 | 3,664 | 102,992  (bf16)
//  256 |  65,536 | 49,152 | 32,768 | 3,664 | 152,144  (bf16)
// and of the weight-grad pass: WSTAGES x (64 + NW) x 128 + the slice's
// step list: 66,624 + 4 x steps at Hd 64, 99,392 + 4 x steps at Hd 128 /
// 256, two blocks per SM (the same stages in the bf16 chain).

#include "egnn_passes.cuh"
#include "egnn_sm90.cuh"

namespace {

using namespace egnn;
namespace s9 = egnn::sm90;

constexpr int STAGES = 3;    // edge pass ring depth (chunks)
constexpr int WSTAGES = 4;   // weight-grad ring depth
constexpr int WGRAD_THREADS = s9::WG + 32;   // one consumer warpgroup and a producer warp

// The scratch of one call (floats), carved from `base` when given: the
// four weight-grad operands per step in [2][hd][32] swizzled blocks,
// cot_pre rows, d_rel, flags, the edge blocks' vector partials, the
// weight-grad partials (in cot_pre's place where they fit: the node pass
// has read it by then) and the four weight images.
struct Scratch {
    float *m1, *mm, *cotu, *cotv, *cotpre, *drel, *vpart, *wpart, *img;
    int* flags;
};

// cb: the bf16 chain (activations and images in bf16, two to a word).
inline size_t scratch_floats(int B, int L, int hd, int W, int G, int nsplit, int cb, Scratch* s,
                             float* base) {
    const size_t R = (size_t)n_items(B, L, W) * M;
    const size_t act = cb ? R * hd / 2 : R * hd;
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
    s->img = take(4 * (cb ? s9::image_words_bf16(hd) : (size_t)hd * hd));
    const size_t n_wpart = (size_t)2 * nsplit * hd * hd;
    s->wpart = n_wpart <= act ? s->cotpre : take(n_wpart);
    return off;
}

template <int HD, bool CB = false>
struct EdgeLayout {
    using C = s9::Cols<HD, CB>;
    static constexpr int A_BYTES = M * C::KW * 4;
    static constexpr int A = 0;                                // [2][64][HD]
    static constexpr int RING = A + 2 * A_BYTES;
    static constexpr int ROW_FLOATS = 7 * M;                   // valid, d2, cw, j, rel[3]
    static constexpr int COLS = RING + STAGES * C::CHUNK * 4;  // [8 warps][NVEC][HD]
    static constexpr int ROWS = COLS + 8 * NVEC * HD * 4;
    static constexpr int FLAGS = ROWS + 2 * ROW_FLOATS * 4;    // int [2][4]
    static constexpr int BARS = FLAGS + 2 * 4 * 4;
    static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
    static_assert(SMEM <= 232448, "shared memory of one block");
    static_assert(2 * s9::WG * 4 <= 2 * A_BYTES, "the b_x2 sums fit in the A tiles");
};

// Part q of NQ of the bf16 chain's copy of the step's tile (A: [64][KW]
// words) into dst in its weight-grad layout ([HD][32] words): tasks (K block,
// word column fp, 8-row group c) of egnn_sm90.cuh's wgrad_copy_bf16, in
// wgrad_task_bf16's order within a K block.
template <int HD>
__device__ __forceinline__ void tile_to_scratch_bf16(const float* A, float* __restrict__ dst,
                                                     int t, int q) {
    using C = s9::Cols<HD, true>;
    constexpr int FP = HD < 64 ? HD / 2 : s9::KB;         // word columns of a K block in use
    constexpr int TASKS = (C::KW / s9::KB) * FP * 8;
    constexpr int PER = TASKS / C::NQ;                   // tasks of a part
    static_assert(PER * C::NQ == TASKS && PER % s9::WG == 0, "the copy splits evenly");
    for (int task = t + q * PER; task < (q + 1) * PER; task += s9::WG) {
        const int kb = task / (FP * 8);
        int fp, c;
        s9::wgrad_task_bf16(task % (FP * 8), FP, fp, c);
        s9::wgrad_copy_bf16(A + kb * M * s9::KB, dst, 64 * kb, fp, c);
    }
}

// Part q of NQ of the step's activation tile (A: [64][HD], K-major
// swizzled) into dst in the weight-grad layout ([2][HD][32]: element (r, k)
// at sw_off(k, r % 32, HD) of K block r / 32), one 16-byte chunk of dst per
// thread and iteration. It runs while the product that reads the same A is
// in flight (the side work of s9::product).
template <int HD>
__device__ __forceinline__ void tile_to_scratch(const float* A, float* __restrict__ dst, int t,
                                                int q) {
    constexpr int PER = M * HD / 4 / s9::WG / s9::Cols<HD>::NQ;   // iterations per part
    static_assert(PER * s9::Cols<HD>::NQ * s9::WG * 4 == M * HD, "the copy splits evenly");
    for (int ci = t + q * PER * s9::WG; ci < t + (q + 1) * PER * s9::WG; ci += s9::WG) {
        const int half = ci / (HD * 8), rem = ci % (HD * 8);
        const int k = rem / 8, r = half * 32 + (((rem % 8) ^ (k & 7)) << 2);
        *reinterpret_cast<float4*>(dst + 4 * (size_t)ci) =
            make_float4(A[s9::sw_off(r, k, M)], A[s9::sw_off(r + 1, k, M)],
                        A[s9::sw_off(r + 2, k, M)], A[s9::sw_off(r + 3, k, M)]);
    }
}

// Sum eight column values v[k] (column col + 8 (k / 2) + k % 2) over the
// warp's rows, the lanes of other g, by a butterfly reduce-scatter (seven
// shuffles where summing each value apart takes 24): lane g ends with the
// sum of value k = 4 b0 + 2 b1 + b2 (b the bits of g), in a fixed order,
// and adds it to its column of the warp's sums in shared memory.
__device__ __forceinline__ void add_cols8(float* __restrict__ col, const float (&v)[8], int g) {
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
    col[8 * (k >> 1) + (k & 1)] += sum;
}

template <int HD, class In, bool CB>
__global__ void __launch_bounds__(s9::THREADS, 1)
egnn_bwd_edges_sm90(const In* __restrict__ a, const In* __restrict__ bs,
                    const float* __restrict__ x, const float* __restrict__ cmask,
                    const float* __restrict__ w_d, const float* __restrict__ b_e2,
                    const float* __restrict__ b_x1, const float* __restrict__ w_x2,
                    const float* __restrict__ b_x2, const float* __restrict__ g_agg,
                    const float* __restrict__ g_delta, Scratch s, int B, int L, int W) {
    using C = s9::Cols<HD>;
    using LY = EdgeLayout<HD, CB>;
    constexpr int NH = C::NH, NW = C::NW;
    constexpr size_t IMG = CB ? s9::image_words_bf16(HD) : (size_t)HD * HD;   // words of an image
    using Act = typename std::conditional<CB, __nv_bfloat16, float>::type;    // scratch rows
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    float* ring = reinterpret_cast<float*>(sm + LY::RING);
    int* flags = reinterpret_cast<int*>(sm + LY::FLAGS);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BARS);
    uint64_t* empty = full + STAGES;
    const int tid = threadIdx.x, wg = tid / s9::WG, lane = tid % 32;
    if (tid == 0) {
        for (int q = 0; q < STAGES; ++q) {
            s9::mbar_init(&full[q], 1);
            s9::mbar_init(&empty[q], s9::EMPTY_ARRIVALS);
        }
        s9::fence_mbar_init();
    }
    __syncthreads();

    const int n_steps = (2 * W + OPS - 1) / OPS, n_pairs = (n_steps + 1) / 2;
    const int n_tiles = (L + T - 1) / T, pairs = B * n_tiles * n_pairs;

    if (wg == s9::CONSUMERS) {   // the producer warpgroup: its first warp streams the weights
        s9::setmaxnreg_dec<s9::PRODUCER_REGS>();
        if (tid % s9::WG < 32) {
            s9::RingPos rp;
            for (int pi = blockIdx.x; pi < pairs; pi += gridDim.x) {
                const int p = pi % n_pairs, i0 = ((pi / n_pairs) % n_tiles) * T;
                const size_t row0 = (size_t)(pi / (n_pairs * n_tiles)) * L;
                bool v = false;
                for (int r = lane; r < 2 * M; r += 32) {
                    int i, j;
                    v |= s9::edge_row(cmask, row0, i0, 2 * p + r / M, r % M, L, W, i, j);
                }
                if (!__any_sync(0xffffffffu, v)) continue;   // the consumers skip it too
                if (lane == 0)
                    for (int q = 0; q < 4; ++q)
                        s9::produce<HD, STAGES, CB>(s.img + q * IMG, ring, full, empty, rp);
                __syncwarp();
            }
        }
    } else {   // the consumer warpgroups
        s9::setmaxnreg_inc<s9::CONSUMER_REGS>();
        float* A = reinterpret_cast<float*>(sm + LY::A + wg * LY::A_BYTES);
        float* row_valid = reinterpret_cast<float*>(sm + LY::ROWS) + wg * LY::ROW_FLOATS;
        float* row_d2 = row_valid + M;
        float* row_cw = row_valid + 2 * M;
        int* row_j = reinterpret_cast<int*>(row_valid + 3 * M);
        float* row_rel = row_valid + 4 * M;
        const int t = tid % s9::WG, warp = t / 32, g = lane / 4, tq = lane % 4;
        const int bar = 1 + wg;
        constexpr int BAR_ALL = 3;
        const float bx2 = CB ? rbf(b_x2[0]) : b_x2[0];
        s9::RingPos rp;
        float acc[NH][C::ACC];
        // this warp's column sums of the vector grads: w_d, b_e2, b_x1, w_x2
        float* cols = reinterpret_cast<float*>(sm + LY::COLS) + (wg * 4 + warp) * NVEC * HD;
        for (int k = lane; k < NVEC * HD; k += 32) cols[k] = 0.f;
        float cw_sum = 0.f;   // tq == 0: the b_x2 grad over the lane's rows

        for (int pi = blockIdx.x; pi < pairs; pi += gridDim.x) {
            const int p = pi % n_pairs, i0 = ((pi / n_pairs) % n_tiles) * T;
            const size_t row0 = (size_t)(pi / (n_pairs * n_tiles)) * L;
            const int step = 2 * p + wg;
            // the step's work item (batch row, tile, step) and its scratch rows
            const int item = (pi / n_pairs) * n_steps + step;
            const size_t erow = (size_t)item * M;
            const size_t ework = CB ? erow * HD / 2 : erow * HD;   // the step's scratch rows (words)
            const In* a_b = a + row0 * HD;
            const In* bs_b = bs + row0 * HD;

            s9::named_sync(bar, s9::WG);   // the last step's rows, flags and A are consumed
            {   // thread t checks row t % M of step 2p + t / M; the own step keeps its rows
                const int r = t % M;
                int i, j;
                const bool v = s9::edge_row(cmask, row0, i0, 2 * p + t / M, r, L, W, i, j);
                if (t / M == wg) {
                    float rel[3] = {0.f, 0.f, 0.f}, d2 = 0.f, cw = 0.f;
                    if (v) {
#pragma unroll
                        for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                        d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                        const float* gd = g_delta + (row0 + i) * 3;
                        cw = gd[0] * rel[0] + gd[1] * rel[1] + gd[2] * rel[2];
                    }
                    row_valid[r] = v ? 1.f : 0.f;
                    row_d2[r] = d2;
                    row_cw[r] = cw;
                    row_j[r] = j;
#pragma unroll
                    for (int c = 0; c < 3; ++c) row_rel[r * 3 + c] = rel[c];
                }
                const unsigned any = __ballot_sync(0xffffffffu, v);
                if (lane == 0) flags[wg * 4 + warp] = any != 0u;
            }
            s9::named_sync(bar, s9::WG);
            const int* fl = flags + wg * 4;
            const bool v0 = fl[0] | fl[1], v1 = fl[2] | fl[3], mine = wg ? v1 : v0;
            if (t == 0 && step < n_steps) s.flags[item] = mine;
            if (!v0 && !v1) continue;            // no valid edge in the pair: skipped by all
            if (!mine) {                         // none in this step: release the chunks unread
                for (int q = 0; q < 4; ++q) s9::pass_product<HD, STAGES, CB>(full, empty, rp, lane);
                continue;
            }
            float* m1_i = s.m1 + ework;
            float* mm_i = s.mm + ework;
            float* cotu_i = s.cotu + ework;
            float* cotv_i = s.cotv + ework;
            float* cotpre_i = s.cotpre + ework;
            // row r's columns (col, col + 1) of a row-major [64][HD] scratch array in Act
            auto at2 = [&](float* rows, int r, int col) {
                return reinterpret_cast<Act*>(rows) + (size_t)r * HD + col;
            };
            const int rw = 16 * warp + g;   // the lane's rows: rw, rw + 8
            const float vr[2] = {row_valid[rw], row_valid[rw + 8]};
            // the step's tile part q into the weight-grad layout of dst
            auto copy_to = [&](float* dst) {
                return [=](int q) {
                    if constexpr (CB) tile_to_scratch_bf16<HD>(A, dst, t, q);
                    else tile_to_scratch<HD>(A, dst, t, q);
                };
            };
            // the activation (v0, v1) at columns (col, col + 1) of row r of A
            auto put2 = [&](int r, int col, float v0, float v1) {
                if constexpr (CB) s9::put2_bf16(A, r, col, s9::bf2r(v0, v1));
                else *reinterpret_cast<float2*>(A + s9::sw_off(r, col, M)) =
                         make_float2(s9::tf32(v0), s9::tf32(v1));
            };

            // m1 = silu(pre) in TF32 (or the bf16 chain's rounding) into A;
            // silu'(pre) waits in the cot_pre rows; rows of invalid edges 0
            if constexpr (CB)
                s9::fill_pre_bf16<In, s9::WG>(A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, HD,
                                              t, cotpre_i);
            else
                s9::fill_pre<HD>(A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, t, cotpre_i);
            s9::fence_async_smem();
            s9::named_sync(bar, s9::WG);

            // u = m1 @ W_e2 + b_e2: silu'(u) waits in the cot_u rows; m = silu(u) -> A
            s9::product<HD, STAGES, CB>(A, ring, full, empty, rp, acc, lane, copy_to(m1_i));
            s9::named_sync(bar, s9::WG);   // every warp's products (and the copy) have read A
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = h * NW + 8 * jj + 2 * tq;
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
            s9::named_sync(bar, s9::WG);

            // v = m @ W_x1 + b_x1; wsc = silu(v) . w_x2 + b_x2 per row; cot_v -> A
            // (the bf16 chain: cot_wsc cast to bf16, cot_v = bf16(cot_wsc w_x2) silu'(v))
            s9::product<HD, STAGES, CB>(A, ring, full, empty, rp, acc, lane, copy_to(mm_i));
            s9::named_sync(bar, s9::WG);
            const float cw[2] = {CB ? rbf(row_cw[rw]) : row_cw[rw],
                                 CB ? rbf(row_cw[rw + 8]) : row_cw[rw + 8]};
            float sw[2] = {0.f, 0.f};
#pragma unroll
            for (int h = 0; h < NH; ++h) {
                float gw8[8], gb8[8];   // four column pairs' sums over the lane's rows
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = h * NW + 8 * jj + 2 * tq;
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
                    if ((jj & 3) == 3) {   // the sums of columns jj - 3 .. jj
                        add_cols8(cols + 3 * HD + col - 24, gw8, g);
                        add_cols8(cols + 2 * HD + col - 24, gb8, g);
                    }
                }
            }
            const float wsc[2] = {quad_sum(sw[0]), quad_sum(sw[1])};
            s9::fence_async_smem();
            s9::named_sync(bar, s9::WG);

            // cot_m = valid * g_agg + cot_v @ W_x1^T; cot_u = cot_m * silu'(u) -> A
            // (the bf16 chain: g_agg cast to bf16, each op rounded)
            s9::product<HD, STAGES, CB>(A, ring, full, empty, rp, acc, lane, copy_to(cotv_i));
            s9::named_sync(bar, s9::WG);
            const int my_i = i0 + g;
#pragma unroll
            for (int h = 0; h < NH; ++h) {
                float gb8[8];
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = h * NW + 8 * jj + 2 * tq;
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
                    if ((jj & 3) == 3) add_cols8(cols + 1 * HD + col - 24, gb8, g);
                }
            }
            s9::fence_async_smem();
            s9::named_sync(bar, s9::WG);   // silu'(u) read by every lane before cot_u replaces it

            // cot_pre = (cot_u @ W_e2^T) * silu'(pre); cot_d2 = cot_pre . w_d per row
            // (the bf16 chain: an fp32 sum of the bf16 products cot_pre w_d)
            s9::product<HD, STAGES, CB>(A, ring, full, empty, rp, acc, lane, copy_to(cotu_i));
            float sd[2] = {0.f, 0.f};
            const float d2r[2] = {row_d2[rw], row_d2[rw + 8]};
#pragma unroll
            for (int h = 0; h < NH; ++h) {
                float gd8[8];
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = h * NW + 8 * jj + 2 * tq;
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
                    if ((jj & 3) == 3) add_cols8(cols + 0 * HD + col - 24, gd8, g);
                }
            }
            // d_rel = valid * wsc * g_delta_i + 2 * rel * cot_d2, per row
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const float cd2 = quad_sum(sd[hh]);
                const int row = rw + 8 * hh;
                if (tq == 0) {
                    const float vw = vr[hh] * (CB ? rbf(rbf(wsc[hh]) + bx2) : wsc[hh] + bx2);
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float gdc = vr[hh] > 0.f ? g_delta[(row0 + my_i) * 3 + c] : 0.f;
                        s.drel[(erow + row) * 3 + c] = vw * gdc + 2.f * row_rel[row * 3 + c] * cd2;
                    }
                    cw_sum += row_cw[row];   // b_x2 grad (fp32 cot_wsc)
                }
            }
        }

        // The block's vector-grad partial: the eight consumer warps' column sums
        // added in warp order; the b_x2 grad over the threads in order.
        s9::named_sync(BAR_ALL, s9::CONSUMERS * s9::WG);
        float* red_cw = reinterpret_cast<float*>(sm + LY::A);   // [256]
        red_cw[tid] = cw_sum;
        s9::named_sync(BAR_ALL, s9::CONSUMERS * s9::WG);
        const float* all_cols = reinterpret_cast<const float*>(sm + LY::COLS);
        float* vp = s.vpart + (size_t)blockIdx.x * vpart_stride(HD);
        for (int k = tid; k < NVEC * HD; k += s9::CONSUMERS * s9::WG) {
            float v = 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) v += all_cols[q * NVEC * HD + k];
            vp[k] = v;
        }
        if (tid == 0) {
            float v = 0.f;
            for (int q = 0; q < s9::CONSUMERS * s9::WG; ++q) v += red_cw[q];
            vp[NVEC * HD] = v;
        }
    }
}

// Split-K weight grads on wgmma: part[z][sl] = X_z^T @ Y_z over the valid
// steps of slice sl (z = 0: (m1, cot_u) -> dW_e2, z = 1: (m, cot_v) ->
// dW_x1), a block per 64 x NW output tile (rows m0.., columns n0..): X's
// 64 feature rows and Y's NW of one 32-row K block are contiguous in the
// [2][HD][32] layout, one bulk copy each. In the bf16 chain (CB) a valid
// step is one chunk, its 64 edge rows in one bf16 K block ([HD][32] words),
// and the products m64nNWk16.
template <int HD>
struct WgradLayout {
    using C = s9::Cols<HD>;
    static constexpr int ROWS_A = HD < 64 ? HD : 64;          // feature rows X brings
    static constexpr int A_BYTES = 64 * s9::KB * 4;            // an m64 operand (rows >= HD unused)
    static constexpr int B_BYTES = C::NW * s9::KB * 4;
    static constexpr int STAGE = A_BYTES + B_BYTES;
    static constexpr int BARS = WSTAGES * STAGE;
    static constexpr int LIST = BARS + 2 * WSTAGES * 8;
    static constexpr size_t smem(int per) { return LIST + sizeof(int) * per + 1024; }
};

template <int HD, bool CB>
__global__ void __launch_bounds__(WGRAD_THREADS)
egnn_wgrad_sm90(const float* __restrict__ x0, const float* __restrict__ y0,
                const float* __restrict__ x1, const float* __restrict__ y1,
                const int* __restrict__ flags, float* __restrict__ part, int items, int nsplit) {
    using C = s9::Cols<HD>;
    using LY = WgradLayout<HD>;
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BARS);
    uint64_t* empty = full + WSTAGES;
    int* list = reinterpret_cast<int*>(sm + LY::LIST);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tiles_n = HD / C::NW;
    const int m0 = (blockIdx.x / tiles_n) * 64, n0 = (blockIdx.x % tiles_n) * C::NW;
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
    constexpr int PER_STEP = CB ? 1 : 2;   // chunks of a valid step
    const int nchunk = PER_STEP * valid_items(flags, items, nsplit, sl, list);   // synchronises the block

    if (warp == s9::WG / 32) {   // the producer warp
        if (lane == 0) {
            s9::RingPos rp;
            for (int q = 0; q < nchunk; ++q) {
                const size_t base = CB ? (size_t)list[q] * M * HD / 2
                                       : (size_t)list[q / 2] * M * HD + (size_t)(q % 2) * s9::KB * HD;
                float* st = reinterpret_cast<float*>(sm + rp.stage * LY::STAGE);
                s9::mbar_wait(&empty[rp.stage], rp.phase ^ 1u);
                s9::mbar_expect_tx(&full[rp.stage], LY::ROWS_A * s9::KB * 4 + LY::B_BYTES);
                s9::bulk_load(st, X + base + (size_t)m0 * s9::KB, LY::ROWS_A * s9::KB * 4,
                              &full[rp.stage]);
                s9::bulk_load(st + LY::A_BYTES / 4, Y + base + (size_t)n0 * s9::KB, LY::B_BYTES,
                              &full[rp.stage]);
                rp.next<WSTAGES>();
            }
        }
        return;
    }
    float acc[C::ACC];
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
    s9::pin(acc);
    s9::RingPos rp;
    int prev = -1;
    for (int q = 0; q < nchunk; ++q) {
        s9::mbar_wait(&full[rp.stage], rp.phase);
        const float* st = reinterpret_cast<const float*>(sm + rp.stage * LY::STAGE);
        s9::wg_fence();
#pragma unroll
        for (int k8 = 0; k8 < s9::KB / 8; ++k8)
            s9::Wgmma<C::NW, CB>::mma(acc, s9::desc(st + 8 * k8), s9::desc(st + LY::A_BYTES / 4 + 8 * k8), 1);
        s9::wg_commit();
        s9::wg_wait<1>();
        if (prev >= 0 && lane == 0) s9::mbar_arrive(&empty[prev]);
        prev = rp.stage;
        rp.next<WSTAGES>();
    }
    s9::wg_wait<0>();
    s9::pin(acc);
    if (prev >= 0 && lane == 0) s9::mbar_arrive(&empty[prev]);

    float* out = part + ((size_t)z * nsplit + sl) * HD * HD;
    const int g = lane / 4, tq = lane % 4;
#pragma unroll
    for (int jj = 0; jj < C::NW / 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int i = m0 + 16 * warp + g + 8 * hh;
            if (i < HD)
                *reinterpret_cast<float2*>(out + (size_t)i * HD + n0 + 8 * jj + 2 * tq) =
                    make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
        }
}

template <int HD, class In, bool CB>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const float* const* w, const float* g_agg, const float* g_delta, In* da,
                   In* dbs, float* dx, float* dw_e2, float* dw_x1, float* dvec, float* scratch,
                   int B, int L, int W, int G, int nsplit, cudaStream_t stream) {
    using Act = typename std::conditional<CB, __nv_bfloat16, float>::type;
    if (G < 1 || nsplit < 1 || !scratch) return cudaErrorInvalidValue;
    Scratch s;
    scratch_floats(B, L, HD, W, G, nsplit, CB, &s, scratch);
    const int items = n_items(B, L, W);
    // x @ W_e2, x @ W_x1 (the recomputed products), x @ W_x1^T, x @ W_e2^T (the cotangents)
    cudaError_t err;
    if constexpr (CB) {
        const s9::Bf16ImageSet set{{w[1], w[3], w[3], w[1]},
                                   {s9::IMG_T, s9::IMG_T, s9::IMG_N, s9::IMG_N}, 4, HD,
                                   s9::Cols<HD>::NW, 1, 0};
        err = s9::launch_images_bf16(set, s.img, stream);
    } else {
        const s9::ImageSet set{{w[1], w[3], w[3], w[1]},
                               {s9::IMG_T, s9::IMG_T, s9::IMG_N, s9::IMG_N}, 4};
        err = s9::launch_images<HD>(set, s.img, stream);
    }
    if (err != cudaSuccess) return err;
    auto edges = egnn_bwd_edges_sm90<HD, In, CB>;
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
    const size_t wsmem = WgradLayout<HD>::smem(per);
    auto wgrad = egnn_wgrad_sm90<HD, CB>;
    err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
    if (err != cudaSuccess) return err;
    const dim3 wgrid(((HD + 63) / 64) * (HD / s9::Cols<HD>::NW), nsplit, 2);
    wgrad<<<wgrid, WGRAD_THREADS, wsmem, stream>>>(s.m1, s.cotu, s.mm, s.cotv, s.flags, s.wpart,
                                                   items, nsplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t n_out = 2 * (size_t)HD * HD + NVEC * HD + 1;
    egnn_bwd_reduce<<<(unsigned)((n_out + egnn::THREADS - 1) / egnn::THREADS), egnn::THREADS, 0,
                      stream>>>(s.wpart, s.vpart, dw_e2, dw_x1, dvec, HD, G, nsplit);
    return cudaGetLastError();
}

// f(Int<HD>{}, Type<In>{}, std::bool_constant<CB>{}) for a width of 32 to
// 256, the input type and the mode: passes 1 (the one-pass fp32 chain) or
// 0 (the bf16 chain); cudaErrorInvalidValue otherwise.
template <class F>
cudaError_t dispatch(int hd, int bf16_in, int passes, F&& f) {
    if (passes != 0 && passes != 1) return cudaErrorInvalidValue;
    return s9::dispatch(hd, bf16_in, [&](auto hd_c, auto in_c) {
        return passes ? f(hd_c, in_c, std::false_type{}) : f(hd_c, in_c, std::true_type{});
    });
}

}  // namespace

extern "C" {

// Floats of scratch one call needs (the caller allocates it), for G
// edge-pass blocks and nsplit weight-grad slices, in the mode (passes 1, or
// 0 = the bf16 chain).
size_t egnn_band_bwd_sm90_scratch_floats(int B, int L, int hd, int W, int G, int nsplit,
                                         int passes) {
    Scratch s;
    return scratch_floats(B, L, hd, W, G, nsplit, passes == 0, &s, nullptr);
}

// Edge-pass blocks at width hd (32..256) in the mode that one SM holds, or a
// negative CUDA error code.
int egnn_band_bwd_sm90_blocks_per_sm(int hd, int bf16_in, int passes) {
    int n = 0;
    const cudaError_t err = dispatch(hd, bf16_in, passes, [&](auto hd_c, auto in_c, auto cb_c) {
        constexpr int HD = decltype(hd_c)::value;
        constexpr bool CB = decltype(cb_c)::value;
        auto kernel = egnn_bwd_edges_sm90<HD, typename decltype(in_c)::type, CB>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             EdgeLayout<HD, CB>::SMEM);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, s9::THREADS,
                                                             EdgeLayout<HD, CB>::SMEM);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch the four passes on `stream`; returns the CUDA error code (0 =
// success). Device pointers to contiguous arrays, 16-byte aligned: a, bs
// and da, dbs [B, L, hd] in bf16 when bf16_in, else fp32; the fp32 weights
// w_d, b_e2, b_x1, w_x2 [hd], w_e2, w_x1 [hd, hd] (in, out), b_x2 [1];
// g_agg [B, L, hd], x, g_delta, dx [B, L, 3], cmask [B, L], dw_e2, dw_x1
// [hd, hd], dvec [4 hd + 1] = (dw_d, db_e2, db_x1, dw_x2, db_x2), all fp32;
// scratch as sized above. G: blocks of the persistent edge pass; nsplit:
// slices of the weight grads; passes: 1 (the one-pass fp32 chain) or 0 (the
// bf16 chain).
int egnn_band_bwd_sm90_launch(const void* a, const void* bs, const float* x, const float* cmask,
                              const float* w_d, const float* w_e2, const float* b_e2,
                              const float* w_x1, const float* b_x1, const float* w_x2,
                              const float* b_x2, const float* g_agg, const float* g_delta,
                              void* da, void* dbs, float* dx, float* dw_e2, float* dw_x1,
                              float* dvec, float* scratch, int B, int L, int hd, int W, int G,
                              int nsplit, int bf16_in, int passes, void* stream) {
    const float* w[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(hd, bf16_in, passes, [&](auto hd_c, auto in_c, auto cb_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(hd_c)::value, In, decltype(cb_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, w, g_agg, g_delta,
            static_cast<In*>(da), static_cast<In*>(dbs), dx, dw_e2, dw_x1, dvec, scratch, B, L, W,
            G, nsplit, s);
    });
}

const char* egnn_band_bwd_sm90_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
