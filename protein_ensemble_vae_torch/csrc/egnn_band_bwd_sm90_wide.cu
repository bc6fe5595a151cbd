// EGNN band backward on Hopper (sm_90a) above decoder width 512: the
// gradient of egnn_band_fwd_sm90_wide.cu's function in both fp32-chain
// modes (3xTF32, PASSES = 3, the fp32 model; one TF32 pass, PASSES = 1, the
// bf16 model) and in the bf16 chain (CB: one bf16 pass), fp32 or bf16 a /
// bs, at a width hd given at run time (a multiple of 256 above 512).
//
// Replaces the TPU kernel `_bwd_merged_kernel` (egnn_band.py:235, with
// `_edge_chain_cotangents`) of the JAX package's ops/pallas/egnn_band.py.
// Per valid edge it recomputes the forward chain and runs the cotangent
// chain (egnn_band_bwd_sm90.cu's header), and emits d_a, d_bs, d_x, dW_e2 =
// sum m1^T cot_u, dW_x1 = sum m^T cot_v and the vector grads.
//
// What bounds it: operations, 12 hd^2 FLOP per valid edge (at Hd 1024,
// B4/L256 1.854 ms in one TF32 pass, three times that in 3xTF32); then the
// streams: four weights of hd^2 fp32 per 64-row step, once per image (1 or
// 2 images), each of the four products re-reading its A operand once per
// column pass, and the per-edge scratch round trip (m1, m, cot_u, cot_v,
// cot_pre: 5 x 64 x hd fp32 per valid step, written and read back once).
//
// Design (egnn_sm90_wide.cuh holds the building blocks; the node and reduce
// passes are egnn_passes.cuh's):
//   1. edge pass: egnn_band_fwd_sm90_wide.cu's block (a producer thread
//      streaming A and weight chunks into one ring, two consumer warpgroups
//      taking NW columns each of every column pass) runs the four products
//      of a step: W_e2 and W_x1 as x @ W (IMG_T), then W_x1 and W_e2 as
//      x @ W^T (IMG_N). A persistent grid walks the steps (work items) g,
//      g + G, ... The activations go to the block's two stream buffers in
//      turn (m1 and cot_v to the first, m and cot_u to the second; rounded
//      to TF32 in one pass, exact in 3xTF32, whose small part the consumers
//      split in shared memory per K block); while a
//      product's first column pass runs, each K block of its A operand, in
//      its ring stage, is copied into the step's scratch rows in the
//      weight-grad layout ([2][hd][32], feature-major 32-row K blocks) by
//      the consumer threads. silu'(pre) and silu'(u) wait in the step's
//      cot_pre and cot_u rows (row-major) until the cotangents replace them.
//      The w_x2 and w_d row dot products sum over the column passes in the
//      lane's registers; the second consumer's partials meet the first's in
//      shared memory, added in that order. The vector grads' column sums: a
//      shuffle reduce-scatter per warp, then one red.global per column into
//      the warp's own sums in device memory ([8 warps][NVEC][hd / 2] a
//      block: one writer per address, so the adds land in program order),
//      added in warp order at the block's end.
//   2. node pass (egnn_passes.cuh): d_a, d_bs, d_x gathered per residue.
//   3. weight-grad pass: egnn_band_bwd_sm90_hd512.cu's (split-K wgmma, a
//      block per 64 x 64 output tile and slice of the steps, a producer
//      warp's bulk copies into a ring, step sums (WGRAD_SPAN) added in
//      round-to-nearest fp32, 3xTF32 split in shared memory), here with the
//      width at run time.
//   4. reduce pass (egnn_passes.cuh): the slices' and blocks' partials
//      summed in index order.
// No atomics on an output: two launches give bitwise-identical outputs.
// The bf16 chain: the one-pass configuration on bf16 stream rows, images and
// scratch rows (egnn_sm90_wide.cuh), the rounding of egnn_band_bwd_sm90.cu's
// bf16 chain; each K block of 64 features goes to the weight-grad layout of
// one bf16 K block per feature ([hd][64 rows], egnn_sm90.cuh:
// wgrad_copy_bf16), one chunk a valid step in the weight-grad pass.
//
// Shared memory of the edge pass (bytes; + 1 KiB alignment slack), any width:
//   passes | ring (STAGES x stage), split buffers | rows, parts, flags, barriers | total
//   1      | 204,800 (5 x 40,960)                 | 2,400 | 208,224  (of 232,448)
//   3      | 163,840 (4 x 40,960) + 24,576        | 2,384 | 191,824  (of 232,448)
// and the bf16 chain as one pass;
// and of the weight-grad pass: WSTAGES x 16 KiB + (3xTF32) two split stages
// + barriers and the slice's step list: 50,224 / 82,992 + 4 x steps.

#include "egnn_passes.cuh"
#include "egnn_sm90_wide.cuh"

namespace {

using namespace egnn;
namespace s9 = egnn::sm90;
namespace wd = egnn::sm90::wide;

constexpr int WSTAGES = 3;                     // stages of the weight-grad ring
constexpr int WGRAD_THREADS = s9::WG + 32;     // one consumer warpgroup and a producer warp
constexpr int WGRAD_TN = 64;                   // weight-grad output tile edge
// edge rows a weight-grad step sum spans, each added to the running sum in
// round-to-nearest fp32: each k8 step in one pass (four independent sums
// keep the tensor cores busy), a 32-row K block in 3xTF32 (four sums of
// three products each cost more registers than they save; PERF.md)
template <int PASSES>
constexpr int WGRAD_SPAN = PASSES == 3 ? 32 : 8;

template <int PASSES>
constexpr int PARTS = PASSES == 3 ? 2 : 1;     // images per weight: Wb (and Ws)

// The scratch of one call (floats), carved from `base` when given.
struct Scratch {
    float *m1, *mm, *cotu, *cotv, *cotpre, *drel, *vpart, *wpart, *img, *cols, *stream;
    int* flags;
};

// the eight warps' column sums of a block (each over its consumer's hd / 2)
__host__ __device__ constexpr size_t cols_per_block(int hd) { return (size_t)4 * NVEC * hd; }
// a block's stream buffers: two, each 64 x hd
__host__ __device__ constexpr size_t stream_floats(int hd) { return (size_t)2 * M * hd; }

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
    s->stream = take((size_t)G * stream_floats(hd));
    const size_t n_wpart = (size_t)2 * nsplit * hd * hd;
    s->wpart = n_wpart <= act ? s->cotpre : take(n_wpart);
    return off;
}

template <int PASSES>
struct EdgeLayout {
    using C = wd::Cfg<PASSES>;
    static constexpr int RING = 0;                                 // [STAGES][STAGE]
    static constexpr int SPLIT = RING + C::STAGES * C::STAGE * 4;  // [SPLITS][ACHUNK]
    static constexpr int ROWS = SPLIT + C::SPLITS * wd::ACHUNK * 4; // [7][64]
    static constexpr int PART = ROWS + 7 * M * 4;                  // [2][64]
    static constexpr int FLAGS = PART + 2 * M * 4;                 // int [2]
    static constexpr int BARS = FLAGS + 2 * 4;                     // full, empty [STAGES], act
    static constexpr int SMEM = BARS + (2 * C::STAGES + 1) * 8 + 1024;
    static_assert(SMEM <= 232448, "shared memory of one block");
    static_assert(BARS % 8 == 0, "mbarriers are 8-byte aligned");
};

// K block kc of a step's activation, in ring stage `st` ([64][32], K-major
// swizzled), into dst (the step's rows in the weight-grad layout [2][hd][32]:
// element (row r, feature k) at (r / 32) hd 32 + sw_off(k, r % 32)): a 4 x 4
// block (rows 4m.., features 4cf..) per thread, the first consumer's 128
// threads on even K blocks and the second's on odd ones. A quarter-warp
// reads the 8 chunks of one row (no bank conflict). The stores are
// evict-first (__stcs): the weight-grad pass reads them, not this one.
__device__ __forceinline__ void chunk_to_scratch(const float* st, float* __restrict__ dst, int hd,
                                                 int kc, int tid) {
    if ((tid / s9::WG) != (kc & 1)) return;
    const int t = tid % s9::WG, m = t / 8, cf = t % 8;
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int r = 4 * m + j;
        v[j] = *reinterpret_cast<const float4*>(st + r * s9::KB + ((cf ^ (r & 7)) << 2));
    }
    const float* w = reinterpret_cast<const float*>(v);
    const int h = m / 8, mr = m % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = kc * s9::KB + 4 * cf + i;
        __stcs(reinterpret_cast<float4*>(dst + (size_t)h * hd * s9::KB + (size_t)k * s9::KB +
                                         ((mr ^ (k & 7)) << 2)),
               make_float4(w[i], w[4 + i], w[8 + i], w[12 + i]));
    }
}

// The bf16 chain's chunk_to_scratch: K block kc of a step's bf16 activation
// in ring stage `st` ([64 rows][32 words], 64 features) into dst (the step's
// rows in the bf16 weight-grad layout [hd][32 words]), by the first
// consumer's threads on even K blocks and the second's on odd ones, two of
// egnn_sm90.cuh's wgrad_copy_bf16 tasks each (8-row groups c and c + 4).
__device__ __forceinline__ void chunk_to_scratch_bf16(const float* st, float* __restrict__ dst,
                                                      int kc, int tid) {
    if ((tid / s9::WG) != (kc & 1)) return;
    for (int task = tid % s9::WG; task < s9::KB * 8; task += s9::WG) {
        int fp, c;
        s9::wgrad_task_bf16(task, s9::KB, fp, c);
        s9::wgrad_copy_bf16(st, dst, 64 * kc, fp, c);
    }
}

// egnn_band_bwd_sm90_hd512.cu's add_cols8: eight column values (four column
// pairs, 8 apart) summed over the warp's rows, lane g adding one of them to
// the warp's sums in device memory (a red.global: the warp is their only
// writer).
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
    atomicAdd(col + 8 * (k >> 1) + (k & 1), sum);
}

template <int PASSES, class In, bool CB>
__global__ void __launch_bounds__(s9::THREADS, 1)
egnn_bwd_edges_sm90_wide(const In* __restrict__ a, const In* __restrict__ bs,
                         const float* __restrict__ x, const float* __restrict__ cmask,
                         const float* __restrict__ w_d, const float* __restrict__ b_e2,
                         const float* __restrict__ b_x1, const float* __restrict__ w_x2,
                         const float* __restrict__ b_x2, const float* __restrict__ g_agg,
                         const float* __restrict__ g_delta, Scratch s, int B, int L, int hd,
                         int W) {
    using LY = EdgeLayout<PASSES>;
    using C = wd::Cfg<PASSES>;
    constexpr int NW = C::NW, ACC = C::ACC;
    constexpr bool ROUND = PASSES == 1;   // activations rounded to TF32 in one pass
    using Act = typename std::conditional<CB, __nv_bfloat16, float>::type;   // scratch rows
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    float* ring = reinterpret_cast<float*>(sm + LY::RING);
    float* split = reinterpret_cast<float*>(sm + LY::SPLIT);
    int* flags = reinterpret_cast<int*>(sm + LY::FLAGS);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BARS);
    uint64_t* empty = full + C::STAGES;
    uint64_t* act = empty + C::STAGES;
    const int tid = threadIdx.x, wg = tid / s9::WG, lane = tid % 32;
    if (tid == 0) {
        for (int q = 0; q < C::STAGES; ++q) {
            s9::mbar_init(&full[q], 1);
            s9::mbar_init(&empty[q], s9::EMPTY_ARRIVALS);
        }
        s9::mbar_init(act, 1);
        s9::fence_mbar_init();
    }
    __syncthreads();

    const int n_steps = (2 * W + OPS - 1) / OPS, n_tiles = (L + T - 1) / T;
    const int items = B * n_tiles * n_steps;
    const size_t img_floats = CB ? s9::image_words_bf16(hd) : (size_t)hd * hd;
    // this block's stream buffers: b0 (m1, cot_v), b1 (m, cot_u)
    float* b0 = s.stream + (size_t)blockIdx.x * stream_floats(hd);
    float* b1 = b0 + (size_t)M * hd;

    if (wg == s9::CONSUMERS) {   // the producer warpgroup: its first warp, one thread streams
        s9::setmaxnreg_dec<s9::PRODUCER_REGS>();
        if (tid % s9::WG < 32) {
            s9::RingPos rp;
            uint32_t act_phase = 0;
            for (int item = blockIdx.x; item < items; item += gridDim.x) {
                const int step = item % n_steps, i0 = ((item / n_steps) % n_tiles) * T;
                const size_t row0 = (size_t)(item / (n_steps * n_tiles)) * L;
                if (!wd::step_has_edge(cmask, row0, i0, step, L, W, lane)) continue;
                if (lane == 0)
                    for (int q = 0; q < 4; ++q) {   // e2 (T), x1 (T), x1 (N), e2 (N)
                        const float* big = s.img + (size_t)q * PARTS<PASSES> * img_floats;
                        wd::produce<PASSES, CB>(q & 1 ? b1 : b0, big, big + img_floats, hd, ring,
                                                full, empty, act, act_phase, rp);
                    }
                __syncwarp();
            }
        }
    } else {   // the consumer warpgroups
        s9::setmaxnreg_inc<s9::CONSUMER_REGS>();
        float* row_valid = reinterpret_cast<float*>(sm + LY::ROWS);
        float* row_d2 = row_valid + M;
        float* row_cw = row_valid + 2 * M;
        int* row_j = reinterpret_cast<int*>(row_valid + 3 * M);
        float* row_rel = row_valid + 4 * M;
        float* part_wsc = reinterpret_cast<float*>(sm + LY::PART);   // the second consumer's
        float* part_cd2 = part_wsc + M;
        const int t = tid % s9::WG, warp = t / 32, g = lane / 4, tq = lane % 4;
        const int rw = 16 * warp + g;   // the lane's rows: rw, rw + 8 (receiver g)
        const int half = hd / 2;
        const float bx2 = CB ? rbf(b_x2[0]) : b_x2[0];
        s9::RingPos rp;
        int sq = 0;   // split buffer of the next K block (3xTF32)
        float acc[ACC], tmp0[ACC], tmp1[ACC], sml[ACC];
        // this warp's column sums of the vector grads (w_d, b_e2, b_x1, w_x2)
        // over its consumer's columns, [NVEC][hd / 2], zeroed by the launch;
        // column p NC + wg NW + c of pass p is entry p NW + c
        float* cols = s.cols + (size_t)blockIdx.x * cols_per_block(hd) +
                      (size_t)(wg * 4 + warp) * NVEC * half;
        float cw_sum = 0.f;   // first consumer, tq == 0: the b_x2 grad over the lane's rows

        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const int i0 = ((item / n_steps) % n_tiles) * T, step = item % n_steps;
            const size_t row0 = (size_t)(item / (n_steps * n_tiles)) * L;
            const size_t erow = (size_t)item * M;
            const In* a_b = a + row0 * hd;
            const In* bs_b = bs + row0 * hd;

            s9::named_sync(wd::BAR_C, wd::CT);   // the last step's rows, flags and parts are consumed
            if (tid < M)
                wd::step_rows(x, cmask, g_delta, row0, i0, step, tid, L, W, row_valid, row_d2,
                              row_j, row_rel, row_cw, flags);
            s9::named_sync(wd::BAR_C, wd::CT);
            const bool any = flags[0] | flags[1];
            if (tid == 0) s.flags[item] = any;
            if (!any) continue;   // no valid edge in the step: skipped by all
            const size_t ework = CB ? erow * hd / 2 : erow * hd;   // the step's scratch rows (words)
            float* m1_i = s.m1 + ework;
            float* mm_i = s.mm + ework;
            float* cotu_i = s.cotu + ework;
            float* cotv_i = s.cotv + ework;
            float* cotpre_i = s.cotpre + ework;
            // row r's columns (col, col + 1) of a row-major [64][hd] scratch array in Act
            auto at2 = [&](float* rows, int r, int col) {
                return reinterpret_cast<Act*>(rows) + (size_t)r * hd + col;
            };
            const float vr[2] = {row_valid[rw], row_valid[rw + 8]};
            // cot_wsc: cast to bf16 in the bf16 chain
            const float cw[2] = {CB ? rbf(row_cw[rw]) : row_cw[rw],
                                 CB ? rbf(row_cw[rw + 8]) : row_cw[rw + 8]};
            const float d2r[2] = {row_d2[rw], row_d2[rw + 8]};
            const int my_i = i0 + g;
            // side(kc, stage): K block kc of the product's A into dst's weight-grad rows
            auto copy_to = [&](float* dst) {
                return [=](int kc, const float* st) {
                    if constexpr (CB) chunk_to_scratch_bf16(st, dst, kc, tid);
                    else chunk_to_scratch(st, dst, hd, kc, tid);
                };
            };
            // pass p's column of jj, tq and its entry in the warp's column sums
            auto col_of = [&](int p, int jj) { return p * C::NC + wg * NW + 8 * jj + 2 * tq; };
            auto sum_at = [&](int v, int p, int jj) {   // the flush of pairs jj - 3 .. jj
                return cols + (size_t)v * half + p * NW + 8 * (jj - 3) + 2 * tq;
            };

            // m1 = silu(pre) into b0; silu'(pre) waits in the cot_pre rows
            if constexpr (CB)
                s9::fill_pre_bf16<In, wd::CT>(b0, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, hd,
                                              tid, cotpre_i);
            else
                wd::fill<PASSES, PASSES == 3>(b0, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, hd,
                                              tid, cotpre_i);
            wd::publish(act, tid);

            // u = m1 @ W_e2 + b_e2: silu'(u) waits in the cot_u rows; m = silu(u) -> b1
            wd::consume<PASSES, CB>(ring, split, sq, full, empty, rp, hd, wg, tid, lane, acc, tmp0,
                                    tmp1, sml,
                                    copy_to(m1_i), [&](int p, float (&ac)[ACC]) {
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col_of(p, jj);
                    const float2 be = __ldg(reinterpret_cast<const float2*>(b_e2 + col));
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const float a0 = ac[4 * jj + 2 * hh], a1 = ac[4 * jj + 2 * hh + 1];
                        if constexpr (CB) {   // the column pair in bf16x2
                            const s9::bf2 u = s9::bias2(a0, a1, s9::bf2r(be.x, be.y));
                            const s9::bf2 sg = s9::sigmoid2(u);
                            *reinterpret_cast<s9::bf2*>(at2(cotu_i, rw + 8 * hh, col)) = s9::dsilu2(u, sg);
                            s9::put2_bf16(b1, rw + 8 * hh, col, s9::silu2(u, sg));
                        } else {
                            const float u0 = a0 + be.x, u1 = a1 + be.y;
                            const float s0 = s9::sigmoid_fast(u0), s1 = s9::sigmoid_fast(u1);
                            *reinterpret_cast<float2*>(at2(cotu_i, rw + 8 * hh, col)) =
                                make_float2(s9::dsilu_of(u0, s0), s9::dsilu_of(u1, s1));
                            wd::put2<ROUND>(b1, rw + 8 * hh, col, u0 * s0, u1 * s1);
                        }
                    }
                }
            });
            wd::publish(act, tid);

            // v = m @ W_x1 + b_x1; wsc = silu(v) . w_x2 + b_x2 per row; cot_v -> b0
            float sw[2] = {0.f, 0.f};
            wd::consume<PASSES, CB>(ring, split, sq, full, empty, rp, hd, wg, tid, lane, acc, tmp0,
                                    tmp1, sml,
                                    copy_to(mm_i), [&](int p, float (&ac)[ACC]) {
                float gw8[8], gb8[8];   // four column pairs' sums over the lane's rows
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col_of(p, jj);
                    const float2 bx = __ldg(reinterpret_cast<const float2*>(b_x1 + col));
                    float2 wx = __ldg(reinterpret_cast<const float2*>(w_x2 + col));
                    float cot[2][2], gw[2] = {0.f, 0.f}, gb[2] = {0.f, 0.f};
                    if constexpr (CB) {   // the column pair in bf16x2
                        const s9::bf2 wx2 = s9::bf2r(wx.x, wx.y);
                        wx = s9::f2(wx2);
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const s9::bf2 v = s9::bias2(ac[4 * jj + 2 * hh], ac[4 * jj + 2 * hh + 1],
                                                        s9::bf2r(bx.x, bx.y));
                            const s9::bf2 sg = s9::sigmoid2(v);
                            const float2 w1 = s9::f2(s9::silu2(v, sg));
                            const s9::bf2 ct = s9::mul2(s9::mul2(s9::bf2r(cw[hh], cw[hh]), wx2),
                                                       s9::dsilu2(v, sg));
                            s9::put2_bf16(b0, rw + 8 * hh, col, ct);
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
                                const float vv = ac[4 * jj + 2 * hh + c] + (c ? bx.y : bx.x);
                                const float sg = s9::sigmoid_fast(vv), w1 = vv * sg;
                                cot[hh][c] = cw[hh] * wx2 * s9::dsilu_of(vv, sg);
                                sw[hh] = fmaf(w1, wx2, sw[hh]);
                                gw[c] += w1 * cw[hh];    // w_x2 grad
                            }
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh)
                            wd::put2<ROUND>(b0, rw + 8 * hh, col, cot[hh][0], cot[hh][1]);
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
                    if ((jj & 3) == 3) {
                        add_cols8(sum_at(3, p, jj), gw8, g);
                        add_cols8(sum_at(2, p, jj), gb8, g);
                    }
                }
            });
            const float wsc[2] = {quad_sum(sw[0]), quad_sum(sw[1])};
            if (wg == 1 && tq == 0) {
                part_wsc[rw] = wsc[0];
                part_wsc[rw + 8] = wsc[1];
            }
            wd::publish(act, tid);   // also: part_wsc is written

            // cot_m = valid * g_agg + cot_v @ W_x1^T; cot_u = cot_m * silu'(u) -> b1
            wd::consume<PASSES, CB>(ring, split, sq, full, empty, rp, hd, wg, tid, lane, acc, tmp0,
                                    tmp1, sml,
                                    copy_to(cotv_i), [&](int p, float (&ac)[ACC]) {
                float gb8[8];
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col_of(p, jj);
                    const float2 gv = my_i < L
                        ? __ldg(reinterpret_cast<const float2*>(g_agg + (row0 + my_i) * hd + col))
                        : make_float2(0.f, 0.f);   // the bf16 chain rounds it to bf16 (bf2r)
                    float gb[2] = {0.f, 0.f};
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const float a0 = ac[4 * jj + 2 * hh], a1 = ac[4 * jj + 2 * hh + 1];
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
                        wd::put2<ROUND, CB>(b1, rw + 8 * hh, col, cu0, cu1);
                    }
                    gb8[2 * (jj & 3)] = gb[0];
                    gb8[2 * (jj & 3) + 1] = gb[1];
                    if ((jj & 3) == 3) add_cols8(sum_at(1, p, jj), gb8, g);
                }
            });
            wd::publish(act, tid);   // also: silu'(u) is read before cot_u replaces it

            // cot_pre = (cot_u @ W_e2^T) * silu'(pre); cot_d2 = cot_pre . w_d per row
            float sd[2] = {0.f, 0.f};
            wd::consume<PASSES, CB>(ring, split, sq, full, empty, rp, hd, wg, tid, lane, acc, tmp0,
                                    tmp1, sml,
                                    copy_to(cotu_i), [&](int p, float (&ac)[ACC]) {
                float gd8[8];
#pragma unroll
                for (int jj = 0; jj < NW / 8; ++jj) {
                    const int col = col_of(p, jj);
                    const float2 wdv = __ldg(reinterpret_cast<const float2*>(w_d + col));
                    float gd[2] = {0.f, 0.f};
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        Act* q = at2(cotpre_i, rw + 8 * hh, col);
                        float cp[2] = {0.f, 0.f};
                        if (vr[hh] > 0.f) {
                            if constexpr (CB) {   // silu'(pre) from the fill; the pair in bf16x2
                                const s9::bf2 c2 = s9::mul2(s9::bf2r(ac[4 * jj + 2 * hh],
                                                                    ac[4 * jj + 2 * hh + 1]),
                                                           *reinterpret_cast<const s9::bf2*>(q));
                                // cot_d2: an fp32 sum of the bf16 products cot_pre w_d
                                const float2 cf = s9::f2(c2), pd = s9::f2(s9::mul2(c2, s9::bf2r(wdv.x, wdv.y)));
                                cp[0] = cf.x;
                                cp[1] = cf.y;
                                sd[hh] += pd.x;
                                sd[hh] += pd.y;
                            } else {
                                const float2 ds = *reinterpret_cast<const float2*>(q);   // silu'(pre), from the fill
#pragma unroll
                                for (int c = 0; c < 2; ++c) {
                                    cp[c] = ac[4 * jj + 2 * hh + c] * (c ? ds.y : ds.x);
                                    sd[hh] = fmaf(cp[c], c ? wdv.y : wdv.x, sd[hh]);
                                }
                            }
#pragma unroll
                            for (int c = 0; c < 2; ++c) gd[c] += cp[c] * d2r[hh];   // w_d grad
                        }
                        if constexpr (CB)   // read by the node pass
                            *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(cp[0], cp[1]);
                        else
                            __stcs(reinterpret_cast<float2*>(q), make_float2(cp[0], cp[1]));
                    }
                    gd8[2 * (jj & 3)] = gd[0];
                    gd8[2 * (jj & 3) + 1] = gd[1];
                    if ((jj & 3) == 3) add_cols8(sum_at(0, p, jj), gd8, g);
                }
            });
            const float cd2[2] = {quad_sum(sd[0]), quad_sum(sd[1])};
            if (wg == 1 && tq == 0) {
                part_cd2[rw] = cd2[0];
                part_cd2[rw + 8] = cd2[1];
            }
            s9::named_sync(wd::BAR_C, wd::CT);
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
        s9::named_sync(wd::BAR_C, wd::CT);
        float* red_cw = reinterpret_cast<float*>(sm + LY::RING);   // [256]: the ring is idle
        red_cw[tid] = cw_sum;
        s9::named_sync(wd::BAR_C, wd::CT);
        const float* all_cols = s.cols + (size_t)blockIdx.x * cols_per_block(hd);
        float* vp = s.vpart + (size_t)blockIdx.x * vpart_stride(hd);
        for (int k = tid; k < NVEC * hd; k += wd::CT) {
            const int v = k / hd, c = k % hd;
            const int con = (c % C::NC) / NW, lc = (c / C::NC) * NW + c % NW;
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                sum += __ldcg(all_cols + ((size_t)(con * 4 + q) * NVEC + v) * half + lc);
            vp[k] = sum;
        }
        if (tid == 0) {
            float v = 0.f;
            for (int q = 0; q < wd::CT; ++q) v += red_cw[q];
            vp[NVEC * hd] = v;
        }
    }
}

// Split-K weight grads on wgmma (egnn_band_bwd_sm90_hd512.cu's
// egnn_wgrad_sm90_hd512 at a run-time width): part[z][sl] = X_z^T @ Y_z over
// the valid steps of slice sl (z = 0: (m1, cot_u) -> dW_e2, z = 1: (m,
// cot_v) -> dW_x1), a block per 64 x 64 output tile (rows m0.., columns
// n0..): X's and Y's feature rows of one 32-row K block are contiguous in
// the [2][hd][32] layout, one bulk copy each.
struct WgradLayout {
    static constexpr int X_BYTES = 64 * s9::KB * 4;              // the m64 operand
    static constexpr int Y_BYTES = WGRAD_TN * s9::KB * 4;
    static constexpr int STAGE = X_BYTES + Y_BYTES;              // X, Y
    static constexpr int SPLIT = WSTAGES * STAGE;                // [2][Xs, Ys] (3xTF32)
    template <int PASSES>
    __host__ __device__ static constexpr int bars() { return SPLIT + (PASSES == 3 ? 2 * STAGE : 0); }
    template <int PASSES>
    static constexpr size_t smem(int per) {
        return bars<PASSES>() + 2 * WSTAGES * 8 + sizeof(int) * per + 1024;
    }
};

template <int PASSES, bool CB>
__global__ void __launch_bounds__(WGRAD_THREADS, 2)
egnn_wgrad_sm90_wide(const float* __restrict__ x0, const float* __restrict__ y0,
                     const float* __restrict__ x1, const float* __restrict__ y1,
                     const int* __restrict__ flags, float* __restrict__ part, int items,
                     int nsplit, int hd) {
    using LY = WgradLayout;
    constexpr int TN = WGRAD_TN, ACC = TN / 2;   // m64nTN fp32 accumulator floats per thread
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::bars<PASSES>());
    uint64_t* empty = full + WSTAGES;
    int* list = reinterpret_cast<int*>(full + 2 * WSTAGES);
    float* split = reinterpret_cast<float*>(sm + LY::SPLIT);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tiles_n = hd / TN;
    const int m0 = (blockIdx.x / tiles_n) * 64, n0 = (blockIdx.x % tiles_n) * TN;
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
                const size_t base = CB ? (size_t)list[q] * M * hd / 2
                                       : (size_t)list[q / 2] * M * hd + (size_t)(q % 2) * s9::KB * hd;
                float* st = reinterpret_cast<float*>(sm + rp.stage * LY::STAGE);
                s9::mbar_wait(&empty[rp.stage], rp.phase ^ 1u);
                s9::mbar_expect_tx(&full[rp.stage], LY::STAGE);
                s9::bulk_load(st, X + base + (size_t)m0 * s9::KB, LY::X_BYTES, &full[rp.stage]);
                s9::bulk_load(st + LY::X_BYTES / 4, Y + base + (size_t)n0 * s9::KB, LY::Y_BYTES,
                              &full[rp.stage]);
                rp.next<WSTAGES>();
            }
        }
        return;
    }
    constexpr int SPAN = WGRAD_SPAN<PASSES>, NSUM = s9::KB / SPAN;   // step sums a chunk
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

    float* out = part + ((size_t)z * nsplit + sl) * hd * hd;
    const int g = lane / 4, tq = lane % 4;
#pragma unroll
    for (int jj = 0; jj < TN / 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int i = m0 + 16 * warp + g + 8 * hh;
            *reinterpret_cast<float2*>(out + (size_t)i * hd + n0 + 8 * jj + 2 * tq) =
                make_float2(sum[4 * jj + 2 * hh], sum[4 * jj + 2 * hh + 1]);
        }
}

template <int PASSES, class In, bool CB>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const float* const* w, const float* g_agg, const float* g_delta, In* da,
                   In* dbs, float* dx, float* dw_e2, float* dw_x1, float* dvec, float* scratch,
                   int B, int L, int hd, int W, int G, int nsplit, cudaStream_t stream) {
    using C = wd::Cfg<PASSES>;
    using Act = typename std::conditional<CB, __nv_bfloat16, float>::type;
    if (hd <= 512 || hd % WIDE_GROUP || G < 1 || nsplit < 1 || !scratch)
        return cudaErrorInvalidValue;
    Scratch s;
    scratch_floats(B, L, hd, W, G, nsplit, CB ? 0 : PASSES, &s, scratch);
    const int items = n_items(B, L, W);
    // x @ W_e2, x @ W_x1 (the recomputed products), x @ W_x1^T, x @ W_e2^T
    // (the cotangents), each as Wb (and Ws), or as its bf16 image
    const float* srcs[4] = {w[1], w[3], w[3], w[1]};
    const int orients[4] = {s9::IMG_T, s9::IMG_T, s9::IMG_N, s9::IMG_N};
    cudaError_t err;
    if constexpr (CB) {
        const s9::Bf16ImageSet set{{srcs[0], srcs[1], srcs[2], srcs[3]},
                                   {orients[0], orients[1], orients[2], orients[3]}, 4, hd, C::NC,
                                   1, 1};
        err = s9::launch_images_bf16(set, s.img, stream);
    } else {
        wd::WideImageSet set{};
        for (int q = 0; q < 4; ++q)
            for (int p = 0; p < C::PARTS; ++p) {
                set.src[set.n] = srcs[q];
                set.orient[set.n] = orients[q];
                set.part[set.n++] = p;
            }
        err = wd::launch_images_wide(set, hd, C::NC, s.img, stream);
    }
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(s.cols, 0, sizeof(float) * G * cols_per_block(hd), stream);
    if (err != cudaSuccess) return err;
    auto edges = egnn_bwd_edges_sm90_wide<PASSES, In, CB>;
    err = cudaFuncSetAttribute(edges, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               EdgeLayout<PASSES>::SMEM);
    if (err != cudaSuccess) return err;
    edges<<<G, s9::THREADS, EdgeLayout<PASSES>::SMEM, stream>>>(
        a, bs, x, cmask, w[0], w[2], w[4], w[5], w[6], g_agg, g_delta, s, B, L, hd, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    egnn_bwd_nodes<In, Act><<<dim3(L, B), egnn::THREADS, 2 * 2 * W * sizeof(int), stream>>>(
        reinterpret_cast<const Act*>(s.cotpre), s.drel, s.flags, da, dbs, dx, L, hd, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int per = (items + nsplit - 1) / nsplit;
    const size_t wsmem = WgradLayout::smem<PASSES>(per);
    auto wgrad = egnn_wgrad_sm90_wide<PASSES, CB>;
    err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
    if (err != cudaSuccess) return err;
    const dim3 wgrid((hd / 64) * (hd / WGRAD_TN), nsplit, 2);
    wgrad<<<wgrid, WGRAD_THREADS, wsmem, stream>>>(s.m1, s.cotu, s.mm, s.cotv, s.flags, s.wpart,
                                                   items, nsplit, hd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t n_out = 2 * (size_t)hd * hd + NVEC * hd + 1;
    egnn_bwd_reduce<<<(unsigned)((n_out + egnn::THREADS - 1) / egnn::THREADS), egnn::THREADS, 0,
                      stream>>>(s.wpart, s.vpart, dw_e2, dw_x1, dvec, hd, G, nsplit);
    return cudaGetLastError();
}

// f(Int<PASSES>{}, Type<In>{}, std::bool_constant<CB>{}) for 1 or 3 passes,
// or 0 (the bf16 chain: one bf16 pass, CB), and the input type.
template <class F>
cudaError_t dispatch(int passes, int bf16_in, F&& f) {
    auto by_in = [&](auto p, auto cb) -> cudaError_t {
        return bf16_in ? f(p, Type<__nv_bfloat16>{}, cb) : f(p, Type<float>{}, cb);
    };
    if (passes == 0) return by_in(Int<1>{}, std::true_type{});
    if (passes == 1) return by_in(Int<1>{}, std::false_type{});
    if (passes == 3) return by_in(Int<3>{}, std::false_type{});
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Floats of scratch one call needs (the caller allocates it), at width hd,
// for G edge-pass blocks, nsplit weight-grad slices and passes (1 or 3).
size_t egnn_band_bwd_sm90_wide_scratch_floats(int B, int L, int hd, int W, int G, int nsplit,
                                              int passes) {
    Scratch s;
    return scratch_floats(B, L, hd, W, G, nsplit, passes, &s, nullptr);
}

// Edge-pass blocks that one SM holds, or a negative CUDA error code.
int egnn_band_bwd_sm90_wide_blocks_per_sm(int bf16_in, int passes) {
    int n = 0;
    const cudaError_t err = dispatch(passes, bf16_in, [&](auto p_c, auto in_c, auto cb_c) {
        constexpr int PASSES = decltype(p_c)::value;
        auto kernel = egnn_bwd_edges_sm90_wide<PASSES, typename decltype(in_c)::type,
                                               decltype(cb_c)::value>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             EdgeLayout<PASSES>::SMEM);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, s9::THREADS,
                                                             EdgeLayout<PASSES>::SMEM);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch the four passes on `stream`; returns the CUDA error code (0 =
// success). As egnn_band_bwd_sm90_hd512_launch, at hd > 512 a multiple of
// 256, passes 1 or 3, or 0 (the bf16 chain); scratch as sized above.
int egnn_band_bwd_sm90_wide_launch(const void* a, const void* bs, const float* x,
                                   const float* cmask, const float* w_d, const float* w_e2,
                                   const float* b_e2, const float* w_x1, const float* b_x1,
                                   const float* w_x2, const float* b_x2, const float* g_agg,
                                   const float* g_delta, void* da, void* dbs, float* dx,
                                   float* dw_e2, float* dw_x1, float* dvec, float* scratch, int B,
                                   int L, int hd, int W, int G, int nsplit, int bf16_in,
                                   int passes, void* stream) {
    const float* w[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(passes, bf16_in, [&](auto p_c, auto in_c, auto cb_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(p_c)::value, In, decltype(cb_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, w, g_agg, g_delta,
            static_cast<In*>(da), static_cast<In*>(dbs), dx, dw_e2, dw_x1, dvec, scratch, B, L,
            hd, W, G, nsplit, s);
    });
}

const char* egnn_band_bwd_sm90_wide_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
