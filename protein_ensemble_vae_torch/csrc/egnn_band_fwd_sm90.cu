// EGNN band forward on Hopper (sm_90a) at the native widths 32 to 256 in
// the one-pass fp32-chain mode (the JAX side's precision=None, a bf16
// model) and in the bf16 chain (chain_dtype=bfloat16, CB); bf16 or fp32
// a / bs. 3xTF32 at these widths runs on egnn_band_fwd_sm90_hd512.cu, the
// widths above on it and on egnn_band_fwd_sm90_wide.cu.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/egnn_band.py (egnn_band.py:107, entered through
// `egnn_band_fused`): for receiver i and band offset d = j - i in
// [-W, W] \ {0},
//     pre  = a_i + bs_j + |x_i - x_j|^2 * w_d
//     m    = silu(silu(pre) @ W_e2 + b_e2)
//     agg_i       = sum_d valid * m
//     raw_delta_i = sum_d valid * (silu(m @ W_x1 + b_x1) . w_x2 + b_x2) * (x_i - x_j)
// with each product's operands rounded to TF32 (cvt.rna's rounding) and
// summed in fp32, as egnn_band_fwd.cu's one-pass mode. In the bf16 chain
// the chain rounds where the JAX kernel does (egnn_sm90.cuh: "the bf16
// chain"): bf16 tile, bf16 weight images, bf16 wgmma (m64nNk16), each
// product's fp32 sum rounded once, every elementwise result rounded to
// bf16, agg and raw_delta summed in fp32.
//
// What bounds it: operations. Two Hd x Hd products per valid edge, 4 Hd^2
// FLOP, at the TF32 tensor-core rate (495 TFLOP/s): 0.036 ms at the
// flagship's B8/L128; at the bf16 rate (989 TFLOP/s) half that in the bf16
// chain, whose weight images are half the bytes. The weights are the other floor: 512 KiB of W_e2 and
// W_x1 (Hd 256) cannot stay in shared memory, so each weight pass streams
// them from L2. egnn_band_fwd.cu streamed them once per 64-row step through
// 8-row cp.async chunks with a block barrier before each (640 MiB of L2
// reads per launch at B8/L128, 64 barriers a step) into register-fed
// mma.sync at a third of that instruction's rate.
//
// Design (egnn_sm90.cuh holds the building blocks):
// - A block is one producer warpgroup (one working warp) and two consumer
//   warpgroups; a persistent grid of one block per SM walks work units
//   (batch row, tile of T = 8 receivers, slice of the band steps), unit
//   g, g + G, ... Each unit's steps go in pairs, one 64-edge-row step per
//   consumer warpgroup (row r = (offset slot r / 8, receiver r % 8)).
// - The producer streams W_e2's and then W_x1's image through a ring of
//   STAGES chunks (NW output rows x 32 K values, 16 KiB at Hd 256) with
//   cp.async.bulk under full / empty mbarriers; both consumers read every
//   chunk, so one weight pass serves 128 edge rows, half the L2 traffic
//   per row of egnn_band_fwd.cu, and only mbarriers wait in the product
//   loop. A pair with no valid edge is skipped by all three (each
//   computes the same validity); a consumer whose own step has none walks
//   the chunks and releases them unread.
// - Each consumer keeps its step's activation tile A [64][Hd] (K-major,
//   128-byte swizzle) in shared memory: silu(pre), then m, each rounded to
//   TF32 when written and fenced to the async proxy before wgmma reads
//   it. Products are m64nNWk8 wgmma from shared memory into fp32
//   accumulators; the chain's elementwise work (biases, silu, the w_x2 row
//   dot product, a quad shuffle sum since a warp holds whole rows) runs on
//   the accumulators.
// - A lane's two accumulator rows belong to receiver g, so agg sums in
//   registers over the unit's steps; at the unit's end the eight consumer
//   warps' sums meet in shared memory (the A tiles) and are added in warp
//   order: no atomics, two launches bitwise identical. With S > 1 slices a
//   unit writes its slice's partial and egnn_band_fwd_sum adds the S
//   partials in slice order.
// - Registers: setmaxnreg gives the consumers 232 (the m64n256 fp32
//   accumulator is 128 per thread, agg Hd / 4 more), the producer 40.
// - silu in the fast exponential and division (egnn_sm90.cuh: silu_fast).
// - Weight images (IMG_T, egnn_sm90.cuh) are written per call by
//   weight_images from this file's C entry, into scratch the wrapper
//   allocates.
//
// - The bf16 chain: the same block, ring and protocol; the tiles hold bf16
//   (egnn_sm90.cuh: "the bf16 chain"; at Hd 32 a 128-byte row is half used
//   and two k16 steps of four run), the fill and the epilogues round
//   as the JAX kernel on column pairs (bf16x2 add / mul, exp and the
//   reciprocal in fp32: an epilogue's work about the one-pass mode's, where
//   ~26 scalar fp32 <-> bf16 conversions an element had made kernel 1 2.6x
//   slower, PERF.md), and the unit's sums, which need the fp32 [8][T][Hd +
//   3], get an A region of that size where the bf16 tiles are smaller.
//
// Shared memory per block (bytes; + 1 KiB alignment slack):
//   Hd | A tiles (2 x 64 x Hd x 4) | ring (STAGES x NW x 128) | rows, flags, barriers | total
//   32 |  16,384 |  20,480 | 3,184 |  41,072
//   64 |  32,768 |  40,960 | 3,184 |  77,936
//  128 |  65,536 |  81,920 | 3,184 | 151,664
//  256 | 131,072 |  81,920 | 3,184 | 217,200  (of 232,448)
// and in the bf16 chain (A region: the bf16 tiles, 2 x 64 x max(Hd / 2, 32)
// x 4, or the unit's sums, 8 x T x (Hd + 3) x 4, 1 KiB-aligned):
//   Hd | A region | ring | rows, flags, barriers | total
//   32 |  16,384 |  20,480 | 3,184 |  41,072  (bf16)
//   64 |  17,408 |  40,960 | 3,184 |  62,576  (bf16)
//  128 |  33,792 |  81,920 | 3,184 | 119,920  (bf16)
//  256 |  66,560 |  81,920 | 3,184 | 152,688  (bf16)

#include "egnn_passes.cuh"
#include "egnn_sm90.cuh"

namespace {

using namespace egnn;
namespace s9 = egnn::sm90;

constexpr int STAGES = 5;    // ring depth (chunks)

template <int HD, bool CB = false>
struct FwdLayout {
    using C = s9::Cols<HD, CB>;
    static constexpr int A_BYTES = M * C::KW * 4;              // one consumer's tile
    static constexpr int RED_BYTES = (8 * T * (HD + 3) * 4 + 1023) / 1024 * 1024;   // the unit's sums
    static constexpr int A = 0;                                // [2][64][KW]
    static constexpr int RING = A + (2 * A_BYTES > RED_BYTES ? 2 * A_BYTES : RED_BYTES);
    static constexpr int ROW_FLOATS = 6 * M;                   // valid, d2, j, rel[3]
    static constexpr int ROWS = RING + STAGES * C::CHUNK * 4;  // [2][ROW_FLOATS]
    static constexpr int FLAGS = ROWS + 2 * ROW_FLOATS * 4;    // int [2][4]
    static constexpr int BARS = FLAGS + 2 * 4 * 4;             // full[STAGES], empty[STAGES]
    static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
    static_assert(SMEM <= 232448, "shared memory of one block");
    static_assert(CB || 8 * T * (HD + 3) * 4 <= 2 * A_BYTES, "the unit's sums fit in the A tiles");
};

// Words of one weight image in the mode.
template <int HD, bool CB>
constexpr size_t IMG_WORDS = CB ? s9::image_words_bf16(HD) : (size_t)HD * HD;

template <int HD, class In, bool CB>
__global__ void __launch_bounds__(s9::THREADS, 1)
egnn_fwd_sm90(const In* __restrict__ a, const In* __restrict__ bs, const float* __restrict__ x,
              const float* __restrict__ cmask, const float* __restrict__ w_d,
              const float* __restrict__ b_e2, const float* __restrict__ b_x1,
              const float* __restrict__ w_x2, const float* __restrict__ b_x2,
              const float* __restrict__ img, float* __restrict__ agg, float* __restrict__ delta,
              int B, int L, int W, int S, int pairs_per_slice) {
    using C = s9::Cols<HD>;
    using LY = FwdLayout<HD, CB>;
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    float* ring = reinterpret_cast<float*>(sm + LY::RING);
    int* flags = reinterpret_cast<int*>(sm + LY::FLAGS);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BARS);
    uint64_t* empty = full + STAGES;
    const int tid = threadIdx.x, wg = tid / s9::WG, lane = tid % 32;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            s9::mbar_init(&full[s], 1);
            s9::mbar_init(&empty[s], s9::EMPTY_ARRIVALS);
        }
        s9::fence_mbar_init();
    }
    __syncthreads();

    const int n_steps = (2 * W + OPS - 1) / OPS, n_pairs = (n_steps + 1) / 2;
    const int n_tiles = (L + T - 1) / T, units = B * n_tiles * S;

    if (wg == s9::CONSUMERS) {   // the producer warpgroup: its first warp streams the weights
        s9::setmaxnreg_dec<s9::PRODUCER_REGS>();
        if (tid % s9::WG < 32) {
            s9::RingPos rp;
            for (int u = blockIdx.x; u < units; u += gridDim.x) {
                const int sl = u % S, i0 = ((u / S) % n_tiles) * T, b = u / (S * n_tiles);
                const size_t row0 = (size_t)b * L;
                const int p1 = min(n_pairs, (sl + 1) * pairs_per_slice);
                for (int p = sl * pairs_per_slice; p < p1; ++p) {
                    bool v = false;
                    for (int r = lane; r < 2 * M; r += 32) {
                        int i, j;
                        v |= s9::edge_row(cmask, row0, i0, 2 * p + r / M, r % M, L, W, i, j);
                    }
                    if (!__any_sync(0xffffffffu, v)) continue;   // the consumers skip it too
                    if (lane == 0) {
                        s9::produce<HD, STAGES, CB>(img, ring, full, empty, rp);
                        s9::produce<HD, STAGES, CB>(img + IMG_WORDS<HD, CB>, ring, full, empty, rp);
                    }
                    __syncwarp();
                }
            }
        }
    } else {   // the consumer warpgroups
        s9::setmaxnreg_inc<s9::CONSUMER_REGS>();
        float* A = reinterpret_cast<float*>(sm + LY::A + wg * LY::A_BYTES);
        float* row_valid = reinterpret_cast<float*>(sm + LY::ROWS) + wg * LY::ROW_FLOATS;
        float* row_d2 = row_valid + M;
        int* row_j = reinterpret_cast<int*>(row_valid + 2 * M);
        float* row_rel = row_valid + 3 * M;
        const int t = tid % s9::WG, warp = t / 32, g = lane / 4, tq = lane % 4;
        const int bar = 1 + wg;                 // this warpgroup's named barrier
        constexpr int BAR_ALL = 3;              // both consumer warpgroups
        const float bx2 = CB ? rbf(b_x2[0]) : b_x2[0];
        s9::RingPos rp;
        float acc[C::NH][C::ACC];
        float agg_r[C::NH][C::NW / 8][2];   // receiver g, the lane's columns
        float delta_r[3];                    // tq == 0: receiver g

        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            const int sl = u % S, i0 = ((u / S) % n_tiles) * T, b = u / (S * n_tiles);
            const size_t row0 = (size_t)b * L;
            const In* a_b = a + row0 * HD;
            const In* bs_b = bs + row0 * HD;
            const int p1 = min(n_pairs, (sl + 1) * pairs_per_slice);
#pragma unroll
            for (int h = 0; h < C::NH; ++h)
#pragma unroll
                for (int jj = 0; jj < C::NW / 8; ++jj) agg_r[h][jj][0] = agg_r[h][jj][1] = 0.f;
            delta_r[0] = delta_r[1] = delta_r[2] = 0.f;

            for (int p = sl * pairs_per_slice; p < p1; ++p) {
                s9::named_sync(bar, s9::WG);   // the last step's rows, flags and A are consumed
                {   // thread t checks row t % M of step 2p + t / M; the own step keeps its rows
                    const int r = t % M;
                    int i, j;
                    const bool v = s9::edge_row(cmask, row0, i0, 2 * p + t / M, r, L, W, i, j);
                    if (t / M == wg) {
                        float rel[3] = {0.f, 0.f, 0.f}, d2 = 0.f;
                        if (v) {
#pragma unroll
                            for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                            d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                        }
                        row_valid[r] = v ? 1.f : 0.f;
                        row_d2[r] = d2;
                        row_j[r] = j;
#pragma unroll
                        for (int c = 0; c < 3; ++c) row_rel[r * 3 + c] = rel[c];
                    }
                    const unsigned any = __ballot_sync(0xffffffffu, v);
                    if (lane == 0) flags[wg * 4 + warp] = any != 0u;
                }
                s9::named_sync(bar, s9::WG);
                const int* fl = flags + wg * 4;
                const bool v0 = fl[0] | fl[1], v1 = fl[2] | fl[3];
                if (!v0 && !v1) continue;            // no valid edge in the pair: skipped by all
                if (!(wg ? v1 : v0)) {               // none in this step: release the chunks unread
                    s9::pass_product<HD, STAGES, CB>(full, empty, rp, lane);
                    s9::pass_product<HD, STAGES, CB>(full, empty, rp, lane);
                    continue;
                }

                // A = silu(a_i + bs_j + d2 * w_d) in TF32 (or the bf16 chain's
                // rounding); rows of invalid edges 0
                if constexpr (CB)
                    s9::fill_pre_bf16<In, s9::WG>(A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0,
                                                  HD, t);
                else
                    s9::fill_pre<HD>(A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, t);
                s9::fence_async_smem();
                s9::named_sync(bar, s9::WG);

                // m = silu(A @ W_e2 + b_e2); agg += valid * m; A = m
                s9::product<HD, STAGES, CB>(A, ring, full, empty, rp, acc, lane);
                s9::named_sync(bar, s9::WG);   // every warp's products have read A
                const float vr[2] = {row_valid[16 * warp + g], row_valid[16 * warp + 8 + g]};
#pragma unroll
                for (int h = 0; h < C::NH; ++h)
#pragma unroll
                    for (int jj = 0; jj < C::NW / 8; ++jj) {
                        const int col = h * C::NW + 8 * jj + 2 * tq;
                        const float2 be = __ldg(reinterpret_cast<const float2*>(b_e2 + col));
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const int row = 16 * warp + g + 8 * hh;
                            float m0, m1;
                            if constexpr (CB) {   // the column pair in bf16x2
                                const s9::bf2 u = s9::bias2(acc[h][4 * jj + 2 * hh],
                                                            acc[h][4 * jj + 2 * hh + 1],
                                                            s9::bf2r(be.x, be.y));
                                const s9::bf2 m = s9::silu2(u, s9::sigmoid2(u));
                                s9::put2_bf16(A, row, col, m);
                                const float2 mf = s9::f2(m);
                                m0 = mf.x;
                                m1 = mf.y;
                            } else {
                                m0 = s9::silu_fast(acc[h][4 * jj + 2 * hh] + be.x);
                                m1 = s9::silu_fast(acc[h][4 * jj + 2 * hh + 1] + be.y);
                                *reinterpret_cast<float2*>(A + s9::sw_off(row, col, M)) =
                                    make_float2(s9::tf32(m0), s9::tf32(m1));
                            }
                            if (vr[hh] > 0.f) {
                                agg_r[h][jj][0] += m0;
                                agg_r[h][jj][1] += m1;
                            }
                        }
                    }
                s9::fence_async_smem();
                s9::named_sync(bar, s9::WG);

                // wsc = silu(m @ W_x1 + b_x1) . w_x2 + b_x2 per row (in the bf16
                // chain the dot product's fp32 sum rounded once); delta_i += valid * wsc * rel
                s9::product<HD, STAGES, CB>(A, ring, full, empty, rp, acc, lane);
                float sw[2] = {0.f, 0.f};
#pragma unroll
                for (int h = 0; h < C::NH; ++h)
#pragma unroll
                    for (int jj = 0; jj < C::NW / 8; ++jj) {
                        const int col = h * C::NW + 8 * jj + 2 * tq;
                        const float2 bx = __ldg(reinterpret_cast<const float2*>(b_x1 + col));
                        const float2 wx = __ldg(reinterpret_cast<const float2*>(w_x2 + col));
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const float v0 = acc[h][4 * jj + 2 * hh], v1 = acc[h][4 * jj + 2 * hh + 1];
                            if constexpr (CB) {   // the column pair in bf16x2
                                const s9::bf2 v = s9::bias2(v0, v1, s9::bf2r(bx.x, bx.y));
                                const float2 w1 = s9::f2(s9::silu2(v, s9::sigmoid2(v)));
                                const float2 w2 = s9::f2(s9::bf2r(wx.x, wx.y));
                                sw[hh] = fmaf(w1.y, w2.y, fmaf(w1.x, w2.x, sw[hh]));
                            } else {
                                sw[hh] = fmaf(s9::silu_fast(v0 + bx.x), wx.x, sw[hh]);
                                sw[hh] = fmaf(s9::silu_fast(v1 + bx.y), wx.y, sw[hh]);
                            }
                        }
                    }
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const float s = quad_sum(sw[hh]);
                    const float wsc = CB ? rbf(rbf(s) + bx2) : s + bx2;
                    const int row = 16 * warp + g + 8 * hh;
                    if (tq == 0 && vr[hh] > 0.f) {
#pragma unroll
                        for (int c = 0; c < 3; ++c) delta_r[c] += wsc * row_rel[row * 3 + c];
                    }
                }
            }

            // The unit's sums: the eight consumer warps' partials through the A
            // tiles, added in warp order.
            s9::named_sync(BAR_ALL, s9::CONSUMERS * s9::WG);
            float* red = reinterpret_cast<float*>(sm + LY::A);   // [8][T][HD], then [8][T][3]
            float* red_d = red + 8 * T * HD;
            const int w8 = wg * 4 + warp;
#pragma unroll
            for (int h = 0; h < C::NH; ++h)
#pragma unroll
                for (int jj = 0; jj < C::NW / 8; ++jj)
                    *reinterpret_cast<float2*>(red + (w8 * T + g) * HD + h * C::NW + 8 * jj + 2 * tq) =
                        make_float2(agg_r[h][jj][0], agg_r[h][jj][1]);
            if (tq == 0) {
#pragma unroll
                for (int c = 0; c < 3; ++c) red_d[(w8 * T + g) * 3 + c] = delta_r[c];
            }
            s9::named_sync(BAR_ALL, s9::CONSUMERS * s9::WG);
            float* agg_u = agg + (size_t)sl * B * L * HD;    // slice sl's partial (S > 1), or agg
            float* delta_u = delta + (size_t)sl * B * L * 3;
            const int ct = tid;   // 0 .. 255
            for (int k = ct; k < T * HD; k += s9::CONSUMERS * s9::WG) {
                const int rr = k / HD, col = k % HD;
                float s = 0.f;
#pragma unroll
                for (int q = 0; q < 8; ++q) s += red[(q * T + rr) * HD + col];
                if (i0 + rr < L) agg_u[(row0 + i0 + rr) * HD + col] = s;
            }
            if (ct < 3 * T) {
                const int rr = ct / 3, c = ct % 3;
                float s = 0.f;
#pragma unroll
                for (int q = 0; q < 8; ++q) s += red_d[(q * T + rr) * 3 + c];
                if (i0 + rr < L) delta_u[(row0 + i0 + rr) * 3 + c] = s;
            }
            s9::named_sync(BAR_ALL, s9::CONSUMERS * s9::WG);   // sums read before A is rewritten
        }
    }
}

template <int HD, class In, bool CB>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const float* const* w, float* img, float* agg, float* delta, float* part_agg,
                   float* part_delta, int B, int L, int W, int S, int G, cudaStream_t stream) {
    using LY = FwdLayout<HD, CB>;
    const int n_pairs = ((2 * W + OPS - 1) / OPS + 1) / 2;
    const int per = (n_pairs + S - 1) / S;
    if (S < 1 || G < 1 || (S - 1) * per >= n_pairs || !img || (S > 1 && (!part_agg || !part_delta)))
        return cudaErrorInvalidValue;   // every slice must own at least one pair
    cudaError_t err;
    if constexpr (CB) {
        const s9::Bf16ImageSet set{{w[1], w[3]}, {s9::IMG_T, s9::IMG_T}, 2, HD, s9::Cols<HD>::NW, 1, 0};
        err = s9::launch_images_bf16(set, img, stream);
    } else {
        const s9::ImageSet set{{w[1], w[3], nullptr, nullptr}, {s9::IMG_T, s9::IMG_T, 0, 0}, 2};
        err = s9::launch_images<HD>(set, img, stream);
    }
    if (err != cudaSuccess) return err;
    auto kernel = egnn_fwd_sm90<HD, In, CB>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LY::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G, s9::THREADS, LY::SMEM, stream>>>(
        a, bs, x, cmask, w[0], w[2], w[4], w[5], w[6], img, S > 1 ? part_agg : agg,
        S > 1 ? part_delta : delta, B, L, W, S, per);
    if ((err = cudaGetLastError()) != cudaSuccess || S == 1) return err;
    const size_t n_agg4 = (size_t)B * L * HD / 4, n_delta = (size_t)B * L * 3;
    const size_t blocks = (n_agg4 + n_delta + egnn::THREADS - 1) / egnn::THREADS;
    egnn_band_fwd_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), egnn::THREADS, 0, stream>>>(
        part_agg, part_delta, agg, delta, n_agg4, n_delta, S);
    return cudaGetLastError();
}

// f(Int<HD>{}, Type<In>{}, std::bool_constant<CB>{}) for a width of 32 to 256, the input
// type and the mode: passes 1 (the one-pass fp32 chain) or 0 (the bf16
// chain); cudaErrorInvalidValue otherwise.
template <class F>
cudaError_t dispatch(int hd, int bf16_in, int passes, F&& f) {
    if (passes != 0 && passes != 1) return cudaErrorInvalidValue;
    return s9::dispatch(hd, bf16_in, [&](auto hd_c, auto in_c) {
        return passes ? f(hd_c, in_c, std::false_type{}) : f(hd_c, in_c, std::true_type{});
    });
}

}  // namespace

extern "C" {

// Blocks of the kernel at width hd (32..256) in the mode (passes 1, or 0 =
// the bf16 chain) that one SM holds, or a negative CUDA error code.
int egnn_band_fwd_sm90_blocks_per_sm(int hd, int bf16_in, int passes) {
    int n = 0;
    const cudaError_t err = dispatch(hd, bf16_in, passes, [&](auto hd_c, auto in_c, auto cb_c) {
        constexpr int HD = decltype(hd_c)::value;
        constexpr bool CB = decltype(cb_c)::value;
        auto kernel = egnn_fwd_sm90<HD, typename decltype(in_c)::type, CB>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             FwdLayout<HD, CB>::SMEM);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, s9::THREADS,
                                                             FwdLayout<HD, CB>::SMEM);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch on `stream`; returns the CUDA error code (0 = success). Device
// pointers to contiguous arrays, 16-byte aligned: a, bs [B, L, hd] (bf16
// when bf16_in, else fp32); x [B, L, 3], cmask [B, L]; the fp32 weights
// w_d, b_e2, b_x1, w_x2 [hd], w_e2, w_x1 [hd, hd] (in, out), b_x2 [1];
// img: 2 hd^2 floats of scratch for the weight images (2 x max(hd / 2, 32)
// x hd in the bf16 chain); agg [B, L, hd], delta
// [B, L, 3] fp32. S: slices of the band's step pairs; S > 1 needs part_agg
// [S, B, L, hd] and part_delta [S, B, L, 3], summed in slice order by a
// second kernel. G: blocks of the persistent grid. passes: 1 (the one-pass
// fp32 chain) or 0 (the bf16 chain).
int egnn_band_fwd_sm90_launch(const void* a, const void* bs, const float* x, const float* cmask,
                              const float* w_d, const float* w_e2, const float* b_e2,
                              const float* w_x1, const float* b_x1, const float* w_x2,
                              const float* b_x2, float* img, float* agg, float* delta,
                              float* part_agg, float* part_delta, int B, int L, int hd, int W,
                              int S, int G, int bf16_in, int passes, void* stream) {
    const float* w[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(hd, bf16_in, passes, [&](auto hd_c, auto in_c, auto cb_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(hd_c)::value, In, decltype(cb_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, w, img, agg, delta,
            part_agg, part_delta, B, L, W, S, G, s);
    });
}

// The bf16 weight images alone (the layout kernel of the bf16 chain), for a
// test against the wrapper's numpy mirror: n (1..4) images of the hd x hd
// srcs[q] in orientation orient[q] (0 = IMG_T, 1 = IMG_N), in chunks of nw
// rows x 64 K values, `halves` column parts, the chunk order hmajor, into
// img [n][max(hd / 2, 32) x hd] (4-byte words of two bf16).
int egnn_bf16_weight_images(const float* const* srcs, const int* orient, int n, int hd, int nw,
                            int halves, int hmajor, float* img, void* stream) {
    if (n < 1 || n > 4) return cudaErrorInvalidValue;
    s9::Bf16ImageSet set{};
    for (int q = 0; q < n; ++q) {
        set.src[q] = srcs[q];
        set.orient[q] = orient[q];
    }
    set.n = n;
    set.hd = hd;
    set.nw = nw;
    set.halves = halves;
    set.hmajor = hmajor;
    return s9::launch_images_bf16(set, img, static_cast<cudaStream_t>(stream));
}

// The weight images alone (the layout kernel), for a test against the
// wrapper's numpy mirror: n (1..4) images of srcs[q] in orientation
// orient[q] (0 = IMG_T, 1 = IMG_N) into img [n][hd * hd].
int egnn_sm90_weight_images(const float* const* srcs, const int* orient, int n, int hd,
                            float* img, void* stream) {
    if (n < 1 || n > 4) return cudaErrorInvalidValue;
    s9::ImageSet set{};
    for (int q = 0; q < n; ++q) {
        set.src[q] = srcs[q];
        set.orient[q] = orient[q];
    }
    set.n = n;
    return s9::dispatch(hd, 0, [&](auto hd_c, auto) {
        return s9::launch_images<decltype(hd_c)::value>(set, img, static_cast<cudaStream_t>(stream));
    });
}

const char* egnn_band_fwd_sm90_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
