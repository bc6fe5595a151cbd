// EGNN band forward on Hopper (sm_90a), the shared-tile kernel: at the
// native width 512 (every decoder width from 257 to 512 runs here,
// zero-padded to it) in the fp32 model's mode (precision="highest": 3xTF32
// products, the fp32 chain), the bf16 model's one-pass mode
// (precision="default") and the bf16 chain (chain_dtype=bfloat16, CB), and
// at the native widths 32 to 256 (and the widths padded to them) in the fp32
// model's 3xTF32 mode; fp32 or bf16 a / bs. The one-pass mode and the bf16
// chain up to 256 run on egnn_band_fwd_sm90.cu, the widths above 512 on
// egnn_band_fwd_sm90_wide.cu.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/egnn_band.py (egnn_band.py:107): the function of
// egnn_band_fwd_sm90.cu's header, with each product's operands rounded to
// TF32 and summed in fp32 (one pass), or in three TF32 passes (PASSES = 3,
// egnn_sm90.cuh: Half).
//
// What bounds it: operations, 4 Hd^2 FLOP per valid edge: at B4/L256 0.154
// ms at Hd 512 and 0.039 ms at Hd 256 in one TF32 pass, three times that in
// 3xTF32. The weights are a floor of their own: every 64-row step streams
// W_e2 and W_x1 (Hd^2 fp32 each) from L2, once per image: one image each in
// one pass, three (Ws, Wb, Wb) in 3xTF32 at 512, two (Ws, Wb) in 3xTF32 up
// to 256.
//
// Design (egnn_sm90.cuh holds the building blocks):
// - A block is a producer warpgroup and two consumer warpgroups; a
//   persistent grid of one block per SM walks work units (batch row, tile of
//   T = 8 receivers, slice of the band's 64-edge-row steps), unit g, g + G,
//   ... Row r of a step is (offset slot r / 8, receiver r % 8).
// - One activation tile A [64][Hd] (K-major, 128-byte swizzle) serves both
//   consumers: each computes its Hd / 2 output columns of every product
//   (m64nNWk8 wgmma), reading all of A. The epilogues write the next
//   activation into A by columns, so a barrier of both consumer warpgroups
//   comes after both have retired the product that reads it (the products
//   end in wgmma.wait_group 0) and before either writes, and the writes are
//   fenced to the async proxy before the next product.
// - Each consumer has its own ring of STAGES weight chunks (NW columns x 32
//   K: 3 x 16 KiB at 512, 6 x 8 KiB at 256), filled by its own producer
//   warp from its half of the image with cp.async.bulk under full / empty
//   mbarriers.
// - The w_x2 row dot product spans both halves: the second consumer's
//   partial sums meet the first's in shared memory, added in that order.
//   agg: A holds m exact (in one pass wgmma reads it truncated), and while
//   the W_x1 product runs each consumer thread adds its columns' valid rows
//   of A to its registers, over the unit's steps in order; delta's partials
//   meet in the A tile at the unit's end, added in warp order: no atomics,
//   two launches bitwise identical. With S > 1 slices a unit writes its
//   slice's partial and egnn_band_fwd_sum adds the S partials in slice
//   order.
// - 3xTF32 at 512: the products' chunks stream in the h-major order (a
//   column group's K blocks in turn), each 128 K summed apart and added to
//   the accumulators in round-to-nearest fp32 (egnn_sm90.cuh:
//   product_hmajor), the tile rewritten in place as its small part between
//   the second and third pass (product_half).
// - 3xTF32 up to 256: the split tile As = tf32_lo(A) lies beside A, written
//   by the same epilogue (and fill), so no pass rewrites the tile and no
//   barrier waits for a rewrite; each K block's Ws chunk and then its Wb
//   chunk stream (two images, not three), the Wb chunk serving A.Wb and
//   As.Wb (product_split), the big terms summed 32 K at a time and the
//   small terms in their own accumulator, added in round-to-nearest fp32.
//   The one-pass kernel's layout (egnn_band_fwd_sm90.cu: a tile per
//   consumer, each on its own step; here the split in registers for
//   wgmma's register-A form) was the other candidate: it halves the weight
//   stream, but its m64n256 accumulator (128 registers) leaves no room for
//   a step sum or a small-term accumulator under the consumers' 232, and
//   the split would cost a shared-memory load and split of every A
//   fragment per column group. The weight stream here is ~1.2 GB of L2
//   reads at B4/L256 (~0.075 ms at the L2 rate, under the 3xTF32
//   tensor-core bound of ~0.116 ms).
// - silu / sigmoid are the fast ones (__expf, __fdividef) in one pass and
//   in 3xTF32 up to 256 (the accurate ones took a third of this kernel's
//   time there, and its error is the accumulation's either way, PERF.md),
//   the accurate ones in 3xTF32 at 512.
// - A step with no valid edge is skipped by all three warpgroups.
// - Registers: setmaxnreg gives the consumers 232 (at 512 the two m64n128
//   accumulators 128 per thread, a step sum 64 in 3xTF32, agg 16; at 256
//   two m64n64 accumulators 64, a step sum and the small terms' 32 each,
//   agg 8), the producer 40.
// - Weight images (egnn_sm90.cuh: Half, image_value_half) are written per
//   call by weight_images_half from this file's C entry, into scratch the
//   wrapper allocates: Wb of W_e2 and W_x1, and in 3xTF32 also their Ws.
// - The bf16 chain at 512: the one-pass design with a bf16 tile (64 KiB),
//   bf16 images (weight_images_bf16, h-major halves), m64n128k16 products
//   and the JAX kernel's rounding in the fill and the epilogues
//   (egnn_sm90.cuh: "the bf16 chain"); the half-size tile leaves room for
//   BF16_STAGES chunks a ring.
//
// Shared memory per block (bytes; + 1 KiB alignment slack):
//   Hd  | A tile(s)          | rings (2 x STAGES x NW x 128)  | rows, part, flags, barriers | total
//   512 | 131,072 (one)      | 98,304 (3 stages, NW 128)      | 1,904 | 232,304  (of 232,448)
//   256 | 131,072 (A and As) | 98,304 (6 stages, NW 64)       | 2,000 | 232,400  (of 232,448)
//   128 |  65,536            | 98,304 (6 stages, NW 64)       | 2,000 | 166,864
//    64 |  32,768            | 49,152 (6 stages, NW 32)       | 2,000 |  84,944
//    32 |  16,384            | 24,576 (6 stages, NW 16)       | 2,000 |  43,984
// and in the bf16 chain:
//   512 |  65,536 (one, bf16) | 163,840 (5 stages, NW 128)    | 1,968 | 232,368  (bf16)

#include "egnn_passes.cuh"
#include "egnn_sm90.cuh"

namespace {

using namespace egnn;
namespace s9 = egnn::sm90;

constexpr int BAR_ALL = 1;                     // named barrier of both consumer warpgroups
constexpr int CT = s9::CONSUMERS * s9::WG;     // consumer threads

// output columns per product: 128 at 512; up to 256 64, or a consumer's
// Hd / 2 below 128 (the small terms' accumulator beside the step sum)
template <int HD>
constexpr int NW_OF = HD == 512 ? 128 : HD / 2 < 64 ? HD / 2 : 64;
// chunks of each consumer's ring: 3 of 16 KiB at 512, 6 below
template <int HD>
constexpr int STAGES_OF = HD == 512 ? 3 : 6;
// K values a step sum in 3xTF32 (egnn_sm90.cuh: product_hmajor, product_split):
// 128 at 512, 32 below (at Hd 256, B4/L256 on the card agg read 0.70 of the
// GPU tests' tolerance with 64, 1.13 with 128, 2.67 summed whole, and a
// raw_delta element that cancels to ~0.2 left it at 1.24x with 64, PERF.md)
template <int HD>
constexpr int GROUP_OF = HD == 512 ? 128 : 32;
template <int HD, bool CB = false>
using HalfOf = s9::Half<HD, NW_OF<HD>, CB>;
// chunks of each consumer's ring in the bf16 chain at 512
constexpr int BF16_STAGES = 5;
// the split tile beside the activation tile (3xTF32 up to 256)
template <int HD>
constexpr bool SPLIT = HD < 512;
// silu / sigmoid in the fast forms (egnn_sm90.cuh: silu_m): one pass, and
// 3xTF32 up to 256; the accurate ones in 3xTF32 at 512
template <int HD, int PASSES>
constexpr bool FAST_SILU = PASSES == 1 || SPLIT<HD>;

template <int HD, bool CB = false>
struct FwdLayout {
    using H = HalfOf<HD, CB>;
    static constexpr int STAGES = CB ? BF16_STAGES : STAGES_OF<HD>;
    static constexpr int TILE = M * H::KW * 4;
    static constexpr int A = 0;                                     // [64][HD]
    static constexpr int AS = A + TILE;                             // [64][HD] (SPLIT)
    static constexpr int RING = AS + (SPLIT<HD> ? TILE : 0);        // [2][STAGES][CHUNK]
    static constexpr int ROWS = RING + 2 * STAGES * H::CHUNK * 4;   // [6][64]
    static constexpr int PART = ROWS + 6 * M * 4;                   // [64]
    static constexpr int FLAGS = PART + M * 4;                      // int [4]
    static constexpr int BARS = FLAGS + 4 * 4;                      // full[2][STAGES], empty[2][STAGES]
    static constexpr int SMEM = BARS + 4 * STAGES * 8 + 1024;
    static_assert(SMEM <= 232448, "shared memory of one block");
    static_assert(BARS % 8 == 0, "mbarriers are 8-byte aligned");
};

// images per weight in the scratch: Wb, and in 3xTF32 Ws after it
template <int PASSES>
constexpr int PARTS = PASSES == 3 ? 2 : 1;

template <int HD, int PASSES, class In, bool CB>
__global__ void __launch_bounds__(s9::THREADS, 1)
egnn_fwd_sm90_hd512(const In* __restrict__ a, const In* __restrict__ bs,
                    const float* __restrict__ x, const float* __restrict__ cmask,
                    const float* __restrict__ w_d, const float* __restrict__ b_e2,
                    const float* __restrict__ b_x1, const float* __restrict__ w_x2,
                    const float* __restrict__ b_x2, const float* __restrict__ img,
                    float* __restrict__ agg, float* __restrict__ delta, int B, int L, int W,
                    int S, int steps_per_slice) {
    static_assert(PASSES == 3 || !SPLIT<HD>, "one pass up to 256 runs on egnn_band_fwd_sm90.cu");
    static_assert(!CB || (PASSES == 1 && HD == 512), "the bf16 chain here: one pass at 512");
    using LY = FwdLayout<HD, CB>;
    using H = HalfOf<HD, CB>;
    constexpr int NW = H::NW, STAGES = LY::STAGES;
    // agg columns of a consumer thread: 2 at 512, else 1 (the first Hd threads)
    constexpr int CPT = HD / CT > 1 ? HD / CT : 1;
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    float* A = reinterpret_cast<float*>(sm + LY::A);
    float* As = reinterpret_cast<float*>(sm + LY::AS);
    int* flags = reinterpret_cast<int*>(sm + LY::FLAGS);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BARS);   // [2][STAGES]
    uint64_t* empty = full + 2 * STAGES;
    const int tid = threadIdx.x, wg = tid / s9::WG, lane = tid % 32;
    if (tid == 0) {
        for (int s = 0; s < 2 * STAGES; ++s) {
            s9::mbar_init(&full[s], 1);
            s9::mbar_init(&empty[s], s9::WG / 32);
        }
        s9::fence_mbar_init();
    }
    __syncthreads();

    const int n_steps = (2 * W + OPS - 1) / OPS;
    const int n_tiles = (L + T - 1) / T, units = B * n_tiles * S;

    if (wg == s9::CONSUMERS) {   // the producer warpgroup: warp h streams half h
        s9::setmaxnreg_dec<s9::PRODUCER_REGS>();
        const int half = (tid % s9::WG) / 32;
        if (half < s9::CONSUMERS) {
            float* ring = reinterpret_cast<float*>(sm + LY::RING) + half * STAGES * H::CHUNK;
            s9::RingPos rp;
            for (int u = blockIdx.x; u < units; u += gridDim.x) {
                const int sl = u % S, i0 = ((u / S) % n_tiles) * T, b = u / (S * n_tiles);
                const size_t row0 = (size_t)b * L;
                const int s1 = min(n_steps, (sl + 1) * steps_per_slice);
                for (int s = sl * steps_per_slice; s < s1; ++s) {
                    bool v = false;
                    for (int r = lane; r < M; r += 32) {
                        int i, j;
                        v |= s9::edge_row(cmask, row0, i0, s, r, L, W, i, j);
                    }
                    if (!__any_sync(0xffffffffu, v)) continue;   // the consumers skip it too
                    if (lane == 0)
                        for (int wi = 0; wi < 2; ++wi) {   // W_e2, then W_x1
                            const float* big = img + (size_t)wi * PARTS<PASSES> * H::IMG;
                            if constexpr (SPLIT<HD>) {
                                const size_t off = (size_t)half * (H::IMG / 2);
                                s9::produce_split<H::NQ, H::CHUNK, STAGES>(
                                    big + off, big + H::IMG + off, ring, full + half * STAGES,
                                    empty + half * STAGES, rp);
                            } else {
                                s9::produce_half<PASSES, NW, STAGES, CB>(
                                    big, big + H::IMG, half, ring, full + half * STAGES,
                                    empty + half * STAGES, rp);
                            }
                        }
                    __syncwarp();
                }
            }
        }
    } else {   // the consumer warpgroups
        s9::setmaxnreg_inc<s9::CONSUMER_REGS>();
        float* ring = reinterpret_cast<float*>(sm + LY::RING) + wg * STAGES * H::CHUNK;
        uint64_t* my_full = full + wg * STAGES;
        uint64_t* my_empty = empty + wg * STAGES;
        float* row_valid = reinterpret_cast<float*>(sm + LY::ROWS);
        float* row_d2 = row_valid + M;
        int* row_j = reinterpret_cast<int*>(row_valid + 2 * M);
        float* row_rel = row_valid + 3 * M;
        float* part = reinterpret_cast<float*>(sm + LY::PART);
        const int t = tid % s9::WG, warp = t / 32, g = lane / 4, tq = lane % 4;
        const int col0 = wg * H::N;   // this consumer's output columns
        const int rw = 16 * warp + g;  // the lane's rows: rw, rw + 8
        const float bx2 = CB ? rbf(b_x2[0]) : b_x2[0];
        s9::RingPos rp;
        float acc[H::NH][H::ACC];
        float tmp[2][H::ACC];            // 3xTF32: step sums (at 512 tmp[0])
        float sml[1][H::ACC];            // 3xTF32 up to 256: the small terms (product_split)
        float agg_t[T][CPT];             // receiver i, columns CPT tid ..
        float delta_r[3];                // first consumer, tq == 0: receiver g
        const bool agg_cols = CPT * tid < HD;
        // agg += valid * m over the step's eight offset slots, read from A
        // while the product that reads m runs (A holds m exact)
        auto agg_side = [&](int q) {
            if (q != 0 || !agg_cols) return;
#pragma unroll
            for (int i = 0; i < T; ++i)
#pragma unroll
                for (int o = 0; o < OPS; ++o) {
                    const int r = o * T + i;
                    if (row_valid[r] > 0.f) {
                        if constexpr (CB) {   // the word of columns 2 tid, 2 tid + 1
                            const float2 v = s9::f2(s9::bf2_of_bits(
                                reinterpret_cast<const uint32_t*>(A)[s9::sw_off(r, tid, M)]));
                            agg_t[i][0] += v.x;
                            agg_t[i][1] += v.y;
                        } else if constexpr (CPT == 2) {
                            const float2 v = *reinterpret_cast<const float2*>(A + s9::sw_off(r, 2 * tid, M));
                            agg_t[i][0] += v.x;
                            agg_t[i][1] += v.y;
                        } else {
                            agg_t[i][0] += A[s9::sw_off(r, tid, M)];
                        }
                    }
                }
        };
        // one product of the tile into acc, in the mode's passes
        auto product = [&](auto side) {
            if constexpr (SPLIT<HD>)
                s9::product_split<HD, NW, H::NH, STAGES, GROUP_OF<HD>, true>(
                    A, As, ring, my_full, my_empty, rp, acc, tmp, sml, lane, side);
            else
                s9::product_half<PASSES, NW, STAGES, true, CB>(A, ring, my_full, my_empty, rp, acc,
                                                               tmp[0], lane, tid, BAR_ALL, side);
        };
        // the activation (v0, v1) at columns (col, col + 1) of row r: exact
        // in 3xTF32 (wgmma reads it truncated), with its small part in As
        auto put2 = [&](int r, int col, float v0, float v1) {
            if constexpr (CB) {
                s9::put2_bf16(A, r, col, s9::bf2r(v0, v1));
                return;
            }
            *reinterpret_cast<float2*>(A + s9::sw_off(r, col, M)) = make_float2(v0, v1);
            if constexpr (SPLIT<HD>)
                *reinterpret_cast<float2*>(As + s9::sw_off(r, col, M)) =
                    make_float2(s9::tf32_lo(v0), s9::tf32_lo(v1));
        };

        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            const int sl = u % S, i0 = ((u / S) % n_tiles) * T, b = u / (S * n_tiles);
            const size_t row0 = (size_t)b * L;
            const In* a_b = a + row0 * HD;
            const In* bs_b = bs + row0 * HD;
            const int s1 = min(n_steps, (sl + 1) * steps_per_slice);
#pragma unroll
            for (int i = 0; i < T; ++i)
#pragma unroll
                for (int c = 0; c < CPT; ++c) agg_t[i][c] = 0.f;
            delta_r[0] = delta_r[1] = delta_r[2] = 0.f;

            for (int s = sl * steps_per_slice; s < s1; ++s) {
                s9::named_sync(BAR_ALL, CT);   // the last step's rows, flags, part and A are consumed
                if (tid < M) {                 // the first two warps: row tid
                    int i, j;
                    const bool v = s9::edge_row(cmask, row0, i0, s, tid, L, W, i, j);
                    float rel[3] = {0.f, 0.f, 0.f}, d2 = 0.f;
                    if (v) {
#pragma unroll
                        for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                        d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                    }
                    row_valid[tid] = v ? 1.f : 0.f;
                    row_d2[tid] = d2;
                    row_j[tid] = j;
#pragma unroll
                    for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
                    const unsigned any = __ballot_sync(0xffffffffu, v);
                    if (lane == 0) flags[tid / 32] = any != 0u;
                }
                s9::named_sync(BAR_ALL, CT);
                if (!(flags[0] | flags[1])) continue;   // no valid edge: skipped by all

                // A = silu(a_i + bs_j + d2 * w_d) (in TF32 in one pass, the bf16
                // chain's rounding in it); rows of invalid edges 0
                if constexpr (CB)
                    s9::fill_pre_bf16<In, CT>(A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, HD,
                                              tid);
                else
                    s9::fill_pre<HD, In, CT, PASSES == 1, FAST_SILU<HD, PASSES>>(
                        A, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0, tid, nullptr,
                        SPLIT<HD> ? As : nullptr);
                s9::fence_async_smem();
                s9::named_sync(BAR_ALL, CT);

                // m = silu(A @ W_e2 + b_e2); A = m (exact: agg sums it from A, and
                // wgmma reads it truncated in one pass)
                product(s9::NoSide());
                s9::named_sync(BAR_ALL, CT);   // both consumers' products have read A
                const float vr[2] = {row_valid[rw], row_valid[rw + 8]};
#pragma unroll
                for (int h = 0; h < H::NH; ++h)
#pragma unroll
                    for (int jj = 0; jj < NW / 8; ++jj) {
                        const int col = col0 + h * NW + 8 * jj + 2 * tq;
                        const float2 be = __ldg(reinterpret_cast<const float2*>(b_e2 + col));
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const float a0 = acc[h][4 * jj + 2 * hh], a1 = acc[h][4 * jj + 2 * hh + 1];
                            if constexpr (CB) {   // the column pair in bf16x2
                                const s9::bf2 u = s9::bias2(a0, a1, s9::bf2r(be.x, be.y));
                                s9::put2_bf16(A, rw + 8 * hh, col, s9::silu2(u, s9::sigmoid2(u)));
                            } else {
                                put2(rw + 8 * hh, col, s9::silu_m<FAST_SILU<HD, PASSES>>(a0 + be.x),
                                     s9::silu_m<FAST_SILU<HD, PASSES>>(a1 + be.y));
                            }
                        }
                    }
                s9::fence_async_smem();
                s9::named_sync(BAR_ALL, CT);

                // wsc = silu(m @ W_x1 + b_x1) . w_x2 + b_x2 per row; delta_i += valid * wsc * rel;
                // agg += valid * m
                product(agg_side);
                float sw[2] = {0.f, 0.f};
#pragma unroll
                for (int h = 0; h < H::NH; ++h)
#pragma unroll
                    for (int jj = 0; jj < NW / 8; ++jj) {
                        const int col = col0 + h * NW + 8 * jj + 2 * tq;
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
                                sw[hh] = fmaf(s9::silu_m<FAST_SILU<HD, PASSES>>(v0 + bx.x), wx.x, sw[hh]);
                                sw[hh] = fmaf(s9::silu_m<FAST_SILU<HD, PASSES>>(v1 + bx.y), wx.y, sw[hh]);
                            }
                        }
                    }
                const float s_own[2] = {quad_sum(sw[0]), quad_sum(sw[1])};
                if (wg == 1 && tq == 0) {
                    part[rw] = s_own[0];
                    part[rw + 8] = s_own[1];
                }
                s9::named_sync(BAR_ALL, CT);
                if (wg == 0 && tq == 0) {
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int row = rw + 8 * hh;
                        if (vr[hh] > 0.f) {
                            // the bf16 chain: the dot product's fp32 sum rounded once
                            const float wsc = CB ? rbf(rbf(s_own[hh] + part[row]) + bx2)
                                                 : s_own[hh] + part[row] + bx2;
#pragma unroll
                            for (int c = 0; c < 3; ++c) delta_r[c] += wsc * row_rel[row * 3 + c];
                        }
                    }
                }
            }

            // The unit's sums: each thread's agg columns as they are; the first
            // consumer's delta partials through A, added in warp order.
            float* agg_u = agg + (size_t)sl * B * L * HD;    // slice sl's partial (S > 1), or agg
            float* delta_u = delta + (size_t)sl * B * L * 3;
#pragma unroll
            for (int i = 0; i < T; ++i)
                if (i0 + i < L && agg_cols) {
                    if constexpr (CPT == 2)
                        *reinterpret_cast<float2*>(agg_u + (row0 + i0 + i) * HD + 2 * tid) =
                            make_float2(agg_t[i][0], agg_t[i][1]);
                    else
                        agg_u[(row0 + i0 + i) * HD + tid] = agg_t[i][0];
                }
            s9::named_sync(BAR_ALL, CT);   // both consumers' products have read A
            float* red_d = A;                     // [4 warps][T][3]
            if (wg == 0 && tq == 0) {
#pragma unroll
                for (int c = 0; c < 3; ++c) red_d[(warp * T + g) * 3 + c] = delta_r[c];
            }
            s9::named_sync(BAR_ALL, CT);
            if (tid < 3 * T) {
                const int rr = tid / 3, c = tid % 3;
                float sum = 0.f;
#pragma unroll
                for (int q = 0; q < 4; ++q) sum += red_d[(q * T + rr) * 3 + c];
                if (i0 + rr < L) delta_u[(row0 + i0 + rr) * 3 + c] = sum;
            }
        }
    }
}

template <int HD, int PASSES, class In, bool CB>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const float* const* w, float* img, float* agg, float* delta, float* part_agg,
                   float* part_delta, int B, int L, int W, int S, int G, cudaStream_t stream) {
    const int n_steps = (2 * W + OPS - 1) / OPS;
    const int per = (n_steps + S - 1) / S;
    if (S < 1 || G < 1 || (S - 1) * per >= n_steps || !img ||
        (S > 1 && (!part_agg || !part_delta)))
        return cudaErrorInvalidValue;   // every slice must own at least one step
    // Wb (and Ws) of W_e2, then of W_x1, as x @ W, in the h-major chunk order
    // (their bf16 images in the bf16 chain)
    cudaError_t err;
    if constexpr (CB) {
        const s9::Bf16ImageSet set{{w[1], w[3]}, {s9::IMG_T, s9::IMG_T}, 2, HD, NW_OF<HD>, 2, 1};
        err = s9::launch_images_bf16(set, img, stream);
    } else {
        s9::HalfImageSet set{};
        set.hmajor = 1;
        for (int wi = 0; wi < 2; ++wi)
            for (int p = 0; p < PARTS<PASSES>; ++p) {
                set.src[set.n] = w[1 + 2 * wi];
                set.orient[set.n] = s9::IMG_T;
                set.part[set.n++] = p;
            }
        err = s9::launch_images_half<HD, NW_OF<HD>>(set, img, stream);
    }
    if (err != cudaSuccess) return err;
    auto kernel = egnn_fwd_sm90_hd512<HD, PASSES, In, CB>;
    constexpr int SMEM = FwdLayout<HD, CB>::SMEM;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G, s9::THREADS, SMEM, stream>>>(
        a, bs, x, cmask, w[0], w[2], w[4], w[5], w[6], img, S > 1 ? part_agg : agg,
        S > 1 ? part_delta : delta, B, L, W, S, per);
    if ((err = cudaGetLastError()) != cudaSuccess || S == 1) return err;
    const size_t n_agg4 = (size_t)B * L * HD / 4, n_delta = (size_t)B * L * 3;
    const size_t blocks = (n_agg4 + n_delta + egnn::THREADS - 1) / egnn::THREADS;
    egnn_band_fwd_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), egnn::THREADS, 0, stream>>>(
        part_agg, part_delta, agg, delta, n_agg4, n_delta, S);
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

// Blocks of the kernel that one SM holds, or a negative CUDA error code.
int egnn_band_fwd_sm90_hd512_blocks_per_sm(int hd, int bf16_in, int passes) {
    int n = 0;
    const cudaError_t err = dispatch(hd, passes, bf16_in,
                                     [&](auto h_c, auto p_c, auto in_c, auto cb_c) {
        constexpr int HD = decltype(h_c)::value;
        constexpr bool CB = decltype(cb_c)::value;
        auto kernel = egnn_fwd_sm90_hd512<HD, decltype(p_c)::value, typename decltype(in_c)::type,
                                          CB>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             FwdLayout<HD, CB>::SMEM);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, s9::THREADS,
                                                             FwdLayout<HD, CB>::SMEM);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch on `stream`; returns the CUDA error code (0 = success). As
// egnn_band_fwd_sm90_launch, at hd 512 with passes 1 or 3 (TF32 passes per
// product) or 0 (the bf16 chain), at hd 32..256 with passes 3; img: 2 x hd^2
// floats of scratch in one pass, 4 x hd^2 in three, hd^2 in the bf16 chain.
int egnn_band_fwd_sm90_hd512_launch(const void* a, const void* bs, const float* x,
                                    const float* cmask, const float* w_d, const float* w_e2,
                                    const float* b_e2, const float* w_x1, const float* b_x1,
                                    const float* w_x2, const float* b_x2, float* img, float* agg,
                                    float* delta, float* part_agg, float* part_delta, int B, int L,
                                    int hd, int W, int S, int G, int bf16_in, int passes,
                                    void* stream) {
    const float* w[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(hd, passes, bf16_in, [&](auto h_c, auto p_c, auto in_c, auto cb_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(h_c)::value, decltype(p_c)::value, In, decltype(cb_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, w, img, agg, delta,
            part_agg, part_delta, B, L, W, S, G, s);
    });
}

// The shared-tile kernels' weight images alone (the layout kernel), for a
// test against the wrapper's numpy mirror: n (1..8) images of the hd x hd
// srcs[q] in orientation orient[q] (0 = IMG_T, 1 = IMG_N), part[q] (0 =
// big, 1 = small), with nw columns per chunk (a width's kernel-1 or
// kernel-2 chunks: 64 or 128 at hd 512 and 256, hd / 2 below), in the
// h-major chunk order if hmajor, into img [n][hd * hd].
int egnn_hd512_weight_images(const float* const* srcs, const int* orient, const int* part, int n,
                             int hd, int nw, int hmajor, float* img, void* stream) {
    if (n < 1 || n > 8) return cudaErrorInvalidValue;
    s9::HalfImageSet set{};
    set.hmajor = hmajor;
    for (int q = 0; q < n; ++q) {
        set.src[q] = srcs[q];
        set.orient[q] = orient[q];
        set.part[q] = part[q];
    }
    set.n = n;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (hd == 512 && nw == 64) return s9::launch_images_half<512, 64>(set, img, s);
    if (hd == 512 && nw == 128) return s9::launch_images_half<512, 128>(set, img, s);
    if (hd == 256 && nw == 64) return s9::launch_images_half<256, 64>(set, img, s);
    if (hd == 256 && nw == 128) return s9::launch_images_half<256, 128>(set, img, s);
    if (hd == 128 && nw == 64) return s9::launch_images_half<128, 64>(set, img, s);
    if (hd == 64 && nw == 32) return s9::launch_images_half<64, 32>(set, img, s);
    if (hd == 32 && nw == 16) return s9::launch_images_half<32, 16>(set, img, s);
    return cudaErrorInvalidValue;
}

const char* egnn_band_fwd_sm90_hd512_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
