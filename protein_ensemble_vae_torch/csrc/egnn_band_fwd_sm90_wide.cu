// EGNN band forward on Hopper (sm_90a) above decoder width 512: both
// fp32-chain modes, the fp32 model's (precision="highest": 3xTF32 products)
// and the bf16 model's (precision="default": one TF32 pass), and the bf16
// chain (chain_dtype=bfloat16, CB), fp32 or bf16 a / bs, at a width hd
// given at run time (a multiple of 256 above 512; the wrapper zero-pads any
// other width up to one).
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/egnn_band.py (egnn_band.py:107): per valid edge (i, j) of the
// +-W band, m = silu(silu(a_i + bs_j + d2 w_d) @ W_e2 + b_e2), agg_i = sum of
// m, raw_delta_i = sum of (silu(m @ W_x1 + b_x1) . w_x2 + b_x2) rel.
//
// What bounds it: operations, 4 hd^2 FLOP per valid edge (at Hd 1024,
// B4/L256 0.617 ms in one TF32 pass, three times that in 3xTF32). Then the
// streams from L2: every 64-row step streams W_e2 and W_x1 (hd^2 fp32 each)
// once per image (one in one pass, two in 3xTF32: Wb, Ws), and each of its
// two products re-reads its A operand (64 x hd fp32) once per column pass
// (hd / 256 passes in one pass, hd / 128 in 3xTF32).
//
// Design (egnn_sm90_wide.cuh holds the building blocks):
// - A block is a producer warpgroup (one working thread) and two consumer
//   warpgroups; a persistent grid of one block per SM walks work units
//   (batch row, tile of T = 8 receivers, slice of the band's 64-edge-row
//   steps), unit g, g + G, ... (egnn_band.py: hd512_fwd_plan_of). Row r of a
//   step is (offset slot r / 8, receiver r % 8).
// - The activation tile no longer fits in shared memory (64 x 1024 fp32 is
//   256 KiB), so it streams: the fill writes X = silu(pre) to the block's
//   first stream buffer (K-major swizzled rows in device memory, read back
//   through L2), the first product's epilogue writes m to the second, and
//   the producer streams each K block back beside the weight
//   chunk of the same column pass and K block, through one ring of full /
//   empty mbarriers. Both consumers read the A chunk of a stage; each takes
//   its NW columns of the pass from the weight chunk.
// - agg: during the second product's first column pass every K block of m
//   lies in a ring stage; consumer thread t sums the valid rows of receiver
//   t / 32 at column t % 32 of it and adds that to the unit's agg row in
//   device memory (zeroed at the unit's start, one owner per element, the
//   next K block's value loaded one K block ahead). m is stored exact (wgmma
//   reads it truncated).
// - raw_delta: the w_x2 dot product of a row sums over the column passes in
//   the lane's registers; the second consumer's partials meet the first's in
//   shared memory, added in that order, and the rows' delta partials meet
//   at the unit's end, added in warp order. With S > 1 slices a unit writes
//   its slice's partial and egnn_band_fwd_sum adds them in slice order. No
//   atomics: two launches are bitwise identical.
// - 3xTF32: Xs, the A chunk's small part, is split in shared memory per K
//   block (egnn_sm90_wide.cuh: consume; streaming it cost more than the
//   split, PERF.md); each K block's products are Xt.Ws and Xs.Wb into the
//   small terms' accumulator and Xt.Wb into a 32-K step sum (two buffers in
//   turn, no drain), added in round-to-nearest fp32 (the tensor cores truncate; a
//   numpy model of this accumulation, tests/test_torch_sm90_wide.py, stays
//   far inside the tolerance at Hd 1024 and 2048; the shared-tile kernels'
//   chip runs at Hd 256 set the 32-K span, PERF.md).
// - sigmoid: the fast form in one pass, the accurate one in 3xTF32.
// - The bf16 chain: the one-pass configuration with bf16 stream rows, A
//   chunks and images (egnn_sm90_wide.cuh), m64n128k16 products and the JAX
//   kernel's rounding in the fill and the epilogues (egnn_sm90.cuh: "the
//   bf16 chain"); the agg side reads a word (two columns) a thread and K
//   block. One streamed design serves every width above 512: a bf16 tile of
//   64 x hd would fit shared memory up to 1024 (128 KiB), not at 2048.
// - A step with no valid edge is skipped by all three warpgroups.
//
// Shared memory per block (bytes; + 1 KiB alignment slack), any width:
//   passes | ring (STAGES x stage), split buffers | rows, part, flags, barriers | total
//   1      | 204,800 (5 x 40,960)                 | 1,888 | 207,712  (of 232,448)
//   3      | 163,840 (4 x 40,960) + 24,576        | 1,872 | 191,312  (of 232,448)
// and the bf16 chain as one pass (Cfg<1>).

#include "egnn_passes.cuh"
#include "egnn_sm90_wide.cuh"

namespace {

using namespace egnn;
namespace s9 = egnn::sm90;
namespace wd = egnn::sm90::wide;

template <int PASSES>
struct FwdLayout {
    using C = wd::Cfg<PASSES>;
    static constexpr int RING = 0;                                 // [STAGES][STAGE]
    static constexpr int SPLIT = RING + C::STAGES * C::STAGE * 4;  // [SPLITS][ACHUNK]
    static constexpr int ROWS = SPLIT + C::SPLITS * wd::ACHUNK * 4; // [6][64]
    static constexpr int PART = ROWS + 6 * M * 4;                  // [64]
    static constexpr int FLAGS = PART + M * 4;                     // int [2]
    static constexpr int BARS = FLAGS + 2 * 4;                     // full, empty [STAGES], act
    static constexpr int SMEM = BARS + (2 * C::STAGES + 1) * 8 + 1024;
    static_assert(SMEM <= 232448, "shared memory of one block");
    static_assert(BARS % 8 == 0, "mbarriers are 8-byte aligned");
};

// floats of a block's stream buffers: X and m, 64 x hd each
__host__ __device__ constexpr size_t stream_floats(int hd) { return (size_t)2 * M * hd; }

template <int PASSES, class In, bool CB>
__global__ void __launch_bounds__(s9::THREADS, 1)
egnn_fwd_sm90_wide(const In* __restrict__ a, const In* __restrict__ bs,
                   const float* __restrict__ x, const float* __restrict__ cmask,
                   const float* __restrict__ w_d, const float* __restrict__ b_e2,
                   const float* __restrict__ b_x1, const float* __restrict__ w_x2,
                   const float* __restrict__ b_x2, const float* __restrict__ img,
                   float* __restrict__ stream, float* __restrict__ agg,
                   float* __restrict__ delta, int B, int L, int hd, int W, int S,
                   int steps_per_slice) {
    using LY = FwdLayout<PASSES>;
    using C = wd::Cfg<PASSES>;
    constexpr int NW = C::NW, ACC = C::ACC;
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

    const int n_steps = (2 * W + OPS - 1) / OPS;
    const int n_tiles = (L + T - 1) / T, units = B * n_tiles * S;
    const size_t img_floats = CB ? s9::image_words_bf16(hd) : (size_t)hd * hd;
    // this block's stream buffers: X, m (64 x hd each)
    float* sx = stream + (size_t)blockIdx.x * stream_floats(hd);
    float* smm = sx + (size_t)M * hd;

    if (wg == s9::CONSUMERS) {   // the producer warpgroup: its first warp, one thread streams
        s9::setmaxnreg_dec<s9::PRODUCER_REGS>();
        if (tid % s9::WG < 32) {
            s9::RingPos rp;
            uint32_t act_phase = 0;
            for (int u = blockIdx.x; u < units; u += gridDim.x) {
                const int sl = u % S, i0 = ((u / S) % n_tiles) * T, b = u / (S * n_tiles);
                const size_t row0 = (size_t)b * L;
                const int s1 = min(n_steps, (sl + 1) * steps_per_slice);
                for (int s = sl * steps_per_slice; s < s1; ++s) {
                    if (!wd::step_has_edge(cmask, row0, i0, s, L, W, lane)) continue;
                    if (lane == 0)
                        for (int wi = 0; wi < 2; ++wi) {   // X @ W_e2, then m @ W_x1
                            const float* big = img + (size_t)wi * C::PARTS * img_floats;
                            wd::produce<PASSES, CB>(wi ? smm : sx, big, big + img_floats, hd, ring,
                                                    full, empty, act, act_phase, rp);
                        }
                    __syncwarp();
                }
            }
        }
    } else {   // the consumer warpgroups
        s9::setmaxnreg_inc<s9::CONSUMER_REGS>();
        float* row_valid = reinterpret_cast<float*>(sm + LY::ROWS);
        float* row_d2 = row_valid + M;
        int* row_j = reinterpret_cast<int*>(row_valid + 2 * M);
        float* row_rel = row_valid + 3 * M;
        float* part = reinterpret_cast<float*>(sm + LY::PART);
        const int t = tid % s9::WG, warp = t / 32, g = lane / 4, tq = lane % 4;
        const int rw = 16 * warp + g;   // the lane's rows: rw, rw + 8 (receiver g)
        const float bx2 = CB ? rbf(b_x2[0]) : b_x2[0];
        s9::RingPos rp;
        int sq = 0;   // split buffer of the next K block (3xTF32)
        float acc[ACC], tmp0[ACC], tmp1[ACC], sml[ACC];
        float delta_r[3];                 // first consumer, tq == 0: receiver g
        // this thread's agg receiver and column (in the bf16 chain, word: two
        // columns) in a K block; K values a K block
        const int ai = tid / 32, ac = tid % 32;
        constexpr int KV = CB ? 2 * s9::KB : s9::KB;

        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            const int sl = u % S, i0 = ((u / S) % n_tiles) * T, b = u / (S * n_tiles);
            const size_t row0 = (size_t)b * L;
            const In* a_b = a + row0 * hd;
            const In* bs_b = bs + row0 * hd;
            const int s1 = min(n_steps, (sl + 1) * steps_per_slice);
            float* agg_u = agg + (size_t)sl * B * L * hd;      // slice sl's partial (S > 1), or agg
            float* delta_u = delta + (size_t)sl * B * L * 3;
            // this thread's agg entries of the unit: receiver i0 + ai, columns ac + 32 kc
            float* agg_t = i0 + ai < L ? agg_u + (row0 + i0 + ai) * hd + (CB ? 2 * ac : ac) : nullptr;
            if (agg_t)
                for (int c = 0; c < hd; c += KV) {
                    agg_t[c] = 0.f;
                    if constexpr (CB) agg_t[c + 1] = 0.f;
                }
            delta_r[0] = delta_r[1] = delta_r[2] = 0.f;

            for (int s = sl * steps_per_slice; s < s1; ++s) {
                s9::named_sync(wd::BAR_C, wd::CT);   // the last step's rows, flags and part are consumed
                if (tid < M)
                    wd::step_rows(x, cmask, nullptr, row0, i0, s, tid, L, W, row_valid, row_d2,
                                  row_j, row_rel, nullptr, flags);
                s9::named_sync(wd::BAR_C, wd::CT);
                if (!(flags[0] | flags[1])) continue;   // no valid edge: skipped by all

                // X = silu(a_i + bs_j + d2 * w_d) into the first stream buffer
                if constexpr (CB)
                    s9::fill_pre_bf16<In, wd::CT>(sx, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0,
                                                  hd, tid);
                else
                    wd::fill<PASSES, PASSES == 3>(sx, a_b, bs_b, w_d, row_valid, row_d2, row_j, i0,
                                                  hd, tid);
                wd::publish(act, tid);

                // m = silu(X @ W_e2 + b_e2) into the second (exact, or bf16)
                wd::consume<PASSES, CB>(ring, split, sq, full, empty, rp, hd, wg, tid, lane, acc,
                                        tmp0, tmp1, sml,
                                        [](int, const float*) {}, [&](int p, float (&ac_)[ACC]) {
#pragma unroll
                    for (int jj = 0; jj < NW / 8; ++jj) {
                        const int col = p * C::NC + wg * NW + 8 * jj + 2 * tq;
                        const float2 be = __ldg(reinterpret_cast<const float2*>(b_e2 + col));
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const float a0 = ac_[4 * jj + 2 * hh], a1 = ac_[4 * jj + 2 * hh + 1];
                            if constexpr (CB) {   // the column pair in bf16x2
                                const s9::bf2 u = s9::bias2(a0, a1, s9::bf2r(be.x, be.y));
                                s9::put2_bf16(smm, rw + 8 * hh, col, s9::silu2(u, s9::sigmoid2(u)));
                            } else {
                                wd::put2<false>(smm, rw + 8 * hh, col,
                                                s9::silu_m<PASSES == 1>(a0 + be.x),
                                                s9::silu_m<PASSES == 1>(a1 + be.y));
                            }
                        }
                    }
                });
                wd::publish(act, tid);

                // wsc = silu(m @ W_x1 + b_x1) . w_x2 + b_x2 per row; agg += valid * m
                float sw[2] = {0.f, 0.f};
                // agg_t's entries of K block 0, then each next K block's, loaded one
                // ahead (in the bf16 chain a column pair)
                float2 ahead = make_float2(0.f, 0.f);
                auto agg_at = [&](int kc) {
                    return CB ? *reinterpret_cast<const float2*>(agg_t + kc * KV)
                              : make_float2(agg_t[kc * KV], 0.f);
                };
                if (agg_t) ahead = agg_at(0);
                auto agg_side = [&](int kc, const float* st) {
                    float v0 = 0.f, v1 = 0.f;
#pragma unroll
                    for (int o = 0; o < OPS; ++o) {
                        const int r = o * T + ai;
                        if (row_valid[r] > 0.f) {
                            if constexpr (CB) {
                                const float2 w2 = s9::f2(s9::bf2_of_bits(
                                    reinterpret_cast<const uint32_t*>(st)[s9::sw_off(r, ac, M)]));
                                v0 += w2.x;
                                v1 += w2.y;
                            } else {
                                v0 += st[s9::sw_off(r, ac, M)];
                            }
                        }
                    }
                    if (!agg_t) return;
                    const float2 cur = ahead;
                    if (kc + 1 < hd / KV) ahead = agg_at(kc + 1);
                    if constexpr (CB)
                        *reinterpret_cast<float2*>(agg_t + kc * KV) = make_float2(cur.x + v0, cur.y + v1);
                    else
                        agg_t[kc * KV] = cur.x + v0;
                };
                wd::consume<PASSES, CB>(ring, split, sq, full, empty, rp, hd, wg, tid, lane, acc,
                                        tmp0, tmp1, sml,
                                        agg_side, [&](int p, float (&ac_)[ACC]) {
#pragma unroll
                    for (int jj = 0; jj < NW / 8; ++jj) {
                        const int col = p * C::NC + wg * NW + 8 * jj + 2 * tq;
                        const float2 bx = __ldg(reinterpret_cast<const float2*>(b_x1 + col));
                        const float2 wx = __ldg(reinterpret_cast<const float2*>(w_x2 + col));
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const float v0 = ac_[4 * jj + 2 * hh], v1 = ac_[4 * jj + 2 * hh + 1];
                            if constexpr (CB) {   // the column pair in bf16x2
                                const s9::bf2 v = s9::bias2(v0, v1, s9::bf2r(bx.x, bx.y));
                                const float2 w1 = s9::f2(s9::silu2(v, s9::sigmoid2(v)));
                                const float2 w2 = s9::f2(s9::bf2r(wx.x, wx.y));
                                sw[hh] = fmaf(w1.y, w2.y, fmaf(w1.x, w2.x, sw[hh]));
                            } else {
                                sw[hh] = fmaf(s9::silu_m<PASSES == 1>(v0 + bx.x), wx.x, sw[hh]);
                                sw[hh] = fmaf(s9::silu_m<PASSES == 1>(v1 + bx.y), wx.y, sw[hh]);
                            }
                        }
                    }
                });
                const float s_own[2] = {quad_sum(sw[0]), quad_sum(sw[1])};
                if (wg == 1 && tq == 0) {
                    part[rw] = s_own[0];
                    part[rw + 8] = s_own[1];
                }
                s9::named_sync(wd::BAR_C, wd::CT);
                if (wg == 0 && tq == 0) {
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int row = rw + 8 * hh;
                        if (row_valid[row] > 0.f) {
                            // the bf16 chain: the dot product's fp32 sum rounded once
                            const float wsc = CB ? rbf(rbf(s_own[hh] + part[row]) + bx2)
                                                 : s_own[hh] + part[row] + bx2;
#pragma unroll
                            for (int c = 0; c < 3; ++c) delta_r[c] += wsc * row_rel[row * 3 + c];
                        }
                    }
                }
            }

            // The unit's delta: the first consumer's partials through the
            // part row, added in warp order.
            s9::named_sync(wd::BAR_C, wd::CT);   // part and the rows are consumed
            float* red_d = row_valid;            // [4 warps][T][3] over the rows
            if (wg == 0 && tq == 0) {
#pragma unroll
                for (int c = 0; c < 3; ++c) red_d[(warp * T + g) * 3 + c] = delta_r[c];
            }
            s9::named_sync(wd::BAR_C, wd::CT);
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

template <int PASSES, class In, bool CB>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const float* const* w, float* scratch, float* agg, float* delta,
                   float* part_agg, float* part_delta, int B, int L, int hd, int W, int S, int G,
                   cudaStream_t stream) {
    using C = wd::Cfg<PASSES>;
    const int n_steps = (2 * W + OPS - 1) / OPS;
    const int per = (n_steps + S - 1) / S;
    if (hd <= 512 || hd % WIDE_GROUP || S < 1 || G < 1 || (S - 1) * per >= n_steps || !scratch ||
        (S > 1 && (!part_agg || !part_delta)))
        return cudaErrorInvalidValue;   // every slice must own at least one step
    // Wb (and Ws) of W_e2, then of W_x1, as x @ W (their bf16 images in the
    // bf16 chain); then the stream buffers
    cudaError_t err;
    size_t img_words;
    if constexpr (CB) {
        const s9::Bf16ImageSet set{{w[1], w[3]}, {s9::IMG_T, s9::IMG_T}, 2, hd, C::NC, 1, 1};
        err = s9::launch_images_bf16(set, scratch, stream);
        img_words = 2 * s9::image_words_bf16(hd);
    } else {
        wd::WideImageSet set{};
        for (int wi = 0; wi < 2; ++wi)
            for (int p = 0; p < C::PARTS; ++p) {
                set.src[set.n] = w[1 + 2 * wi];
                set.orient[set.n] = s9::IMG_T;
                set.part[set.n++] = p;
            }
        err = wd::launch_images_wide(set, hd, C::NC, scratch, stream);
        img_words = (size_t)2 * C::PARTS * hd * hd;
    }
    if (err != cudaSuccess) return err;
    float* stream_rows = scratch + img_words;   // after the images
    auto kernel = egnn_fwd_sm90_wide<PASSES, In, CB>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FwdLayout<PASSES>::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G, s9::THREADS, FwdLayout<PASSES>::SMEM, stream>>>(
        a, bs, x, cmask, w[0], w[2], w[4], w[5], w[6], scratch, stream_rows,
        S > 1 ? part_agg : agg, S > 1 ? part_delta : delta, B, L, hd, W, S, per);
    if ((err = cudaGetLastError()) != cudaSuccess || S == 1) return err;
    const size_t n_agg4 = (size_t)B * L * hd / 4, n_delta = (size_t)B * L * 3;
    const size_t blocks = (n_agg4 + n_delta + egnn::THREADS - 1) / egnn::THREADS;
    egnn_band_fwd_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), egnn::THREADS, 0, stream>>>(
        part_agg, part_delta, agg, delta, n_agg4, n_delta, S);
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

// Blocks of the kernel that one SM holds, or a negative CUDA error code.
int egnn_band_fwd_sm90_wide_blocks_per_sm(int bf16_in, int passes) {
    int n = 0;
    const cudaError_t err = dispatch(passes, bf16_in, [&](auto p_c, auto in_c, auto cb_c) {
        constexpr int PASSES = decltype(p_c)::value;
        auto kernel = egnn_fwd_sm90_wide<PASSES, typename decltype(in_c)::type,
                                         decltype(cb_c)::value>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             FwdLayout<PASSES>::SMEM);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, s9::THREADS,
                                                             FwdLayout<PASSES>::SMEM);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Floats of scratch one call needs: the weight images (2 x parts x hd^2,
// or two bf16 images in the bf16 chain, passes 0) and G blocks' stream
// buffers.
size_t egnn_band_fwd_sm90_wide_scratch_floats(int hd, int G, int passes) {
    const size_t img = passes == 0 ? s9::image_words_bf16(hd) : (size_t)(passes == 3 ? 2 : 1) * hd * hd;
    return 2 * img + G * stream_floats(hd);
}

// Launch on `stream`; returns the CUDA error code (0 = success). a, bs
// [B, L, hd] (bf16 when bf16_in, else fp32), the rest fp32 as
// egnn_band_fwd_sm90_hd512_launch; hd > 512 a multiple of 256; passes 1 or
// 3, or 0 (the bf16 chain); scratch as sized above; S slices of the band steps (S > 1: part_agg
// [S, B, L, hd], part_delta [S, B, L, 3], summed by a second kernel); G
// persistent blocks.
int egnn_band_fwd_sm90_wide_launch(const void* a, const void* bs, const float* x,
                                   const float* cmask, const float* w_d, const float* w_e2,
                                   const float* b_e2, const float* w_x1, const float* b_x1,
                                   const float* w_x2, const float* b_x2, float* scratch,
                                   float* agg, float* delta, float* part_agg, float* part_delta,
                                   int B, int L, int hd, int W, int S, int G, int bf16_in,
                                   int passes, void* stream) {
    const float* w[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(passes, bf16_in, [&](auto p_c, auto in_c, auto cb_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(p_c)::value, In, decltype(cb_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, w, scratch, agg,
            delta, part_agg, part_delta, B, L, hd, W, S, G, s);
    });
}

// The wide kernels' weight images alone (the layout kernel), for a test
// against the wrapper's numpy mirror: n (1..8) images of the hd x hd
// srcs[q] in orientation orient[q] (0 = IMG_T, 1 = IMG_N), part[q] (0 =
// big, 1 = small), in chunks of nc rows x 32 K, (column pass, K block)
// order, into img [n][hd * hd].
int egnn_wide_weight_images(const float* const* srcs, const int* orient, const int* part, int n,
                            int hd, int nc, float* img, void* stream) {
    if (n < 1 || n > 8) return cudaErrorInvalidValue;
    wd::WideImageSet set{};
    for (int q = 0; q < n; ++q) {
        set.src[q] = srcs[q];
        set.orient[q] = orient[q];
        set.part[q] = part[q];
    }
    set.n = n;
    return wd::launch_images_wide(set, hd, nc, img, static_cast<cudaStream_t>(stream));
}

const char* egnn_band_fwd_sm90_wide_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
