// EGNN band forward on Hopper (sm_90a) at the native width 512 (every
// decoder width from 257 to 512 runs here, zero-padded to it), in the fp32
// model's mode (precision="highest": 3xTF32 products, the fp32 chain) and
// the bf16 model's one-pass mode (precision="default"), fp32 or bf16 a / bs.
// The bf16 chain at 512 stays on egnn_band_fwd.cu (Tile<512>), the widths
// 32 to 256 on egnn_band_fwd_sm90.cu / egnn_band_fwd.cu, those above 512 on
// the wide variant.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/egnn_band.py (egnn_band.py:107): the function of
// egnn_band_fwd_sm90.cu's header, with each product's operands rounded to
// TF32 and summed in fp32 (one pass), or in three TF32 passes (PASSES = 3,
// egnn_sm90.cuh: Half).
//
// What bounds it: operations, 4 Hd^2 FLOP per valid edge: 0.154 ms at
// B4/L256 in one TF32 pass, three times that in 3xTF32. The weights are a
// floor of their own: every 64-row step streams W_e2 and W_x1 (1 MiB each)
// from L2, once per pass: one image each in one pass, three (Ws, Wb, Wb)
// in 3xTF32.
//
// Design (egnn_sm90.cuh holds the building blocks):
// - A block is a producer warpgroup and two consumer warpgroups; a
//   persistent grid of one block per SM walks work units (batch row, tile of
//   T = 8 receivers, slice of the band's 64-edge-row steps), unit g, g + G,
//   ... Row r of a step is (offset slot r / 8, receiver r % 8).
// - One activation tile A [64][512] (K-major, 128-byte swizzle, 128 KiB)
//   serves both consumers: each computes its 256 output columns of every
//   product (m64n128k8 wgmma, two column groups), reading all of A. The
//   epilogues write the next activation into A by columns, so a barrier of
//   both consumer warpgroups comes after both have retired the product that
//   reads it (product_half ends in wgmma.wait_group 0) and before either
//   writes, and the writes are fenced to the async proxy before the next
//   product.
// - Each consumer has its own ring of STAGES weight chunks (128 columns x
//   32 K, 16 KiB), filled by its own producer warp from its half of the
//   image with cp.async.bulk under full / empty mbarriers.
// - The w_x2 row dot product spans both halves: the second consumer's
//   partial sums meet the first's in shared memory, added in that order.
//   agg: A holds m exact (in one pass wgmma reads it truncated), and while
//   the W_x1 product runs each consumer thread adds its two columns' valid
//   rows of A to its registers, over the unit's steps in order; delta's
//   partials meet in the A tile at the unit's end, added in warp order: no
//   atomics, two launches bitwise identical. With S > 1 slices a unit
//   writes its slice's partial and egnn_band_fwd_sum adds the S partials in
//   slice order.
// - 3xTF32: the products' chunks stream in the h-major order (a column
//   group's K blocks in turn), each 128 K summed apart and added to the
//   accumulators in round-to-nearest fp32 (egnn_sm90.cuh: product_hmajor),
//   and silu / sigmoid are the accurate ones.
// - A step with no valid edge is skipped by all three warpgroups.
// - Registers: setmaxnreg gives the consumers 232 (the two m64n128
//   accumulators 128 per thread, a step sum 64 in 3xTF32, agg 16), the
//   producer 40.
// - Weight images (egnn_sm90.cuh: Half, image_value_half) are written per
//   call by weight_images_half from this file's C entry, into scratch the
//   wrapper allocates: Wb of W_e2 and W_x1, and in 3xTF32 also their Ws.
//
// Shared memory per block (bytes; + 1 KiB alignment slack):
//   A tile (64 x 512 x 4)             131,072
//   rings (2 x STAGES x 128 x 128)     98,304
//   rows (valid, d2, j, rel[3])         1,536
//   the second consumer's dot products    256
//   flags, barriers                       112
//   total                             232,304  (of 232,448)

#include "egnn_passes.cuh"
#include "egnn_sm90.cuh"

namespace {

using namespace egnn;
namespace s9 = egnn::sm90;

constexpr int NW = 128;                        // output columns per product
constexpr int STAGES = 3;                      // chunks of each consumer's ring
constexpr int BAR_ALL = 1;                     // named barrier of both consumer warpgroups
constexpr int CT = s9::CONSUMERS * s9::WG;     // consumer threads
using H = s9::Half<NW>;

struct FwdLayout {
    static constexpr int A = 0;                                     // [64][512]
    static constexpr int RING = A + M * H::HD * 4;                  // [2][STAGES][CHUNK]
    static constexpr int ROWS = RING + 2 * STAGES * H::CHUNK * 4;   // [6][64]
    static constexpr int PART = ROWS + 6 * M * 4;                   // [64]
    static constexpr int FLAGS = PART + M * 4;                      // int [4]
    static constexpr int BARS = FLAGS + 4 * 4;                      // full[2][STAGES], empty[2][STAGES]
    static constexpr int SMEM = BARS + 4 * STAGES * 8 + 1024;
    static_assert(SMEM <= 232448, "shared memory of one block");
    static_assert(BARS % 8 == 0, "mbarriers are 8-byte aligned");
    static_assert(CT * 2 == H::HD, "two agg columns per consumer thread");
};

// images per weight in the scratch: Wb, and in 3xTF32 Ws after it
template <int PASSES>
constexpr int PARTS = PASSES == 3 ? 2 : 1;

template <int PASSES, class In>
__global__ void __launch_bounds__(s9::THREADS, 1)
egnn_fwd_sm90_hd512(const In* __restrict__ a, const In* __restrict__ bs,
                    const float* __restrict__ x, const float* __restrict__ cmask,
                    const float* __restrict__ w_d, const float* __restrict__ b_e2,
                    const float* __restrict__ b_x1, const float* __restrict__ w_x2,
                    const float* __restrict__ b_x2, const float* __restrict__ img,
                    float* __restrict__ agg, float* __restrict__ delta, int B, int L, int W,
                    int S, int steps_per_slice) {
    constexpr int HD = H::HD;
    using LY = FwdLayout;
    extern __shared__ char smem_raw[];
    char* sm = s9::smem_base(smem_raw);
    float* A = reinterpret_cast<float*>(sm + LY::A);
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
                            s9::produce_half<PASSES, NW, STAGES>(
                                big, big + H::IMG, half, ring, full + half * STAGES,
                                empty + half * STAGES, rp);
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
        const float bx2 = b_x2[0];
        s9::RingPos rp;
        float acc[H::NH][H::ACC];
        float tmp[H::ACC];               // 3xTF32: a 128-K step sum (product_hmajor)
        float agg_t[T][2];               // receiver i, columns 2 tid, 2 tid + 1
        float delta_r[3];                // first consumer, tq == 0: receiver g
        // agg += valid * m over the step's eight offset slots, read from A
        // while the product that reads m runs (A holds m exact)
        auto agg_side = [&](int q) {
            if (q != 0) return;
#pragma unroll
            for (int i = 0; i < T; ++i)
#pragma unroll
                for (int o = 0; o < OPS; ++o) {
                    const int r = o * T + i;
                    if (row_valid[r] > 0.f) {
                        const float2 v = *reinterpret_cast<const float2*>(A + s9::sw_off(r, 2 * tid, M));
                        agg_t[i][0] += v.x;
                        agg_t[i][1] += v.y;
                    }
                }
        };

        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            const int sl = u % S, i0 = ((u / S) % n_tiles) * T, b = u / (S * n_tiles);
            const size_t row0 = (size_t)b * L;
            const In* a_b = a + row0 * HD;
            const In* bs_b = bs + row0 * HD;
            const int s1 = min(n_steps, (sl + 1) * steps_per_slice);
#pragma unroll
            for (int i = 0; i < T; ++i) agg_t[i][0] = agg_t[i][1] = 0.f;
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

                // A = silu(a_i + bs_j + d2 * w_d) (in TF32 in one pass); rows of invalid edges 0
                s9::fill_pre<HD, In, CT, PASSES == 1>(A, a_b, bs_b, w_d, row_valid, row_d2, row_j,
                                                      i0, tid);
                s9::fence_async_smem();
                s9::named_sync(BAR_ALL, CT);

                // m = silu(A @ W_e2 + b_e2); A = m (exact: agg sums it from A, and
                // wgmma reads it truncated in one pass)
                s9::product_half<PASSES, NW, STAGES, true>(A, ring, my_full, my_empty, rp, acc, tmp,
                                                           lane, tid, BAR_ALL);
                s9::named_sync(BAR_ALL, CT);   // both consumers' products have read A
                const float vr[2] = {row_valid[rw], row_valid[rw + 8]};
#pragma unroll
                for (int h = 0; h < H::NH; ++h)
#pragma unroll
                    for (int jj = 0; jj < NW / 8; ++jj) {
                        const int col = col0 + h * NW + 8 * jj + 2 * tq;
                        const float2 be = __ldg(reinterpret_cast<const float2*>(b_e2 + col));
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh)
                            *reinterpret_cast<float2*>(A + s9::sw_off(rw + 8 * hh, col, M)) =
                                make_float2(s9::silu_m<PASSES == 1>(acc[h][4 * jj + 2 * hh] + be.x),
                                            s9::silu_m<PASSES == 1>(acc[h][4 * jj + 2 * hh + 1] + be.y));
                    }
                s9::fence_async_smem();
                s9::named_sync(BAR_ALL, CT);

                // wsc = silu(m @ W_x1 + b_x1) . w_x2 + b_x2 per row; delta_i += valid * wsc * rel;
                // agg += valid * m
                s9::product_half<PASSES, NW, STAGES, true>(A, ring, my_full, my_empty, rp, acc, tmp,
                                                           lane, tid, BAR_ALL, agg_side);
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
                            sw[hh] = fmaf(s9::silu_m<PASSES == 1>(acc[h][4 * jj + 2 * hh] + bx.x), wx.x, sw[hh]);
                            sw[hh] = fmaf(s9::silu_m<PASSES == 1>(acc[h][4 * jj + 2 * hh + 1] + bx.y), wx.y, sw[hh]);
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
                            const float wsc = s_own[hh] + part[row] + bx2;
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
                if (i0 + i < L)
                    *reinterpret_cast<float2*>(agg_u + (row0 + i0 + i) * HD + 2 * tid) =
                        make_float2(agg_t[i][0], agg_t[i][1]);
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

template <int PASSES, class In>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const float* const* w, float* img, float* agg, float* delta, float* part_agg,
                   float* part_delta, int B, int L, int W, int S, int G, cudaStream_t stream) {
    const int n_steps = (2 * W + OPS - 1) / OPS;
    const int per = (n_steps + S - 1) / S;
    if (S < 1 || G < 1 || (S - 1) * per >= n_steps || !img ||
        (S > 1 && (!part_agg || !part_delta)))
        return cudaErrorInvalidValue;   // every slice must own at least one step
    // Wb (and Ws) of W_e2, then of W_x1, as x @ W, in the h-major chunk order
    s9::HalfImageSet set{};
    set.hmajor = 1;
    for (int wi = 0; wi < 2; ++wi)
        for (int p = 0; p < PARTS<PASSES>; ++p) {
            set.src[set.n] = w[1 + 2 * wi];
            set.orient[set.n] = s9::IMG_T;
            set.part[set.n++] = p;
        }
    cudaError_t err = s9::launch_images_half<NW>(set, img, stream);
    if (err != cudaSuccess) return err;
    auto kernel = egnn_fwd_sm90_hd512<PASSES, In>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdLayout::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G, s9::THREADS, FwdLayout::SMEM, stream>>>(
        a, bs, x, cmask, w[0], w[2], w[4], w[5], w[6], img, S > 1 ? part_agg : agg,
        S > 1 ? part_delta : delta, B, L, W, S, per);
    if ((err = cudaGetLastError()) != cudaSuccess || S == 1) return err;
    const size_t n_agg4 = (size_t)B * L * H::HD / 4, n_delta = (size_t)B * L * 3;
    const size_t blocks = (n_agg4 + n_delta + egnn::THREADS - 1) / egnn::THREADS;
    egnn_band_fwd_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), egnn::THREADS, 0, stream>>>(
        part_agg, part_delta, agg, delta, n_agg4, n_delta, S);
    return cudaGetLastError();
}

// f(Int<PASSES>{}, Type<In>{}) for passes 1 or 3 and the input type.
template <class F>
cudaError_t dispatch(int passes, int bf16_in, F&& f) {
    auto by_in = [&](auto p) -> cudaError_t {
        return bf16_in ? f(p, Type<__nv_bfloat16>{}) : f(p, Type<float>{});
    };
    switch (passes) {
        case 1: return by_in(Int<1>{});
        case 3: return by_in(Int<3>{});
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Blocks of the kernel that one SM holds, or a negative CUDA error code.
int egnn_band_fwd_sm90_hd512_blocks_per_sm(int bf16_in, int passes) {
    int n = 0;
    const cudaError_t err = dispatch(passes, bf16_in, [&](auto p_c, auto in_c) {
        auto kernel = egnn_fwd_sm90_hd512<decltype(p_c)::value, typename decltype(in_c)::type>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             FwdLayout::SMEM);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, s9::THREADS,
                                                             FwdLayout::SMEM);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch on `stream`; returns the CUDA error code (0 = success). As
// egnn_band_fwd_sm90_launch at hd 512, with passes (1 or 3 TF32 passes per
// product) and img: 2 x 512^2 floats of scratch in one pass, 4 x 512^2 in
// three.
int egnn_band_fwd_sm90_hd512_launch(const void* a, const void* bs, const float* x,
                                    const float* cmask, const float* w_d, const float* w_e2,
                                    const float* b_e2, const float* w_x1, const float* b_x1,
                                    const float* w_x2, const float* b_x2, float* img, float* agg,
                                    float* delta, float* part_agg, float* part_delta, int B, int L,
                                    int W, int S, int G, int bf16_in, int passes, void* stream) {
    const float* w[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(passes, bf16_in, [&](auto p_c, auto in_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(p_c)::value, In>(static_cast<const In*>(a),
                                                static_cast<const In*>(bs), x, cmask, w, img, agg,
                                                delta, part_agg, part_delta, B, L, W, S, G, s);
    });
}

// The width-512 weight images alone (the layout kernel), for a test against
// the wrapper's numpy mirror: n (1..8) images of srcs[q] in orientation
// orient[q] (0 = IMG_T, 1 = IMG_N), part[q] (0 = big, 1 = small), with nw
// (64 or 128) columns per chunk, in the h-major chunk order if hmajor, into
// img [n][512 * 512].
int egnn_hd512_weight_images(const float* const* srcs, const int* orient, const int* part, int n,
                             int nw, int hmajor, float* img, void* stream) {
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
    switch (nw) {
        case 64: return s9::launch_images_half<64>(set, img, s);
        case 128: return s9::launch_images_half<128>(set, img, s);
        default: return cudaErrorInvalidValue;
    }
}

const char* egnn_band_fwd_sm90_hd512_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
