// Hopper building blocks of the EGNN band kernels above decoder width 512
// (egnn_band_{fwd,bwd}_sm90_wide.cu), in both fp32-chain modes and the bf16
// chain, at a width hd given at run time (a multiple of WIDE_GROUP = 256
// above 512).
//
// Why the activations stream. The shared-tile kernels keep a step's [64][Hd]
// fp32 activation tile in shared memory; at Hd 1024 it would take 256 KiB,
// more than a block may have. Here every product's A operand streams: the
// epilogue (or fill) that makes an activation writes it to the block's own
// device-memory rows (the "stream buffers", two per block, ping-pong), in
// the K-major 128-byte-swizzled layout of the shared tiles (sw_off(r, k, 64):
// K block kc is one contiguous [64][32] chunk of 8 KiB), and a producer
// thread brings each K block back with one cp.async.bulk, beside the weight
// chunk that meets it, into one ring stage.
//
// Columns. A product's Hd output columns go in column passes of NC = 2 x NW
// columns: consumer warpgroup c takes columns p NC + c NW .. + NW of pass p
// (m64nNWk8 wgmma), both reading the same A chunk. NW = 128 in one pass (64
// accumulator registers); 64 in 3xTF32, where the big terms' 32-K step sums
// (two buffers) and the small terms keep their own accumulators. Each pass
// reads every K block of A again: Hd / NC passes of 64 x Hd x 4 bytes each.
// The A stream is the dear one: each block reads its own rows, at the L2's
// rate for spread reads, where every block reads the same weight chunks.
//
// Weight images. An Hd x Hd weight streams as chunks of NC output rows x 32
// K values in the order (column pass p, K block kc), each chunk a K-major
// 128-byte-swizzled [NC][32] tile, so consumer c's B operand starts NW rows
// (NW x 128 bytes, 1024-aligned) into it. Values are rounded to TF32 (big:
// rna(v)); 3xTF32 also streams the small part rna(v - rna(v)). One layout
// kernel (weight_images_wide) writes the images a call needs into scratch.
//
// A ring stage: [A chunk][W chunk][W small part (3xTF32)], 40 KiB, filled
// by one full-barrier phase and released by the eight consumer warps. In
// 3xTF32 the A chunk's small part, rna(A - trunc(A)), is made in shared
// memory instead of streamed: the 256 consumer threads split each chunk
// into one of three split buffers and meet at a named barrier before its
// products (a buffer is rewritten three chunks later, once both consumer
// warpgroups have waited for the products that read it).
//
// The bf16 chain (CB) runs the one-pass configuration (Cfg<1>) on bf16
// operands (egnn_sm90.cuh: "the bf16 chain"): stream rows, A chunks and
// images in bf16, two K values a word, so a K block of 128 bytes holds 64
// K values (hd / 64 K blocks a column pass: half the A stream's bytes of one
// pass), and the products are m64n128k16.
//
// Ordering of the stream buffers. The consumers write an activation with
// generic stores; the producer reads it through the async proxy. Each
// writer fences its stores to the async proxy (fence.proxy.async.global),
// the consumer warpgroups meet at a named barrier, and one thread arrives on
// the block's `act` mbarrier, which the producer waits on before it streams
// the next product.

#pragma once

#include "egnn_sm90.cuh"

namespace egnn {
namespace sm90 {
namespace wide {

constexpr int ACHUNK = M * KB;           // floats of an activation chunk: [64][32], 8 KiB
constexpr int CT = CONSUMERS * WG;       // consumer threads
constexpr int BAR_C = 1;                 // named barrier of both consumer warpgroups

template <int PASSES>
struct Cfg {
    static_assert(PASSES == 1 || PASSES == 3, "1 or 3 TF32 passes");
    static constexpr int NW = PASSES == 1 ? 128 : 64;       // columns per consumer and pass
    static constexpr int NC = CONSUMERS * NW;               // columns per pass
    static constexpr int PARTS = PASSES == 3 ? 2 : 1;       // weight images: big (and small)
    static constexpr int WCHUNK = NC * KB;                  // floats of a weight chunk
    static constexpr int STAGE = ACHUNK + PARTS * WCHUNK;   // floats of a ring stage
    static constexpr int STAGES = PASSES == 1 ? 5 : 4;
    static constexpr int SPLITS = PASSES == 3 ? 3 : 0;      // split buffers of ACHUNK floats
    static constexpr int ACC = NW / 2;                      // accumulator floats per thread
    static constexpr int W_BIG = ACHUNK;                    // offsets within a stage (floats)
    static constexpr int W_SMALL = W_BIG + WCHUNK;
    static_assert((STAGE * 4) % 1024 == 0 && (NW * KB * 4) % 1024 == 0, "1024-byte aligned tiles");
};

// ---- the layout kernel ----------------------------------------------------------

// Image element e of an hd x hd weight w in orientation `orient`, part 0
// (big) or 1 (small), in chunks of nc rows x 32 K, order (column pass, K block).
__device__ __forceinline__ float image_value_wide(const float* __restrict__ w, int orient,
                                                  int part, int hd, int nc, size_t e) {
    const int nkc = hd / KB, chunk = nc * KB;
    const int q = (int)(e / chunk), r = (int)(e % chunk);
    const int nl = r / KB, pos = r % KB;
    const int kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3);
    const int n = (q / nkc) * nc + nl, k = (q % nkc) * KB + kl;
    const float v = orient == IMG_T ? w[(size_t)k * hd + n] : w[(size_t)n * hd + k];
    const float big = __uint_as_float(rna_tf32(v));
    return part ? __uint_as_float(rna_tf32(v - big)) : big;
}

// img[q] = image of (src[q], orient[q], part[q]) for q < n (at most 8).
struct WideImageSet {
    const float* src[8];
    int orient[8];
    int part[8];
    int n;
};

__global__ void __launch_bounds__(256) weight_images_wide(WideImageSet set, int hd, int nc,
                                                          float* __restrict__ img) {
    const size_t per = (size_t)hd * hd;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < set.n * per;
         idx += (size_t)gridDim.x * blockDim.x) {
        const int q = (int)(idx / per);
        img[idx] = image_value_wide(set.src[q], set.orient[q], set.part[q], hd, nc, idx % per);
    }
}

inline cudaError_t launch_images_wide(const WideImageSet& set, int hd, int nc, float* img,
                                      cudaStream_t stream) {
    if (set.n < 1 || set.n > 8 || hd % KB || hd % nc) return cudaErrorInvalidValue;
    const size_t n = (size_t)set.n * hd * hd;
    const size_t blocks = (n + 255) / 256;
    weight_images_wide<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(set, hd, nc,
                                                                                      img);
    return cudaGetLastError();
}

// ---- stream-buffer ordering -------------------------------------------------------

// this thread's generic stores to device memory, ordered before later
// async-proxy reads (the bulk copies of the producer)
__device__ __forceinline__ void fence_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Consumers: the activation just written is complete. Every consumer
// thread calls it; one arrival completes the phase the producer waits on.
__device__ __forceinline__ void publish(uint64_t* act, int tid) {
    fence_async_global();
    named_sync(BAR_C, CT);
    if (tid == 0) mbar_arrive(act);
}

// ---- the producer ---------------------------------------------------------------

// One thread: wait for the product's activation (`act` phase), then stream
// its chunks, (column pass p, K block kc): A chunk kc of the activation
// rows `x`, and weight chunk (p, kc) of the image (and of its small part).
template <int PASSES, bool CB = false>
__device__ __forceinline__ void produce(const float* x, const float* img_big,
                                        const float* img_small, int hd, float* ring,
                                        uint64_t* full, uint64_t* empty, uint64_t* act,
                                        uint32_t& act_phase, RingPos& rp) {
    using C = Cfg<PASSES>;
    mbar_wait(act, act_phase);
    act_phase ^= 1u;
    fence_async_global();
    const int nkc = (CB ? hd / 2 : hd) / KB, np = hd / C::NC;
    for (int p = 0; p < np; ++p)
        for (int kc = 0; kc < nkc; ++kc) {
            mbar_wait(&empty[rp.stage], rp.phase ^ 1u);
            float* st = ring + (size_t)rp.stage * C::STAGE;
            const size_t wq = ((size_t)p * nkc + kc) * C::WCHUNK;
            mbar_expect_tx(&full[rp.stage], C::STAGE * 4);
            bulk_load(st, x + (size_t)kc * ACHUNK, ACHUNK * 4, &full[rp.stage]);
            bulk_load(st + C::W_BIG, img_big + wq, C::WCHUNK * 4, &full[rp.stage]);
            if constexpr (PASSES == 3)
                bulk_load(st + C::W_SMALL, img_small + wq, C::WCHUNK * 4, &full[rp.stage]);
            rp.next<C::STAGES>();
        }
}

// ---- the consumers ----------------------------------------------------------------

// Consumer warpgroup `wg`: one product, pass by pass. Each pass walks the K
// blocks; after its products are complete, epi(p, acc) gets the pass's
// NW columns (p NC + wg NW ..) in the accumulator layout of egnn_sm90.cuh.
// side(kc, stage) runs in pass 0 after K block kc's products are issued,
// while they run (it may read the stage). Lane 0 of each warp releases a
// stage once the warp's products that read it have completed.
// 3xTF32: per K block the consumer threads (tid: 0..255) split the A chunk
// into split buffer sq (Xs = rna(X - trunc(X)); sq counts chunks mod
// SPLITS across calls), then Xt.Ws into the small terms' accumulator, Xt.Wb
// into a step sum (two buffers in turn) and Xs.Wb into the small terms';
// each step sum (32 K) is added to acc in round-to-nearest fp32 once the
// next K block's products are issued and it has completed, the small terms
// at the pass's end. One pass: acc accumulates on the tensor cores.
template <int PASSES, bool CB, class Side, class Epi>
__device__ __forceinline__ void consume(const float* ring, float* split, int& sq,
                                        uint64_t* full, uint64_t* empty,
                                        RingPos& rp, int hd, int wg, int tid, int lane,
                                        float (&acc)[Cfg<PASSES>::ACC],
                                        float (&tmp0)[Cfg<PASSES>::ACC],
                                        float (&tmp1)[Cfg<PASSES>::ACC],
                                        float (&sml)[Cfg<PASSES>::ACC], Side side, Epi epi) {
    using C = Cfg<PASSES>;
    static_assert(PASSES == 1 || !CB, "the bf16 chain takes one pass");
    constexpr int NW = C::NW, ACC = C::ACC;
    const int nkc = (CB ? hd / 2 : hd) / KB, np = hd / C::NC;
    for (int p = 0; p < np; ++p) {
        int prev = -1;
        pin(acc);
        if constexpr (PASSES == 3) {
            pin(tmp0);
            pin(tmp1);
            pin(sml);
        }
        // K block kc into the step sum t (3xTF32) or acc
        auto chunk = [&](int kc, float (&t)[ACC]) {
            mbar_wait(&full[rp.stage], rp.phase);
            const float* st = ring + (size_t)rp.stage * C::STAGE;
            const float* a = st;
            const float* wb = st + C::W_BIG + wg * NW * KB;
            wg_fence();
            if constexpr (PASSES == 1) {
#pragma unroll
                for (int k8 = 0; k8 < KB / 8; ++k8)
                    Wgmma<NW, CB>::mma(acc, desc(a + 8 * k8), desc(wb + 8 * k8), (kc | k8) != 0);
            } else {
                float* as = split + sq * ACHUNK;   // free: its last readers, three chunks
                                                   // back, are complete (see Cfg)
#pragma unroll
                for (int i = tid; i < ACHUNK / 4; i += CT) {
                    const float4 v = reinterpret_cast<const float4*>(a)[i];
                    reinterpret_cast<float4*>(as)[i] =
                        make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
                }
                fence_async_smem();
                named_sync(BAR_C, CT);
                sq = sq + 1 == C::SPLITS ? 0 : sq + 1;
                const float* ws = st + C::W_SMALL + wg * NW * KB;
#pragma unroll
                for (int k8 = 0; k8 < KB / 8; ++k8)
                    Wgmma<NW>::mma(sml, desc(a + 8 * k8), desc(ws + 8 * k8), (kc | k8) != 0);
#pragma unroll
                for (int k8 = 0; k8 < KB / 8; ++k8) {
                    Wgmma<NW>::mma(t, desc(a + 8 * k8), desc(wb + 8 * k8), k8 != 0);
                    Wgmma<NW>::mma(sml, desc(as + 8 * k8), desc(wb + 8 * k8), 1);
                }
            }
            wg_commit();
            if (p == 0) side(kc, st);
            wg_wait<1>();   // K block kc - 1 has completed
            if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
            prev = rp.stage;
            rp.next<C::STAGES>();
        };
        // acc (+)= a completed step sum, in round-to-nearest fp32
        auto add = [&](float (&t)[ACC], bool first) {
            pin(t);
#pragma unroll
            for (int i = 0; i < ACC; ++i) acc[i] = first ? t[i] : acc[i] + t[i];
        };
#pragma unroll 1
        for (int kc = 0; kc < nkc; kc += 2) {   // nkc is even: hd is a multiple of 256 (128 in bf16)
            chunk(kc, tmp0);
            if constexpr (PASSES == 3)
                if (kc > 0) add(tmp1, false);
            chunk(kc + 1, tmp1);
            if constexpr (PASSES == 3) add(tmp0, kc == 0);
        }
        wg_wait<0>();
        pin(acc);
        if constexpr (PASSES == 3) {
            add(tmp1, false);
            pin(sml);
#pragma unroll
            for (int i = 0; i < ACC; ++i) acc[i] += sml[i];
        }
        if (lane == 0) mbar_arrive(&empty[prev]);
        epi(p, acc);
    }
}

// ---- the activation fill ------------------------------------------------------------

// X = silu(pre), pre = a_i + bs_j + d2 * w_d, of a step's 64 edge rows (row
// r: receiver i0 + r % T, sender row_j[r]) into the stream rows x (K-major
// swizzled, sw_off(r, k, 64)): rounded to TF32 in one pass; exact in
// 3xTF32. With dpre also silu'(pre) into dpre [64][hd] (row-major). Rows of
// invalid edges are 0. Consumer thread t of CT, four columns at a time;
// ACCURATE: egnn_tile.cuh's sigmoid, else the fast one.
template <int PASSES, bool ACCURATE, class In>
__device__ __forceinline__ void fill(float* __restrict__ x,
                                     const In* __restrict__ a_b, const In* __restrict__ bs_b,
                                     const float* __restrict__ w_d, const float* row_valid,
                                     const float* row_d2, const int* row_j, int i0, int hd,
                                     int t, float* __restrict__ dpre = nullptr) {
    const int hq = hd / 4;
#pragma unroll 2
    for (int idx = t; idx < M * hq; idx += CT) {
        const int r = idx / hq, c = 4 * (idx % hq);
        float pv[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
        if (row_valid[r] > 0.f) {
            const float4 av = load4(a_b + (size_t)(i0 + r % T) * hd + c);
            const float4 bv = load4(bs_b + (size_t)row_j[r] * hd + c);
            const float4 wd = load4(w_d + c);
            const float d2 = row_d2[r];
            const float pre[4] = {av.x + bv.x + d2 * wd.x, av.y + bv.y + d2 * wd.y,
                                  av.z + bv.z + d2 * wd.z, av.w + bv.w + d2 * wd.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float s = ACCURATE ? sigmoid(pre[q]) : sigmoid_fast(pre[q]);
                pv[q] = pre[q] * s;
                dv[q] = dsilu_of(pre[q], s);
            }
        }
        const int off = sw_off(r, c, M);
        if constexpr (PASSES == 1)
            *reinterpret_cast<float4*>(x + off) =
                make_float4(tf32(pv[0]), tf32(pv[1]), tf32(pv[2]), tf32(pv[3]));
        else
            *reinterpret_cast<float4*>(x + off) = make_float4(pv[0], pv[1], pv[2], pv[3]);
        if (dpre)
            *reinterpret_cast<float4*>(dpre + (size_t)r * hd + c) =
                make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
}

// Store the activation (v0, v1) at columns (col, col + 1) of row r into the
// stream rows x: rounded to TF32 if ROUND, else exact; in the bf16 chain
// (CB) the bf16 values as one word.
template <bool ROUND, bool CB = false>
__device__ __forceinline__ void put2(float* x, int r, int col, float v0, float v1) {
    if constexpr (CB)
        put2_bf16(x, r, col, bf2r(v0, v1));
    else
        *reinterpret_cast<float2*>(x + sw_off(r, col, M)) =
            ROUND ? make_float2(tf32(v0), tf32(v1)) : make_float2(v0, v1);
}

// ---- rows of a step -------------------------------------------------------------------

// The first two consumer warps (t < 64): edge row t of step s, its validity,
// d2, sender j and rel into the rows in shared memory (and, with g_delta,
// cw = g_delta_i . rel); flags[t / 32] = any valid row in the warp.
__device__ __forceinline__ void step_rows(const float* __restrict__ x,
                                          const float* __restrict__ cmask,
                                          const float* __restrict__ g_delta, size_t row0, int i0,
                                          int s, int t, int L, int W, float* row_valid,
                                          float* row_d2, int* row_j, float* row_rel,
                                          float* row_cw, int* flags) {
    int i, j;
    const bool v = edge_row(cmask, row0, i0, s, t, L, W, i, j);
    float rel[3] = {0.f, 0.f, 0.f}, d2 = 0.f, cw = 0.f;
    if (v) {
#pragma unroll
        for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
        d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
        if (g_delta) {
            const float* gd = g_delta + (row0 + i) * 3;
            cw = gd[0] * rel[0] + gd[1] * rel[1] + gd[2] * rel[2];
        }
    }
    row_valid[t] = v ? 1.f : 0.f;
    row_d2[t] = d2;
    row_j[t] = j;
    if (row_cw) row_cw[t] = cw;
#pragma unroll
    for (int c = 0; c < 3; ++c) row_rel[t * 3 + c] = rel[c];
    const unsigned any = __ballot_sync(0xffffffffu, v);
    if (t % 32 == 0) flags[t / 32] = any != 0u;
}

// The producer warp (all 32 lanes): whether step s of receiver tile i0 has
// a valid edge (the consumers skip the same steps).
__device__ __forceinline__ bool step_has_edge(const float* __restrict__ cmask, size_t row0,
                                              int i0, int s, int L, int W, int lane) {
    bool v = false;
    for (int r = lane; r < M; r += 32) {
        int i, j;
        v |= edge_row(cmask, row0, i0, s, r, L, W, i, j);
    }
    return __any_sync(0xffffffffu, v);
}

}  // namespace wide
}  // namespace sm90
}  // namespace egnn
