// Hopper building blocks of the EGNN band kernels on wgmma (the one-pass
// egnn_band_{fwd,bwd}_sm90.cu and the shared-tile
// egnn_band_{fwd,bwd}_sm90_hd512.cu): warpgroup products (wgmma) on TF32
// operands in shared memory, a ring of weight chunks filled by bulk
// asynchronous copies under mbarriers, and the operand layout both sides
// agree on.
//
// Operand layout (K-major, 128-byte swizzle). wgmma's TF32 form takes both
// operands K-major only (no transpose bit): a 64-row A tile [64][K] and a
// B tile [N][K], each row's K values contiguous. K is cut into blocks of 32
// floats (128 bytes); block kb of an R-row tile starts at kb * R * 128
// bytes, row r of it at r * 128, and its 16-byte chunk c (floats 4c..4c+3)
// lies at chunk position c ^ (r % 8): the 128-byte swizzle, which the
// hardware undoes on the address bits (bits 4-6 XOR bits 7-9), so every
// tile starts 1024-byte aligned. A matrix descriptor names the start, the
// 1024 bytes between 8-row groups (SBO) and the swizzle; a k8 step inside a
// block adds 32 bytes to the start (sw_off below is the same map).
//
// Weight images. The ring streams an Hd x Hd weight as chunks of NW output
// rows x 32 K values (NW = min(Hd, 128) columns per product: m64nNWk8), in
// the order (K block kc, column group h), h fastest, each chunk already in
// the swizzled byte order, so one cp.async.bulk lands it as the descriptor
// reads it. Values are rounded to TF32 with cvt.rna's rounding when the
// image is written (wgmma would drop the low 13 bits otherwise). Two
// orientations: IMG_T, B[n][k] = W[k][n], for x @ W (the forward products);
// IMG_N, B[n][k] = W[n][k], for x @ W^T (the cotangent products). One
// small kernel (weight_images) writes the images a call needs into scratch
// the wrapper allocates, from the same C entry as the band kernel.
//
// Accumulators (m64nN, fp32): in a warpgroup, warp w, lane (g = lane / 4,
// t = lane % 4) holds rows 16 w + g and 16 w + 8 + g; register 4 j + e is
// row 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2). With edge row r =
// (offset slot r / 8, receiver r % 8), both rows of a lane belong to
// receiver g.

#pragma once

#include "egnn_tile.cuh"

namespace egnn {
namespace sm90 {

constexpr int WG = 128;           // threads of a warpgroup
constexpr int CONSUMERS = 2;      // consumer warpgroups of the band kernels
// the consumer warpgroups and a producer warpgroup (one working warp)
constexpr int THREADS = (CONSUMERS + 1) * WG;
constexpr int KB = 32;            // K values per 128-byte row of a K block
// Registers (setmaxnreg): an SM's four sub-partitions hold 16,384 each, and
// a 384-thread block puts three warps on each, so a thread starts at 168;
// the producer warpgroup gives its share up (40) and the consumers take it
// (232: the m64n256 fp32 accumulator is 128 per thread). The consumer
// code must lie in the other branch of one if / else, or ptxas ignores it.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// empty-barrier arrivals per ring chunk: lane 0 of every consumer warp
constexpr int EMPTY_ARRIVALS = CONSUMERS * WG / 32;

// Output columns per product (m64nNWk8) and column groups at width HD.
// With BF (the bf16 chain) the operands are bf16, two to a 4-byte word:
// a 128-byte row of a K block holds 64 K values, the K extent is HD / 2
// words (32 at HD 32, whose K block is half used: two k16 steps, KS, of
// its four), and the ring chunks and accumulators are as in TF32.
template <int HD, bool BF = false>
struct Cols {
    static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "a width of 32 to 256");
    static constexpr int NW = HD < 128 ? HD : 128;
    static constexpr int NH = HD / NW;
    static constexpr int KW = BF ? (HD / 2 < KB ? KB : HD / 2) : HD;   // words of K
    static constexpr int KS = BF && HD < 64 ? 2 : KB / 8;             // 32-byte k steps a K block
    static constexpr int CHUNK = NW * KB;            // floats (words) of a ring chunk
    static constexpr int NQ = (KW / KB) * NH;        // chunks of one product
    static constexpr int ACC = NW / 2;               // accumulator floats per thread and group
};

// Float offset of element (row, k) in a K-major 128-byte-swizzled tile of
// `rows` rows.
__host__ __device__ constexpr int sw_off(int row, int k, int rows) {
    return (k / KB) * rows * KB + row * KB + ((((k / 4) & 7) ^ (row & 7)) << 2) + (k & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a K-major, 128-byte-swizzled operand at p
// (1024-byte aligned tile; p may add k8 steps of 32 bytes): start >> 4,
// leading offset 1 (unused by swizzled K-major layouts), 1024 bytes between
// 8-row groups, layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(const float* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ---- mbarriers and bulk copies --------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and expect `bytes` of asynchronous copies to complete the phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed; a wait longer than
// MBAR_CYCLES SM cycles (~10 s: a ring out of step, never a slow step)
// traps, so a fault in the protocol ends the launch with an error instead of
// hanging the card
constexpr long long MBAR_CYCLES = 1ll << 34;
__device__ __forceinline__ uint32_t mbar_try(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    return done;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try(addr, parity)) return;   // the clock is read only once a wait spins
    const long long t0 = clock64();
    for (uint32_t spins = 1; !mbar_try(addr, parity); ++spins)
        if ((spins & 1023u) == 0 && clock64() - t0 > MBAR_CYCLES) __trap();
}
// one 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// generic-proxy writes to shared memory, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier `id` (1..15) over `n` threads
__device__ __forceinline__ void named_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N)); }

// silu and its derivative (egnn_tile.cuh) with the fast exponential and
// division (__expf, __fdividef, a few ulp; ~1e-6 relative at |x| ~ 20):
// the one-pass mode's TF32 operands (~1e-3 relative) dwarf that, and so
// does 3xTF32's truncating accumulation (its drift reached 0.7 of the fp32
// tolerance at Hd 256 with the fast and with the accurate forms alike,
// PERF.md). Large |x| still give x * 0 (or 0) and x, and s in {0, 1}.
__device__ __forceinline__ float silu_fast(float x) { return __fdividef(x, 1.0f + __expf(-x)); }
__device__ __forceinline__ float sigmoid_fast(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
// silu'(x) from s = sigmoid(x), which silu(x) = x s shares
__device__ __forceinline__ float dsilu_of(float x, float s) { return s * (1.0f + x * (1.0f - s)); }
// the fast forms where FAST (one pass; 3xTF32 up to Hd 256, where the
// accurate ones took a third of kernel 1's time), egnn_tile.cuh's accurate
// ones (expf, IEEE division) otherwise (3xTF32 at 512)
template <bool FAST>
__device__ __forceinline__ float sigmoid_m(float x) { return FAST ? sigmoid_fast(x) : sigmoid(x); }
template <bool FAST>
__device__ __forceinline__ float silu_m(float x) { return FAST ? silu_fast(x) : silu(x); }

// ---- warpgroup products ------------------------------------------------------

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64nN, fp32) = A (64 x 8, TF32) * B (N x 8, TF32) + (scale_d ? d : 0),
// or with BF (the bf16 chain) A (64 x 16, bf16) * B (N x 16, bf16): the same
// 32 bytes of a K-major 128-byte row a step, the same accumulator layout;
// both operands K-major (imm-trans-a / imm-trans-b 0).
template <int N, bool BF = false>
struct Wgmma;

#define EGNN_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define EGNN_F8(d, i) EGNN_F4(d, i), EGNN_F4(d, i + 4)
#define EGNN_F16(d, i) EGNN_F8(d, i), EGNN_F8(d, i + 8)
#define EGNN_F32(d, i) EGNN_F16(d, i), EGNN_F16(d, i + 16)
#define EGNN_F64(d, i) EGNN_F32(d, i), EGNN_F32(d, i + 32)
// REGS: the accumulator operands' list; IA, IB, IS: the descriptors' and
// scale_d's operand numbers; the rest: the accumulator constraints
#define EGNN_WGMMA(N, REGS, IA, IB, IS, ...)                                                   \
    template <bool BF>                                                                         \
    struct Wgmma<N, BF> {                                                                      \
        __device__ __forceinline__ static void mma(float (&d)[N / 2], uint64_t da, uint64_t db, \
                                                   int scale_d) {                               \
            if constexpr (BF)                                                                  \
                asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"                   \
                             "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " REGS   \
                             ", " IA ", " IB ", p, 1, 1, 0, 0;\n}\n"                          \
                             : __VA_ARGS__ : "l"(da), "l"(db), "r"(scale_d));                  \
            else                                                                               \
                asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"                   \
                             "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " REGS    \
                             ", " IA ", " IB ", p, 1, 1;\n}\n"                                \
                             : __VA_ARGS__ : "l"(da), "l"(db), "r"(scale_d));                  \
        }                                                                                      \
    };

EGNN_WGMMA(16, "{%0, %1, %2, %3, %4, %5, %6, %7}", "%8", "%9", "%10", EGNN_F8(d, 0))
EGNN_WGMMA(32, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}", "%16",
           "%17", "%18", EGNN_F16(d, 0))
EGNN_WGMMA(64,
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
           "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}",
           "%32", "%33", "%34", EGNN_F32(d, 0))
EGNN_WGMMA(128,
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
           "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
           "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
           "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}",
           "%64", "%65", "%66", EGNN_F64(d, 0))
#undef EGNN_WGMMA
#undef EGNN_F64
#undef EGNN_F32
#undef EGNN_F16
#undef EGNN_F8
#undef EGNN_F4

// ---- the weight ring ---------------------------------------------------------

// A ring position: stage and the parity of its current round.
struct RingPos {
    int stage = 0;
    uint32_t phase = 0;
    template <int STAGES>
    __device__ __forceinline__ void next() {
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
        }
    }
};

// Producer (one thread): stream NQ chunks of CHUNK floats of one weight
// image into the ring, each stage once its last reader has released it.
template <int NQ, int CHUNK, int STAGES>
__device__ __forceinline__ void produce_chunks(const float* __restrict__ img, float* ring,
                                               uint64_t* full, uint64_t* empty, RingPos& rp) {
    for (int q = 0; q < NQ; ++q) {
        mbar_wait(&empty[rp.stage], rp.phase ^ 1u);
        mbar_expect_tx(&full[rp.stage], CHUNK * 4);
        bulk_load(ring + rp.stage * CHUNK, img + (size_t)q * CHUNK, CHUNK * 4, &full[rp.stage]);
        rp.next<STAGES>();
    }
}

template <int HD, int STAGES, bool BF = false>
__device__ __forceinline__ void produce(const float* __restrict__ img, float* ring,
                                        uint64_t* full, uint64_t* empty, RingPos& rp) {
    produce_chunks<Cols<HD, BF>::NQ, Cols<HD, BF>::CHUNK, STAGES>(img, ring, full, empty, rp);
}

// Consumer warpgroup: acc[h] = A @ (column group h of the streamed weight),
// A the warpgroup's [64][HD] tile (K-major, swizzled). One commit group per
// chunk, one group left in flight; lane 0 of each warp releases a stage
// once its warp's products that read it have completed. Every thread of
// the warpgroup calls it. side(q) runs after chunk q's products are issued,
// while they run: work that only reads A, or touches neither A nor acc.
struct NoSide {
    __device__ __forceinline__ void operator()(int) const {}
};

// The general form: A [64][KD], NH column groups of NW (chunks of NW x 32,
// in the order (K block, group)); with `accumulate` the products add to acc
// instead of starting from zero. BF: bf16 operands, KD in 4-byte words (two
// K values each), KS of a K block's four 32-byte k steps read.
template <int KD, int NW, int NH, int STAGES, bool BF = false, int KS = KB / 8,
          class Side = NoSide>
__device__ __forceinline__ void product_k(const float* A, const float* ring, uint64_t* full,
                                          uint64_t* empty, RingPos& rp, float (&acc)[NH][NW / 2],
                                          int lane, bool accumulate, Side side = Side()) {
    constexpr int CHUNK = NW * KB;
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
    int prev = -1;
#pragma unroll 1
    for (int kc = 0; kc < KD / KB; ++kc) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
            mbar_wait(&full[rp.stage], rp.phase);
            const float* b = ring + rp.stage * CHUNK;
            const float* a = A + kc * 64 * KB;
            wg_fence();
#pragma unroll
            for (int k8 = 0; k8 < KS; ++k8)
                Wgmma<NW, BF>::mma(acc[h], desc(a + 8 * k8), desc(b + 8 * k8),
                                   accumulate || (kc | k8) != 0);
            wg_commit();
            side(kc * NH + h);
            wg_wait<1>();
            if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
            prev = rp.stage;
            rp.next<STAGES>();
        }
    }
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
    if (lane == 0) mbar_arrive(&empty[prev]);
}

template <int HD, int STAGES, bool BF = false, class Side = NoSide>
__device__ __forceinline__ void product(const float* A, const float* ring, uint64_t* full,
                                        uint64_t* empty, RingPos& rp,
                                        float (&acc)[Cols<HD>::NH][Cols<HD>::ACC], int lane,
                                        Side side = Side()) {
    using C = Cols<HD, BF>;
    product_k<C::KW, C::NW, C::NH, STAGES, BF, C::KS>(A, ring, full, empty, rp, acc, lane, false,
                                                      side);
}

// Consumer warpgroup with no valid edge in its step: walk one product's
// chunks in step with the other warpgroup, releasing each unread.
template <int HD, int STAGES, bool BF = false>
__device__ __forceinline__ void pass_product(uint64_t* full, uint64_t* empty, RingPos& rp,
                                             int lane) {
    for (int q = 0; q < Cols<HD, BF>::NQ; ++q) {
        mbar_wait(&full[rp.stage], rp.phase);
        if (lane == 0) mbar_arrive(&empty[rp.stage]);
        rp.next<STAGES>();
    }
}

// ---- weight images -----------------------------------------------------------

constexpr int IMG_T = 0;   // B[n][k] = W[k][n]  (x @ W)
constexpr int IMG_N = 1;   // B[n][k] = W[n][k]  (x @ W^T)

// Image element e of an HD x HD weight w in orientation `orient`: chunk
// e / CHUNK = (kc, h), then row n_local and swizzled position within it.
template <int HD>
__device__ __forceinline__ float image_value(const float* __restrict__ w, int orient, int e) {
    using C = Cols<HD>;
    const int q = e / C::CHUNK, r = e % C::CHUNK;
    const int nl = r / KB, pos = r % KB;
    const int kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3);
    const int n = (q % C::NH) * C::NW + nl, k = (q / C::NH) * KB + kl;
    const float v = orient == IMG_T ? w[k * HD + n] : w[n * HD + k];
    return __uint_as_float(rna_tf32(v));
}

// img[q] = image of (srcs[q], orient[q]) for q < n (at most 4), each HD*HD floats.
struct ImageSet {
    const float* src[4];
    int orient[4];
    int n;
};

template <int HD>
__global__ void __launch_bounds__(256) weight_images(ImageSet set, float* __restrict__ img) {
    const int per = HD * HD;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < set.n * per;
         idx += gridDim.x * blockDim.x) {
        const int q = idx / per;
        img[idx] = image_value<HD>(set.src[q], set.orient[q], idx % per);
    }
}

template <int HD>
cudaError_t launch_images(const ImageSet& set, float* img, cudaStream_t stream) {
    const int n = set.n * HD * HD;
    weight_images<HD><<<(n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024, 256, 0, stream>>>(set, img);
    return cudaGetLastError();
}

// ---- rows of a step ------------------------------------------------------------

// Edge row r of step s for receiver tile i0 of batch row b: its sender j
// and validity (band offset in range, both residues unmasked).
__device__ __forceinline__ bool edge_row(const float* __restrict__ cmask, size_t row0, int i0,
                                         int s, int r, int L, int W, int& i, int& j) {
    const int e = s * OPS + r / T;
    i = i0 + r % T;
    j = 0;
    if (e >= 2 * W || i >= L) return false;
    j = i + band_offset(e, W);
    return j >= 0 && j < L && cmask[row0 + i] > 0.5f && cmask[row0 + j] > 0.5f;
}

// cvt.rna.tf32.f32's rounding of v (egnn_tile.cuh: rna_tf32), as an fp32 value.
__device__ __forceinline__ float tf32(float v) { return __uint_as_float(rna_tf32(v)); }
// 3xTF32's small part of an operand that wgmma reads truncated (its low 13
// bits dropped): rna(v - trunc(v)), so that trunc(v) + it holds v to ~2^-21.
__device__ __forceinline__ float tf32_lo(float v) {
    return tf32(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
}

// A = silu(pre), pre = a_i + bs_j + d2 * w_d, of a step's 64 edge rows
// (row r: receiver i0 + r % T, sender row_j[r]), rounded to TF32 (or, with
// ROUND false, exact: the 3xTF32 mode; sigmoid_m<FAST>), in
// the K-major swizzled tile, with As also its small part tf32_lo(A) into
// the split tile As (3xTF32 at widths up to 256), and with dpre also
// silu'(pre) into dpre [64][HD] (row-major, fp32); rows of invalid edges
// are 0. Thread t of the NT that fill it reads 16 bytes of a_i and of bs_j
// at a time.
template <int HD, class In, int NT = WG, bool ROUND = true, bool FAST = ROUND>
__device__ __forceinline__ void fill_pre(float* A, const In* __restrict__ a_b,
                                         const In* __restrict__ bs_b, const float* __restrict__ w_d,
                                         const float* row_valid, const float* row_d2,
                                         const int* row_j, int i0, int t,
                                         float* __restrict__ dpre = nullptr,
                                         float* __restrict__ As = nullptr) {
    constexpr int NV = Vec<In>::N, HDV = HD / NV;
    auto rd = [](float v) { return ROUND ? __uint_as_float(rna_tf32(v)) : v; };
#pragma unroll 4
    for (int idx = t; idx < M * HDV; idx += NT) {
        const int r = idx / HDV, c = NV * (idx % HDV);
        float pv[NV], dv[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) pv[q] = dv[q] = 0.f;
        if (row_valid[r] > 0.f) {
            float av[NV], bv[NV];
            load_vec(a_b + (size_t)(i0 + r % T) * HD + c, av);
            load_vec(bs_b + (size_t)row_j[r] * HD + c, bv);
            const float d2 = row_d2[r];
#pragma unroll
            for (int q4 = 0; q4 < NV / 4; ++q4) {
                const float4 wd = load4(w_d + c + 4 * q4);
                const float w4[4] = {wd.x, wd.y, wd.z, wd.w};
#pragma unroll
                for (int q = 4 * q4; q < 4 * q4 + 4; ++q) {
                    const float pre = av[q] + bv[q] + d2 * w4[q % 4];
                    const float s = sigmoid_m<FAST>(pre);
                    pv[q] = pre * s;
                    dv[q] = dsilu_of(pre, s);
                }
            }
        }
#pragma unroll
        for (int q4 = 0; q4 < NV / 4; ++q4)
            *reinterpret_cast<float4*>(A + sw_off(r, c + 4 * q4, M)) =
                make_float4(rd(pv[4 * q4]), rd(pv[4 * q4 + 1]), rd(pv[4 * q4 + 2]),
                            rd(pv[4 * q4 + 3]));
        if (As) {
#pragma unroll
            for (int q4 = 0; q4 < NV / 4; ++q4)
                *reinterpret_cast<float4*>(As + sw_off(r, c + 4 * q4, M)) =
                    make_float4(tf32_lo(pv[4 * q4]), tf32_lo(pv[4 * q4 + 1]),
                                tf32_lo(pv[4 * q4 + 2]), tf32_lo(pv[4 * q4 + 3]));
        }
        if (dpre) {
#pragma unroll
            for (int q4 = 0; q4 < NV / 4; ++q4)
                *reinterpret_cast<float4*>(dpre + (size_t)r * HD + c + 4 * q4) =
                    make_float4(dv[4 * q4], dv[4 * q4 + 1], dv[4 * q4 + 2], dv[4 * q4 + 3]);
        }
    }
}

// ---- one shared A tile, the columns split between the consumers ----------
//
// The shared-tile kernels (egnn_band_{fwd,bwd}_sm90_hd512.cu): the two
// consumer warpgroups share one 64-row activation tile (128 KiB at Hd 512)
// and each computes its half of the output columns (N = HD / 2) of every
// product, over all HD K values, from its own weight ring. The producer
// warpgroup's first two warps stream one half each. A half image is (K
// block kc, column group h) chunks of NW rows x 32 K values, h fastest, as
// Cols' chunks, or h-major; an image is its two halves in turn (the N-half
// chunk order).
//
// 3xTF32 (PASSES = 3). The tile holds the activation X in fp32; wgmma reads
// an fp32 operand as TF32 by dropping its low 13 bits, so it reads
// trunc(X). With W = Wb + Ws (Wb = rna(W), Ws = rna(W - Wb), two images) a
// product is Xt.Wb + Xt.Ws + Xs.Wb, Xs = rna(X - trunc(X)) (tf32_lo).
// trunc(X) + Xs holds X to ~2^-21 of it, Wb + Ws holds W to ~2^-22; the
// dropped Xs.Ws is ~2^-20 of the product.
// - At Hd 512 no second tile fits: the ring brings Ws, Wb, Wb, and the tile
//   is rewritten in place as Xs between the second and third pass
//   (product_half, split_tile): three streamed images per product.
// - Up to Hd 256 the split tile Xs lies beside X (64 KiB at Hd 256), written
//   by the epilogue that writes X (fill_pre's As, tf32_lo): the ring brings
//   each K block's Ws chunk, then its Wb chunk, which serves Xt.Wb and
//   Xs.Wb (product_split, produce_split): two streamed images per product,
//   and no rewrite, no barrier beyond the one per activation.
// The tensor cores' accumulation rounds toward zero; the big term's sums
// are kept apart from the small terms' (product_split) and, in kernel 1,
// summed 128 K (at 512) or 32 K at a time in round-to-nearest fp32
// (product_hmajor, product_split's GROUP).
// BF (the bf16 chain, at 512): bf16 operands two to a word (Cols), one
// bf16 image per weight (weight_images_bf16).
template <int HD_, int NW_, bool BF = false>
struct Half {
    static constexpr int HD = HD_, N = HD_ / 2;  // width; output columns per consumer
    static constexpr int NW = NW_;               // columns per product (m64nNWk8)
    static constexpr int NH = N / NW;            // column groups per consumer
    static constexpr int KW = BF ? HD / 2 : HD;  // words of K
    static constexpr int CHUNK = NW * KB;        // floats (words) of a ring chunk
    static constexpr int NQ = (KW / KB) * NH;    // chunks of one half image
    static constexpr int ACC = NW / 2;           // accumulator floats per thread and group
    static constexpr int IMG = KW * HD;          // floats (words) of an image
    static_assert(N % NW == 0 && KW % KB == 0, "whole column groups and K blocks");
};

// Image element e of an HD x HD weight w in orientation `orient`, part 0
// (big: rna(v)) or 1 (small: rna(v - rna(v))), in the N-half chunk order;
// within a half the chunks go (K block, column group), the group fastest,
// or with `hmajor` (column group, K block).
template <int HD, int NW>
__device__ __forceinline__ float image_value_half(const float* __restrict__ w, int orient,
                                                  int part, int hmajor, int e) {
    using H = Half<HD, NW>;
    constexpr int NKC = H::HD / KB;
    const int half = e / (H::N * H::HD), eh = e % (H::N * H::HD);
    const int q = eh / H::CHUNK, r = eh % H::CHUNK;
    const int nl = r / KB, pos = r % KB;
    const int kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3);
    const int h = hmajor ? q / NKC : q % H::NH, kc = hmajor ? q % NKC : q / H::NH;
    const int n = half * H::N + h * NW + nl, k = kc * KB + kl;
    const float v = orient == IMG_T ? w[k * H::HD + n] : w[n * H::HD + k];
    const float big = __uint_as_float(rna_tf32(v));
    return part ? __uint_as_float(rna_tf32(v - big)) : big;
}

// img[q] = image of (src[q], orient[q], part[q]) for q < n (at most 8),
// all in the chunk order `hmajor` names.
struct HalfImageSet {
    const float* src[8];
    int orient[8];
    int part[8];
    int n;
    int hmajor;
};

template <int HD, int NW>
__global__ void __launch_bounds__(256) weight_images_half(HalfImageSet set, float* __restrict__ img) {
    constexpr int per = Half<HD, NW>::IMG;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < set.n * per;
         idx += gridDim.x * blockDim.x) {
        const int q = idx / per;
        img[idx] = image_value_half<HD, NW>(set.src[q], set.orient[q], set.part[q], set.hmajor,
                                            idx % per);
    }
}

template <int HD, int NW>
cudaError_t launch_images_half(const HalfImageSet& set, float* img, cudaStream_t stream) {
    const int n = set.n * Half<HD, NW>::IMG;
    weight_images_half<HD, NW><<<(n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048, 256, 0, stream>>>(
        set, img);
    return cudaGetLastError();
}

// The 3xTF32 rewrite of a [64][512] tile in place, X -> rna(X - trunc(X)),
// by thread t of NT, 16 bytes at a time (the layout does not matter: every
// element maps to itself).
template <int NT>
__device__ __forceinline__ void split_tile(float* A, int t) {
#pragma unroll 4
    for (int i = t; i < M * 512 / 4; i += NT) {
        float4 v = reinterpret_cast<float4*>(A)[i];
        v = make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
        reinterpret_cast<float4*>(A)[i] = v;
    }
}

// The h-major form of product_k (chunks in the order (column group h, K
// block kc)) with GROUP K values a step sum: each group of GROUP / 32 K
// blocks accumulates into `tmp` from zero on the tensor cores, whose fp32
// accumulation rounds toward zero, and is added to acc[h] in
// round-to-nearest fp32. Summed whole, the 64 k8 steps of one pass at K 512
// cut every partial sum toward zero (3xTF32 drifted ~2x past rtol 1e-4 at
// Hd 512 that way); a 128-K step sum holds the drift to a quarter of the
// tolerance (PERF.md). GROUP 0: no step sums, acc[h] accumulates directly.
template <int KD, int NW, int NH, int STAGES, int GROUP, bool BF = false, class Side = NoSide>
__device__ __forceinline__ void product_hmajor(const float* A, const float* ring, uint64_t* full,
                                               uint64_t* empty, RingPos& rp,
                                               float (&acc)[NH][NW / 2], float (&tmp)[NW / 2],
                                               int lane, bool accumulate, Side side = Side()) {
    constexpr int CHUNK = NW * KB, NKC = KD / KB, GKC = GROUP ? GROUP / KB : NKC;
    static_assert(NKC % GKC == 0, "whole groups");
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
    int prev = -1;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll 1
        for (int kg = 0; kg < NKC; kg += GKC) {
            if (GROUP) pin(tmp);
#pragma unroll 1
            for (int kc = kg; kc < kg + GKC; ++kc) {
                mbar_wait(&full[rp.stage], rp.phase);
                const float* b = ring + rp.stage * CHUNK;
                const float* a = A + kc * 64 * KB;
                wg_fence();
#pragma unroll
                for (int k8 = 0; k8 < KB / 8; ++k8) {
                    if (GROUP)
                        Wgmma<NW>::mma(tmp, desc(a + 8 * k8), desc(b + 8 * k8),
                                       (kc - kg) | k8);
                    else
                        Wgmma<NW, BF>::mma(acc[h], desc(a + 8 * k8), desc(b + 8 * k8),
                                           accumulate || (kc | k8) != 0);
                }
                wg_commit();
                side(h * NKC + kc);
                wg_wait<1>();
                if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
                prev = rp.stage;
                rp.next<STAGES>();
            }
            if (GROUP) {   // the group's sum, added in round-to-nearest fp32
                wg_wait<0>();
                pin(tmp);
#pragma unroll
                for (int i = 0; i < NW / 2; ++i)
                    acc[h][i] = (accumulate || kg) ? acc[h][i] + tmp[i] : tmp[i];
            }
        }
    }
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
    if (lane == 0) mbar_arrive(&empty[prev]);
}

// One product of the shared [64][512] tile in the mode's passes, into the
// consumer's accumulators: with PASSES 1 the tile holds rna(X) (or X, which
// wgmma reads truncated) and one image streams; with PASSES 3 it holds X,
// and the ring brings Ws, Wb, Wb (see Half), the tile split in place
// between the second and third pass. HMAJOR: the images are in the h-major
// chunk order and product_hmajor runs, in 3xTF32 with 128-K step sums into
// `tmp`. Every thread of both consumer warpgroups calls it; bar_all names
// their barrier. side(q) runs during the first pass (it may read the tile).
// BF: the bf16 chain's one pass, the tile and the image in bf16.
template <int PASSES, int NW, int STAGES, bool HMAJOR = false, bool BF = false,
          class Side = NoSide>
__device__ __forceinline__ void product_half(float* A, const float* ring, uint64_t* full,
                                             uint64_t* empty, RingPos& rp,
                                             float (&acc)[Half<512, NW>::NH][NW / 2],
                                             float (&tmp)[NW / 2], int lane, int tid, int bar_all,
                                             Side side = Side()) {
    static_assert(PASSES == 1 || PASSES == 3, "1 or 3 TF32 passes");
    static_assert(PASSES == 1 || !BF, "the bf16 chain takes one pass");
    using H = Half<512, NW, BF>;
    constexpr int GROUP = PASSES == 3 ? 128 : 0;
    auto pass = [&](bool accumulate, auto sd) {
        if constexpr (HMAJOR)
            product_hmajor<H::KW, NW, H::NH, STAGES, GROUP, BF>(A, ring, full, empty, rp, acc,
                                                               tmp, lane, accumulate, sd);
        else
            product_k<H::KW, NW, H::NH, STAGES, BF>(A, ring, full, empty, rp, acc, lane,
                                                    accumulate, sd);
    };
    pass(false, side);
    if constexpr (PASSES == 3) {
        pass(true, NoSide());
        named_sync(bar_all, CONSUMERS * WG);   // both consumers are done with trunc(X)
        split_tile<CONSUMERS * WG>(A, tid);
        fence_async_smem();
        named_sync(bar_all, CONSUMERS * WG);
        pass(true, NoSide());
    }
}

// Producer side of product_half: the chunks of one weight's images for
// the consumer of half `half`, in the order product_half reads them.
// img_big / img_small: the weight's two images (img_small unread in one pass).
template <int PASSES, int NW, int STAGES, bool BF = false>
__device__ __forceinline__ void produce_half(const float* img_big, const float* img_small,
                                             int half, float* ring, uint64_t* full,
                                             uint64_t* empty, RingPos& rp) {
    using H = Half<512, NW, BF>;
    const size_t off = (size_t)half * (H::IMG / 2);
    if constexpr (PASSES == 3) {
        produce_chunks<H::NQ, H::CHUNK, STAGES>(img_small + off, ring, full, empty, rp);
        produce_chunks<H::NQ, H::CHUNK, STAGES>(img_big + off, ring, full, empty, rp);
    }
    produce_chunks<H::NQ, H::CHUNK, STAGES>(img_big + off, ring, full, empty, rp);
}

// 3xTF32 with the split tile beside the activation tile (widths up to 256):
// acc[h] = X @ W over the consumer's columns, X the shared tile (read
// truncated), Xs = tf32_lo(X) the split tile, the ring bringing chunk q of
// the Ws image, then chunk q of the Wb image (produce_split), chunks in the
// h-major order if HMAJOR, else (K block, column group). Per chunk pair:
// Xt.Ws into the small terms' accumulator, then Xt.Wb into the big sum and
// Xs.Wb into the small terms', the two accumulators interleaved; the small
// terms are added to acc[h] in round-to-nearest fp32 once a column group's
// K blocks are done (HMAJOR: one small accumulator, reused per group;
// else one per group, added at the end). The big sum: with GROUP (HMAJOR
// only) each GROUP K values accumulate from zero into a step sum, tmp[0]
// and tmp[1] in turn, which is added to acc[h] in round-to-nearest fp32
// once the next group's first Ws chunk is issued and the chunks before it
// have completed (wg_wait<1>), so the tensor cores do not drain at a
// group's end; with GROUP 0 acc[h] accumulates directly. Every thread of
// the consumer warpgroup calls it; side(q) runs after chunk pair q's
// products are issued, while they run.
template <int KD, int NW, int NH, int STAGES, int GROUP, bool HMAJOR, class Side = NoSide>
__device__ __forceinline__ void product_split(const float* X, const float* Xs, const float* ring,
                                              uint64_t* full, uint64_t* empty, RingPos& rp,
                                              float (&acc)[NH][NW / 2], float (&tmp)[2][NW / 2],
                                              float (&sml)[HMAJOR ? 1 : NH][NW / 2], int lane,
                                              Side side = Side()) {
    // K blocks a step sum: GROUP's, or all of them where K is shorter
    constexpr int CHUNK = NW * KB, NKC = KD / KB;
    constexpr int GKC = GROUP && GROUP / KB < NKC ? GROUP / KB : NKC, NG = NKC / GKC;
    static_assert(NKC % GKC == 0 && (GROUP == 0 || HMAJOR), "whole groups, h-major");
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
#pragma unroll
    for (int h = 0; h < (HMAJOR ? 1 : NH); ++h) pin(sml[h]);
    int prev = -1;
    auto release = [&]() {   // the last group but one has completed: free its stage
        wg_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = rp.stage;
        rp.next<STAGES>();
    };
    // acc[h] (+)= a completed sum t, in round-to-nearest fp32
    auto add_to = [&](int h, float (&t)[NW / 2], bool first) {
        pin(t);
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[h][i] = first ? t[i] : acc[h][i] + t[i];
    };
    // Chunk pair (h, kc), the big sum into `big` (a step sum starting at
    // each group's first K block, or acc[h]); after_ws() runs once the Ws
    // chunk is issued and every earlier chunk has completed. h is a
    // constant wherever pair is called: the loops over h unroll.
    auto pair = [&](int h, int kc, float (&big)[NW / 2], auto after_ws) {
        float(&s)[NW / 2] = sml[HMAJOR ? 0 : h];
        const float* a = X + kc * 64 * KB;
        const float* as = Xs + kc * 64 * KB;
        mbar_wait(&full[rp.stage], rp.phase);   // Ws
        const float* b = ring + rp.stage * CHUNK;
        wg_fence();
#pragma unroll
        for (int k8 = 0; k8 < KB / 8; ++k8)
            Wgmma<NW>::mma(s, desc(a + 8 * k8), desc(b + 8 * k8), (kc | k8) != 0);
        wg_commit();
        release();
        after_ws();
        mbar_wait(&full[rp.stage], rp.phase);   // Wb
        b = ring + rp.stage * CHUNK;
        wg_fence();
        const int kz = GROUP ? kc % GKC : kc;   // K blocks into `big` so far
#pragma unroll
        for (int k8 = 0; k8 < KB / 8; ++k8) {
            Wgmma<NW>::mma(big, desc(a + 8 * k8), desc(b + 8 * k8), (kz | k8) != 0);
            Wgmma<NW>::mma(s, desc(as + 8 * k8), desc(b + 8 * k8), 1);
        }
        wg_commit();
        side(HMAJOR ? h * NKC + kc : kc * NH + h);
        release();
    };
    auto nothing = [] {};
    // acc[h] += the small terms, in round-to-nearest fp32 (all products done)
    auto add_small = [&](int h) { add_to(h, sml[HMAJOR ? 0 : h], false); };
    if constexpr (HMAJOR) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
            if constexpr (GROUP) {
                // groups g, g + 1 into tmp[0], tmp[1]; each added during the next
#pragma unroll 1
                for (int g = 0; g < NG; g += 2) {
                    for (int j = 0; j < GKC; ++j)
                        pair(h, g * GKC + j, tmp[0], [&] {
                            if (j == 0 && g > 0) add_to(h, tmp[1], false);
                        });
                    if (g + 1 < NG)
                        for (int j = 0; j < GKC; ++j)
                            pair(h, (g + 1) * GKC + j, tmp[1], [&] {
                                if (j == 0) add_to(h, tmp[0], g == 0);
                            });
                }
                wg_wait<0>();   // the last group's sum and the small terms are complete
                add_to(h, tmp[(NG - 1) & 1], NG == 1);
            } else {
#pragma unroll 1
                for (int kc = 0; kc < NKC; ++kc) pair(h, kc, acc[h], nothing);
                wg_wait<0>();
            }
            add_small(h);
        }
    } else {
#pragma unroll 1
        for (int kc = 0; kc < NKC; ++kc)
#pragma unroll
            for (int h = 0; h < NH; ++h) pair(h, kc, acc[h], nothing);
        wg_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) add_small(h);
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
    if (lane == 0) mbar_arrive(&empty[prev]);
}

// Producer side of product_split: chunk q of the Ws image, then chunk q of
// the Wb image, for each chunk q of one half image (img_big / img_small
// point at the consumer's half).
template <int NQ, int CHUNK, int STAGES>
__device__ __forceinline__ void produce_split(const float* img_big, const float* img_small,
                                              float* ring, uint64_t* full, uint64_t* empty,
                                              RingPos& rp) {
    for (int q = 0; q < NQ; ++q) {
        produce_chunks<1, CHUNK, STAGES>(img_small + (size_t)q * CHUNK, ring, full, empty, rp);
        produce_chunks<1, CHUNK, STAGES>(img_big + (size_t)q * CHUNK, ring, full, empty, rp);
    }
}

// ---- the bf16 chain -----------------------------------------------------------
//
// The bf16 chain (chain_dtype=bfloat16; egnn_tile.cuh's CHAIN_BF16) runs on
// the same designs with bf16 operands: wgmma m64nNk16.f32.bf16.bf16 (Wgmma
// with BF), fp32 accumulators, each product's fp32 sum rounded once to bf16
// in the epilogue, as the JAX kernel's `_mm` rounds it. Its tiles, images and
// stream rows keep the K-major 128-byte-swizzled layout in 4-byte words:
// word w of a row holds K values 2w (low half) and 2w + 1, sw_off(row, w,
// rows) places it, a 128-byte row of a K block holds 64 K values, and a
// descriptor and its 32-byte k steps are those of TF32. Every value the chain
// writes is a bf16 value already (egnn_tile.cuh: rbf), so packing keeps it
// exactly; the weight images round the fp32 parameters to nearest even, as
// torch's cast (and JAX's `_param_tuple`) does.

// The chain's elementwise ops on column pairs (bf16x2), as the JAX kernel
// computes them on bf16 arrays: each op's result rounded to bf16. A sum or
// product of two bf16 values is exact in fp32 (unless their exponents lie
// more than 16 apart), so the bf16x2 instructions' one rounding gives what
// the reference's fp32 op and cast give (egnn_tile.cuh: rbf); exp and the
// reciprocal run in fp32 on the bf16 values and are rounded as their
// results. The pair (lo, hi) is two adjacent columns, lo in the low half.
// add2 / sub2 / mul2 name their rounding (.rn): a bf16x2 mul or add whose
// rounding PTX leaves unnamed may be folded into one fma with its neighbour,
// one rounding where the chain has two (that read 1-4e-3 of max |agg| off
// the plain version on the card, against 2e-4 with every op rounded).
using bf2 = __nv_bfloat162;
// (lo, hi) rounded to bf16 (to nearest even)
__device__ __forceinline__ bf2 bf2r(float lo, float hi) { return __floats2bfloat162_rn(lo, hi); }
__device__ __forceinline__ float2 f2(bf2 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<const uint32_t*>(&v); }
__device__ __forceinline__ bf2 bf2_of_bits(uint32_t u) { return *reinterpret_cast<const bf2*>(&u); }
__device__ __forceinline__ bf2 one2() { return bf2_of_bits(0x3F803F80u); }   // (1, 1)
// the bf16 pair v at columns (col, col + 1), col even, of row r of a bf16
// tile of `rows` rows
__device__ __forceinline__ void put2_bf16(float* A, int r, int col, bf2 v, int rows = M) {
    *reinterpret_cast<bf2*>(A + sw_off(r, col / 2, rows)) = v;
}
__device__ __forceinline__ bf2 add2(bf2 a, bf2 b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return bf2_of_bits(d);
}
__device__ __forceinline__ bf2 sub2(bf2 a, bf2 b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return bf2_of_bits(d);
}
__device__ __forceinline__ bf2 mul2(bf2 a, bf2 b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return bf2_of_bits(d);
}
// `_sigmoid`: 1 / (1 + exp(-x)), with the fast exponential and reciprocal
// (__expf, __fdividef: a few fp32 ulp, which move a bf16 result only where
// the exact one lies within them of a rounding boundary)
__device__ __forceinline__ bf2 sigmoid2(bf2 x) {
    const float2 v = f2(x);
    const float2 d = f2(add2(one2(), bf2r(__expf(-v.x), __expf(-v.y))));
    return bf2r(__fdividef(1.0f, d.x), __fdividef(1.0f, d.y));
}
// `_silu` and `_dsilu` from s = sigmoid(x), which both share
__device__ __forceinline__ bf2 silu2(bf2 x, bf2 s) { return mul2(x, s); }
__device__ __forceinline__ bf2 dsilu2(bf2 x, bf2 s) {
    return mul2(s, add2(one2(), mul2(x, sub2(one2(), s))));
}
// a product's fp32 sums (a0, a1) rounded once, plus the bf16 bias b
__device__ __forceinline__ bf2 bias2(float a0, float a1, bf2 b) { return add2(bf2r(a0, a1), b); }
// the bf16 pair of two fp32 parameters p[0], p[1] (read-only data)
__device__ __forceinline__ bf2 param2(const float* p) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return bf2r(v.x, v.y);
}
// The NV / 2 column pairs of NV values of a or bs at p (16-byte aligned)
// as bf16: bf16 inputs as they lie, fp32 inputs rounded.
template <int NV>
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* p, bf2 (&out)[NV / 2]) {
    static_assert(NV == 8, "8 bf16 values a 16-byte load");
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    out[0] = bf2_of_bits(q.x); out[1] = bf2_of_bits(q.y);
    out[2] = bf2_of_bits(q.z); out[3] = bf2_of_bits(q.w);
}
template <int NV>
__device__ __forceinline__ void load_pairs(const float* p, bf2 (&out)[NV / 2]) {
    static_assert(NV == 4, "4 fp32 values a 16-byte load");
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = bf2r(q.x, q.y);
    out[1] = bf2r(q.z, q.w);
}

// Words of K of the bf16 chain's operands at width hd: hd / 2, at least one
// K block (hd 32 uses half of it).
__host__ __device__ constexpr int kwords_bf16(int hd) { return hd / 2 < KB ? KB : hd / 2; }
// Words of one bf16 weight image.
__host__ __device__ constexpr size_t image_words_bf16(int hd) {
    return (size_t)kwords_bf16(hd) * hd;
}

// Word e of the bf16 image of an hd x hd weight w in orientation `orient`:
// `halves` consecutive parts of hd / halves output columns each (the two
// consumers' halves of the shared-tile kernel, else one), each of chunks of
// nw output rows x one K block (32 words, 64 K values), in the order (K
// block, column group), or with `hmajor` (column group, K block); each chunk
// in the swizzled word order. K beyond hd (hd 32) is 0.
__device__ __forceinline__ uint32_t image_word_bf16(const float* __restrict__ w, int orient,
                                                    int hd, int nw, int halves, int hmajor,
                                                    size_t e) {
    const int nkc = kwords_bf16(hd) / KB, cols = hd / halves, nh = cols / nw;
    const size_t per_half = (size_t)kwords_bf16(hd) * cols;
    const int half = (int)(e / per_half);
    const int eh = (int)(e % per_half);
    const int q = eh / (nw * KB), r = eh % (nw * KB);
    const int nl = r / KB, pos = r % KB;
    const int kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3);
    const int h = hmajor ? q / nkc : q % nh, kc = hmajor ? q % nkc : q / nh;
    const int n = half * cols + h * nw + nl, k = 2 * (kc * KB + kl);
    auto at = [&](int kk) {
        return kk >= hd ? 0.f : orient == IMG_T ? w[(size_t)kk * hd + n] : w[(size_t)n * hd + kk];
    };
    return bits(bf2r(at(k), at(k + 1)));
}

// img[q] = bf16 image of (src[q], orient[q]) for q < n (at most 4), each
// image_words_bf16(hd) words, in the chunk order (nw, halves, hmajor).
struct Bf16ImageSet {
    const float* src[4];
    int orient[4];
    int n, hd, nw, halves, hmajor;
};

__global__ void __launch_bounds__(256) weight_images_bf16(Bf16ImageSet set,
                                                          uint32_t* __restrict__ img) {
    const size_t per = image_words_bf16(set.hd);
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < set.n * per;
         idx += (size_t)gridDim.x * blockDim.x) {
        const int q = (int)(idx / per);
        img[idx] = image_word_bf16(set.src[q], set.orient[q], set.hd, set.nw, set.halves,
                                   set.hmajor, idx % per);
    }
}

inline cudaError_t launch_images_bf16(const Bf16ImageSet& set, float* img, cudaStream_t stream) {
    if (set.n < 1 || set.n > 4 || set.nw < 1 || set.halves < 1 || set.hd % (set.halves * set.nw) ||
        set.hd % 32)
        return cudaErrorInvalidValue;
    const size_t blocks = (set.n * image_words_bf16(set.hd) + 255) / 256;
    weight_images_bf16<<<(unsigned)(blocks < 2048 ? blocks : 2048), 256, 0, stream>>>(
        set, reinterpret_cast<uint32_t*>(img));
    return cudaGetLastError();
}

// The bf16 chain's fill: A = silu(pre) of a step's 64 edge rows (row r:
// receiver i0 + r % T, sender row_j[r]) as the JAX kernel rounds it
// (egnn_tile.cuh: pre_bf16 with a, bs and w_d cast to bf16 and d2 summed in
// fp32, then cast; `_silu` op by op) into the bf16 tile or stream rows A
// (sw_off of words, 64 rows); with dpre also silu'(pre) (`_dsilu`) into
// dpre, row-major [64][hd] bf16. Rows of invalid edges are 0. Thread t of
// the NT that fill it reads 16 bytes of a_i and of bs_j at a time; hd is the
// width (a constant, or the run-time width above 512).
template <class In, int NT>
__device__ __forceinline__ void fill_pre_bf16(float* A, const In* __restrict__ a_b,
                                              const In* __restrict__ bs_b,
                                              const float* __restrict__ w_d,
                                              const float* row_valid, const float* row_d2,
                                              const int* row_j, int i0, int hd, int t,
                                              float* __restrict__ dpre = nullptr) {
    constexpr int NV = Vec<In>::N, NP = NV / 2;
    const int hdv = hd / NV;
#pragma unroll 2
    for (int idx = t; idx < M * hdv; idx += NT) {
        const int r = idx / hdv, c = NV * (idx % hdv);
        uint32_t pw[NP], dw[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) pw[q] = dw[q] = 0u;
        if (row_valid[r] > 0.f) {
            bf2 av[NP], bv[NP];
            load_pairs<NV>(a_b + (size_t)(i0 + r % T) * hd + c, av);
            load_pairs<NV>(bs_b + (size_t)row_j[r] * hd + c, bv);
            const float d2 = rbf(row_d2[r]);
            const bf2 d2b = bf2r(d2, d2);
#pragma unroll
            for (int q = 0; q < NP; ++q) {
                // pre = (a + bs_j) + bf16(d2) * w_d, each op rounded
                const bf2 pre = add2(add2(av[q], bv[q]), mul2(d2b, param2(w_d + c + 2 * q)));
                const bf2 s = sigmoid2(pre);
                pw[q] = bits(silu2(pre, s));
                dw[q] = bits(dsilu2(pre, s));
            }
        }
        float* at = A + sw_off(r, c / 2, M);
        float* dp = dpre + ((size_t)r * hd + c) / 2;
        if constexpr (NP == 4) {
            *reinterpret_cast<uint4*>(at) = make_uint4(pw[0], pw[1], pw[2], pw[3]);
            if (dpre) *reinterpret_cast<uint4*>(dp) = make_uint4(dw[0], dw[1], dw[2], dw[3]);
        } else {
            *reinterpret_cast<uint2*>(at) = make_uint2(pw[0], pw[1]);
            if (dpre) *reinterpret_cast<uint2*>(dp) = make_uint2(dw[0], dw[1]);
        }
    }
}

// One task of the bf16 weight-grad copy: of a K block `blk` ([64 rows][32
// words], swizzled) of a step's bf16 tile, the word column fp (features
// 2 fp, 2 fp + 1 of the block) at rows 8c .. 8c + 7, written as one 16-byte
// chunk of each feature's row in the weight-grad layout dst ([hd features][32
// words]: a feature's 64 edge rows in one K block, swizzled; k0 = the
// block's first feature). Lanes take (fp, c) with c = lane / 4 and four fp
// a warp (wgrad_task_bf16), so the eight lanes of one fp write a feature's
// whole 128-byte row; each lane reads its rows starting at 8c + c % 8, which
// puts the warp's 32 reads of one iteration in 32 distinct banks, and turns
// the words back into row order in registers.
__device__ __forceinline__ void wgrad_copy_bf16(const float* blk, float* __restrict__ dst,
                                                int k0, int fp, int c) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {   // v[i]: row 8c + (i + c) % 8
        const int r = 8 * c + ((i + c) & 7);
        v[i] = reinterpret_cast<const uint32_t*>(blk)[r * KB + ((((fp >> 2) ^ (r & 7)) & 7) << 2) +
                                                      (fp & 3)];
    }
    // rotate by c: v[j] = row 8c + j
#pragma unroll
    for (int b = 1; b < 8; b <<= 1) {
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = (c & b) ? v[(j - b) & 7] : v[j];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = w[j];
    }
    const int k = k0 + 2 * fp;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
        const uint32_t sel = f ? 0x7632u : 0x5410u;   // the high or the low halves
        *reinterpret_cast<uint4*>(dst + (size_t)(k + f) * KB + ((c ^ ((k + f) & 7)) << 2)) =
            make_uint4(__byte_perm(v[0], v[1], sel), __byte_perm(v[2], v[3], sel),
                       __byte_perm(v[4], v[5], sel), __byte_perm(v[6], v[7], sel));
    }
}
// Task `task` of a K block's FP x 8 copy tasks (FP: the word columns in use,
// a multiple of 4): its (fp, c), four fp a warp of 32 consecutive tasks.
__device__ __forceinline__ void wgrad_task_bf16(int task, int FP, int& fp, int& c) {
    c = (task >> 2) & 7;
    fp = 4 * ((task >> 5) % (FP >> 2)) + (task & 3);
}

// 1024-byte aligned start of dynamic shared memory (the swizzled tiles'
// alignment); the kernels ask for 1 KB more than their layout.
__device__ __forceinline__ char* smem_base(char* raw) {
    const uint32_t a = smem_u32(raw);
    return raw + (((a + 1023u) & ~1023u) - a);
}

// f(Int<HD>{}, Type<In>{}) for a width the sm90 kernels take (32..256) and
// the input type of a / bs; cudaErrorInvalidValue otherwise.
template <class F>
cudaError_t dispatch(int hd, int bf16_in, F&& f) {
    auto by_hd = [&](auto t) -> cudaError_t {
        switch (hd) {
            case 32:  return f(Int<32>{}, t);
            case 64:  return f(Int<64>{}, t);
            case 128: return f(Int<128>{}, t);
            case 256: return f(Int<256>{}, t);
            default:  return cudaErrorInvalidValue;
        }
    };
    return bf16_in ? by_hd(Type<__nv_bfloat16>{}) : by_hd(Type<float>{});
}

}  // namespace sm90
}  // namespace egnn
