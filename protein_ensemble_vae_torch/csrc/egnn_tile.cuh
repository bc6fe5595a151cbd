// Shared pieces of the EGNN band kernels (egnn_band_fwd.cu, egnn_band_bwd.cu):
// a 64-edge-row x Hd tile times an Hd x Hd weight on the tensor cores.
//
// Modes (MODE, a template argument of both kernels): the JAX side's
// `precision` with the fp32 edge chain, or its `chain_dtype=bfloat16`.
// - MODE = 3 (Precision.HIGHEST, an fp32 model) and MODE = 1
//   (precision=None, a bf16 model): the chain, the activation tile and the
//   weights are fp32, and the products run on
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in MODE passes:
//   - 3 passes: each fp32 operand is split in registers as it is loaded,
//         big = rna_tf32(x),  small = rna_tf32(x - big)
//     (rna_tf32: cvt.rna.tf32.f32's rounding, in integer operations), and
//     the tile accumulates small*big + big*small + big*big in fp32. That
//     keeps ~22 of fp32's 24 significant bits per product: it is how
//     Precision.HIGHEST reaches fp32 accuracy through multi-pass products
//     on the TPU.
//   - 1 pass: each operand is rounded once, big*big, ~11 significant bits
//     per product, fp32 accumulation. It is the backend's fast product on
//     fp32 operands (XLA:GPU's TF32); the JAX side's bf16 model asks for it
//     because its projections a, bs are bf16 already.
//   mma.sync takes its fragments from registers, so the split costs no
//   shared memory (wgmma would need split copies of both operands in
//   swizzled shared memory).
// - MODE = CHAIN_BF16 (chain_dtype=bfloat16): the chain's activations and
//   cotangents are bf16, rounded where the JAX kernel rounds them (after
//   every elementwise op, `_silu` / `_dsilu` op by op, each product's fp32
//   sum rounded once, `_mm`); the activation tile, the weight ring and the
//   weights are bf16, and the products run on
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with fp32
//   accumulation (one pass; `precision` selects nothing, as bf16 operands
//   give JAX's HIGHEST and None the same product). Coordinates, the agg /
//   raw_delta sums and the weight-grad sums stay fp32.
//
// Inputs a and bs arrive as fp32 or, from a bf16 model, as bf16. They are
// read as they lie, 16 bytes per load (4 fp32 or 8 bf16 values), and
// widened to fp32 in registers (exactly: a bf16 value is the top half of
// an fp32 one); the fp32 chain runs on them as they are, the bf16 chain
// rounds them to bf16 first (exact for bf16 inputs).
//
// Layout: Tile<HD>::THREADS threads (256, or 512 at HD = 512) = NWARPS
// warps as WM x WN; warp (wm, wn) owns MT m16 row
// tiles and NT n8 column tiles. A lane (group g = lane / 4, t = lane % 4)
// holds, in m16n8k8 terms, rows mt*16 + g and mt*16 + 8 + g of each of its
// row tiles and columns nt*8 + 2t, +1 of each of its column tiles:
// acc[mt][nt][2*h + c] is row mt*16 + 8h + g, column nt*8 + 2t + c (plus the
// warp's offsets). m16n8k16's accumulators lie the same way. Edge row r of
// a step is (offset slot r / T, receiver r % T), so every row a lane holds
// belongs to receiver g.
//
// Shared memory, fp32 chain: the activation tile A is row-major [M][AS],
// AS = HD + 8 (AS = 8 mod 32), so the float2 fragment loads and stores of
// a half-warp touch 32 distinct banks. Inside each 8-wide k step the k
// order is permuted (mma slot t <-> column 2t, slot t + 4 <-> column
// 2t + 1), so a lane reads its two A values of a row as one float2; B is
// read with the same permutation. The weight W [HD][HD] (in, out) streams
// through a ring of STAGES chunks of BK rows with cp.async; ring rows have
// the stride BS = HD + 4 (= 4 mod 32), so the B fragment loads (rows 2t and
// 2t + 1, column g) are conflict-free too.
// bf16 chain: A is bf16 [M][AS] with the same AS (half the bytes), the
// ring holds bf16 chunks of 16-row multiples with the stride HD + 8; a row
// is 2 HD + 16 bytes (16 mod 128), so each ldmatrix phase (8 rows of 16
// bytes) touches 32 distinct banks. A fragments come by ldmatrix.x4 from
// the row-major tile, B fragments by ldmatrix.x2.trans from the row-major
// (k, n) weight chunk, in mma's natural k order.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace egnn {

constexpr int THREADS = 256;  // block of the passes whose shape no width sets
constexpr int T = 8;          // receivers per tile
constexpr int OPS = 8;        // band offsets per step
constexpr int M = T * OPS;    // edge rows per step

// The native widths: one instantiation of each kernel per width, the
// wrapper pads every other width up to the next of them (zero columns add
// nothing; ops/kernels/egnn_band.py: pad_band_width).
// The edge tile's block: 256 threads, two blocks per SM up to HD = 256;
// at HD = 512, 512 threads (16 warps, each with the fragment shape of HD
// 256: MT = 4, NT = 4), one block per SM. Either way an SM holds 16 warps
// and __launch_bounds__ caps a thread at 65,536 / 512 = 128 registers.
template <int HD>
struct Tile {
    static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256 || HD == 512,
                  "a native width: 32, 64, 128, 256 or 512");
    static constexpr int THREADS = HD >= 512 ? 512 : 256;           // threads per block
    static constexpr int MIN_BLOCKS = HD >= 512 ? 1 : 2;            // resident blocks per SM
    static constexpr int NWARPS = THREADS / 32;
    static constexpr int WN = HD / 8 < NWARPS ? HD / 8 : NWARPS;   // warps across columns
    static constexpr int WM = NWARPS / WN;                          // warps across rows
    static constexpr int MT = M / 16 / WM;                          // m16 tiles per warp
    static constexpr int NT = HD / 8 / WN;                          // n8 tiles per warp
    static constexpr int AS = HD + 8;                               // A row stride
    static constexpr int BS = HD + 4;                               // ring row stride
    static_assert(WM * WN == NWARPS && MT * WM * 16 == M && NT * WN * 8 == HD,
                  "tile does not divide");
};

// MODE of a kernel: TF32 passes (1 or 3) with the fp32 chain, or the bf16 chain.
constexpr int CHAIN_BF16 = 0;

template <int MODE>
struct Chain {
    static_assert(MODE == 1 || MODE == 3 || MODE == CHAIN_BF16, "1 or 3 TF32 passes, or the bf16 chain");
    static constexpr bool BF16 = MODE == CHAIN_BF16;
    // type of the activation tile, the weight ring and the weights
    using Act = typename std::conditional<BF16, __nv_bfloat16, float>::type;
};

// Lane coordinates in the tile: first row (add mt*16 + 8h) and first column
// (add nt*8 + c) of the lane's fragments.
struct Lane {
    int g, t, row0, col0;
    template <int HD>
    __device__ __forceinline__ static Lane of(int tid) {
        using TL = Tile<HD>;
        const int warp = tid / 32, lane = tid % 32;
        Lane l;
        l.g = lane / 4;
        l.t = lane % 4;
        l.row0 = (warp / TL::WN) * TL::MT * 16 + l.g;
        l.col0 = (warp % TL::WN) * TL::NT * 8 + 2 * l.t;
        return l;
    }
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }
// d silu(x) / dx = s * (1 + x * (1 - s)), s = sigmoid(x)
__device__ __forceinline__ float dsilu(float x) {
    const float s = sigmoid(x);
    return s * (1.0f + x * (1.0f - s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Values of input type In per 16-byte load.
template <class In>
struct Vec {
    static_assert(std::is_same<In, float>::value || std::is_same<In, __nv_bfloat16>::value,
                  "a and bs are fp32 or bf16");
    static constexpr int N = 16 / sizeof(In);
};

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// Vec<In>::N consecutive values at p (16-byte aligned), as fp32.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
    v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z); v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
}

// Two consecutive values at p (aligned to two values), as fp32.
__device__ __forceinline__ float2 load2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
    return make_float2(bf16_lo(u), bf16_hi(u));
}

// v rounded to the output type (to nearest even for bf16, as torch's and JAX's casts).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive values at p (aligned to four values; read-only data), as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// Two consecutive values at p (aligned to two values), written earlier by
// this kernel (so not through the read-only cache), as fp32.
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(bf16_lo(u), bf16_hi(u));
}

// Store two / four consecutive values (aligned to two / four values); bf16
// rounds to nearest even (the values of the bf16 chain are bf16 already).
__device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
}

// The bf16 chain's elementwise ops, as the JAX kernel computes them on bf16
// arrays: each op in fp32 (exact for a product of two bf16 values), its
// result rounded to bf16 (to nearest even). Inputs are bf16 values held in
// fp32; so are the results.
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
// `_sigmoid`: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_bf16(float x) {
    return rbf(1.0f / rbf(1.0f + rbf(expf(-x))));
}
// `_silu`: x * sigmoid(x)
__device__ __forceinline__ float silu_bf16(float x) { return rbf(x * sigmoid_bf16(x)); }
// `_dsilu`: s * (1 + x * (1 - s)), s = sigmoid(x)
__device__ __forceinline__ float dsilu_bf16(float x) {
    const float s = sigmoid_bf16(x);
    return rbf(s * rbf(1.0f + rbf(x * rbf(1.0f - s))));
}
// pre = (a + bs_j) + bf16(d2) * w_d, with a, bs_j (fp32 or bf16 inputs,
// widened) cast to bf16 first; d2b is bf16(d2), wd a bf16 weight.
__device__ __forceinline__ float pre_bf16(float a, float bs, float d2b, float wd) {
    return rbf(rbf(rbf(a) + rbf(bs)) + rbf(d2b * wd));
}

// cvt.rna.tf32.f32's rounding of a finite x (to nearest, ties away from
// zero: add half of the 13 dropped bits to the magnitude, then clear them),
// done with two integer operations. The conversion instruction issues at a
// fraction of the integer rate, and with 48 of them per lane and k8 step it
// held the tile back (PERF.md, PR 3).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = rna_tf32(x);
    small = rna_tf32(x - __uint_as_float(big));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[nt] += A (16 x 8) * B[nt] (8 x 8) for the NT column tiles, in PASSES
// passes over the split operands (big, small); small terms first, the
// passes of one accumulator interleaved with the other column tiles' for
// latency. With one pass only big * big (al, bl are not read).
template <int NT, int PASSES>
__device__ __forceinline__ void mma_passes(float (&d)[NT][4], const uint32_t (&ab)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bb)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
    if constexpr (PASSES == 3) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], al, bb[nt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ab, bl[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ab, bb[nt]);
}

// One k8 step of an MT x NT warp tile in PASSES TF32 passes (3 or 1, see
// the top of this file). afrag(mt, lo, hi) loads the lane's A values (rows g
// and g + 8 of row tile mt: lo = (slot t, slot t+4) of row g, hi = the same
// of row g + 8); bfrag(nt, b0, b1) its B values (slots t and t + 4 of
// column g of column tile nt).
//
// STEP_SUM: the tensor cores round their fp32 accumulation toward zero, so
// a K = 256 product accumulated in one mma accumulator (96 truncating adds
// in 3 passes) drifts by ~1e-6 of its value, always in the same direction,
// and a model sums that drift coherently. With STEP_SUM each k8 step's
// products start from zero and the step's sum is added to acc with an
// ordinary (round-to-nearest) fp32 add: the error correction of Ootomo and
// Yokota's 3xTF32 scheme, for 4 adds per mma tile and step.
template <int MT, int NT, int PASSES, bool STEP_SUM, class AF, class BF>
__device__ __forceinline__ void mma_k8(float (&acc)[MT][NT][4], AF afrag, BF bfrag) {
    static_assert(PASSES == 1 || PASSES == 3, "1 or 3 TF32 passes");
    uint32_t bb[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        float b0, b1;
        bfrag(nt, b0, b1);
        if constexpr (PASSES == 3) {
            split_tf32(b0, bb[nt][0], bl[nt][0]);
            split_tf32(b1, bb[nt][1], bl[nt][1]);
        } else {
            bb[nt][0] = rna_tf32(b0);
            bb[nt][1] = rna_tf32(b1);
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        float2 lo, hi;
        afrag(mt, lo, hi);
        uint32_t ab[4], al[4];
        if constexpr (PASSES == 3) {
            split_tf32(lo.x, ab[0], al[0]);   // a0: row g,     slot t
            split_tf32(hi.x, ab[1], al[1]);   // a1: row g + 8, slot t
            split_tf32(lo.y, ab[2], al[2]);   // a2: row g,     slot t + 4
            split_tf32(hi.y, ab[3], al[3]);   // a3: row g + 8, slot t + 4
        } else {
            ab[0] = rna_tf32(lo.x);
            ab[1] = rna_tf32(hi.x);
            ab[2] = rna_tf32(lo.y);
            ab[3] = rna_tf32(hi.y);
        }
        if constexpr (STEP_SUM) {
            float step[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) step[nt][q] = 0.f;
            mma_passes<NT, PASSES>(step, ab, al, bb, bl);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mt][nt][q] += step[nt][q];
        } else {
            mma_passes<NT, PASSES>(acc[mt], ab, al, bb, bl);
        }
    }
}

// Issue the cp.async copies of weight rows [kc*BK, kc*BK + BK) into `dst`
// (row stride BS). The caller commits the group.
template <int HD, int BK>
__device__ __forceinline__ void load_chunk(const float* __restrict__ w, int kc, float* dst,
                                           int tid) {
    constexpr int F4R = HD / 4;
    const float* src = w + (size_t)kc * BK * HD;
    for (int v = tid; v < BK * F4R; v += Tile<HD>::THREADS) {
        const int r = v / F4R, c4 = v % F4R;
        cp_async16(dst + r * Tile<HD>::BS + 4 * c4, src + (size_t)r * HD + 4 * c4);
    }
}

template <int HD, int BK, int STAGES>
struct Ring {
    static_assert(BK % 8 == 0 && HD % BK == 0 && STAGES >= 2, "ring shape");
    static constexpr int FLOATS = STAGES * BK * Tile<HD>::BS;
};

// acc = A @ W: A is the [M][AS] tile in shared memory, w [HD][HD] in device
// memory, streamed through `ring` (Ring<HD, BK, STAGES>::FLOATS floats);
// PASSES and STEP_SUM as in mma_k8. The caller has synchronised after writing A. Ends
// with a block barrier, after which A and the ring may be overwritten.
template <int HD, int BK, int STAGES, int PASSES, bool STEP_SUM>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ w, const float* A,
                                          float* ring,
                                          float (&acc)[Tile<HD>::MT][Tile<HD>::NT][4],
                                          int tid) {
    using TL = Tile<HD>;
    constexpr int NCHUNK = HD / BK;
    constexpr int AS = TL::AS, BS = TL::BS;
    const Lane ln = Lane::of<HD>(tid);
    const float* a_lane = A + ln.row0 * AS + 2 * ln.t;
    const int bcol = ln.col0 - 2 * ln.t + ln.g;   // column g of the warp's first n8 tile
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < NCHUNK) load_chunk<HD, BK>(w, s, ring + s * BK * BS, tid);
        cp_async_commit();
    }
    for (int kc = 0; kc < NCHUNK; ++kc) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // chunk kc visible to all; chunk kc - 1's slot is free
        const int nk = kc + STAGES - 1;
        if (nk < NCHUNK) load_chunk<HD, BK>(w, nk, ring + (nk % STAGES) * BK * BS, tid);
        cp_async_commit();
        const float* wb = ring + (kc % STAGES) * BK * BS;
#pragma unroll
        for (int k8 = 0; k8 < BK; k8 += 8) {
            const int k = kc * BK + k8;
            const float* bp = wb + (k8 + 2 * ln.t) * BS + bcol;
            mma_k8<TL::MT, TL::NT, PASSES, STEP_SUM>(
                acc,
                [&](int mt, float2& lo, float2& hi) {
                    lo = *reinterpret_cast<const float2*>(a_lane + mt * 16 * AS + k);
                    hi = *reinterpret_cast<const float2*>(a_lane + (mt * 16 + 8) * AS + k);
                },
                [&](int nt, float& b0, float& b1) {
                    b0 = bp[nt * 8];
                    b1 = bp[nt * 8 + BS];
                });
        }
    }
    cp_async_wait<0>();   // only empty groups are left
    __syncthreads();
}

// ---- bf16 chain: m16n8k16 bf16 products -----------------------------------

// Lane's fragments of 8 x 8 bf16 matrices from shared memory; p: the row
// this lane addresses (ldmatrix: lanes 8q..8q+7 give the rows of matrix q).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(s) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 inputs, fp32 accumulate.
// a: {row g, k 2t..2t+1}, {row g + 8, same}, {row g, k 2t+8..}, {row g + 8, k 2t+8..};
// b: {k 2t..2t+1, column g}, {k 2t+8.., column g} (low half = lower index).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int HD, int BK, int STAGES>
struct RingH {
    static_assert(BK % 16 == 0 && HD % BK == 0 && STAGES >= 2, "bf16 ring shape");
    static constexpr int BS = HD + 8;                       // row stride, bf16 values
    static constexpr int FLOATS = STAGES * BK * BS / 2;     // in floats (4-byte words)
};

// cp.async copies of bf16 weight rows [kc*BK, kc*BK + BK) into `dst` (row
// stride HD + 8). The caller commits the group.
template <int HD, int BK>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ w, int kc,
                                           __nv_bfloat16* dst, int tid) {
    constexpr int V8 = HD / 8, BS = HD + 8;
    const __nv_bfloat16* src = w + (size_t)kc * BK * HD;
    for (int v = tid; v < BK * V8; v += Tile<HD>::THREADS) {
        const int r = v / V8, c8 = v % V8;
        cp_async16(dst + r * BS + 8 * c8, src + (size_t)r * HD + 8 * c8);
    }
}

// acc = A @ W for the bf16 chain: A is the bf16 [M][AS] tile in shared
// memory, w [HD][HD] bf16 in device memory, streamed through `ring`
// (RingH<HD, BK, STAGES>::FLOATS words); fp32 accumulation in mma order.
// Same contract as gemm_tile: the caller has synchronised after writing A;
// ends with a block barrier.
template <int HD, int BK, int STAGES>
__device__ __forceinline__ void gemm_tile(const __nv_bfloat16* __restrict__ w,
                                          const __nv_bfloat16* A, __nv_bfloat16* ring,
                                          float (&acc)[Tile<HD>::MT][Tile<HD>::NT][4],
                                          int tid) {
    using TL = Tile<HD>;
    constexpr int NCHUNK = HD / BK;
    constexpr int AS = TL::AS, BS = RingH<HD, BK, STAGES>::BS;
    const int warp = tid / 32, lane = tid % 32;
    const int q = lane >> 3, i = lane & 7;
    // ldmatrix rows: A.x4 matrix q = (rows +8 (q & 1), k +8 (q >> 1)) of the
    // warp's m16 tile; B.x2.trans matrix q = (k rows +8 (q & 1)) at the
    // warp's first column
    const __nv_bfloat16* a_ld =
        A + ((warp / TL::WN) * TL::MT * 16 + i + (q & 1) * 8) * AS + (q >> 1) * 8;
    const int b_ld = (i + (q & 1) * 8) * BS + (warp % TL::WN) * TL::NT * 8;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < NCHUNK) load_chunk<HD, BK>(w, s, ring + s * BK * BS, tid);
        cp_async_commit();
    }
    for (int kc = 0; kc < NCHUNK; ++kc) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // chunk kc visible to all; chunk kc - 1's slot is free
        const int nk = kc + STAGES - 1;
        if (nk < NCHUNK) load_chunk<HD, BK>(w, nk, ring + (nk % STAGES) * BK * BS, tid);
        cp_async_commit();
        const __nv_bfloat16* wb = ring + (kc % STAGES) * BK * BS + b_ld;
#pragma unroll
        for (int k16 = 0; k16 < BK; k16 += 16) {
            uint32_t b[TL::NT][2];
#pragma unroll
            for (int nt = 0; nt < TL::NT; ++nt) ldsm_x2_trans(b[nt], wb + k16 * BS + nt * 8);
#pragma unroll
            for (int mt = 0; mt < TL::MT; ++mt) {
                uint32_t a[4];
                ldsm_x4(a, a_ld + mt * 16 * AS + kc * BK + k16);
#pragma unroll
                for (int nt = 0; nt < TL::NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
            }
        }
    }
    cp_async_wait<0>();   // only empty groups are left
    __syncthreads();
}

// Write the lane's fragments of `acc` into the [M][AS] tile A (two values
// per row and column pair, in A's type; conflict-free). The caller synchronises afterwards.
template <int HD, class Act>
__device__ __forceinline__ void store_tile(Act* A, const float (&acc)[Tile<HD>::MT][Tile<HD>::NT][4],
                                           const Lane& ln) {
    using TL = Tile<HD>;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < TL::NT; ++nt)
                store2(A + (ln.row0 + mt * 16 + 8 * h) * TL::AS + ln.col0 + nt * 8,
                       acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// ---- widths above 512: the wide kernels ---------------------------------
// A block of either kernel's wide variant (egnn_band_fwd.cu,
// egnn_band_bwd.cu) takes any width hd > 512 that WIDE_GROUP divides (the
// wrapper zero-pads the others), given at run time: one instantiation per
// mode. It keeps Tile<256>'s block and fragments (256 threads, 8 warps
// across the columns, MT = NT = 4) and walks the hd output columns of each
// product in groups of WIDE_GROUP, so registers do not grow with the
// width. The activation rows of the 64-edge step (the product's A
// operand, M x hd) no longer fit in shared memory: they lie in device
// memory, in the block's own scratch rows (L2-resident while the block
// works on them), written and read back by the block between barriers;
// the B operand, the weight, is read from device memory by each lane
// (through the read-only cache; every block reads the same weight).
constexpr int WIDE_GROUP = 256;
using WideTile = Tile<WIDE_GROUP>;
static_assert(WideTile::WM == 1, "a wide group's lane owns whole columns of the step");

inline bool wide_width(int hd) { return hd > 512 && hd % WIDE_GROUP == 0; }

// acc = A @ w[:, c0 : c0 + WIDE_GROUP] in PASSES TF32 passes (STEP_SUM as
// in mma_k8): A is [M][lda] fp32 in device memory, written earlier by this
// block (so read through the coherent path), w [K][ldw] fp32 read-only.
template <int PASSES, bool STEP_SUM>
__device__ __forceinline__ void gemm_wide(const float* A, int lda, const float* __restrict__ w,
                                          int ldw, int c0, int K,
                                          float (&acc)[WideTile::MT][WideTile::NT][4],
                                          const Lane& ln) {
    using TL = WideTile;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    const float* a_lane = A + (size_t)ln.row0 * lda + 2 * ln.t;
    // rows 2t, 2t + 1 of each k8 step, column g of the warp's first n8 tile
    const float* b_lane = w + (size_t)(2 * ln.t) * ldw + c0 + ln.col0 - 2 * ln.t + ln.g;
#pragma unroll 2
    for (int k = 0; k < K; k += 8) {
        const float* bp = b_lane + (size_t)k * ldw;
        mma_k8<TL::MT, TL::NT, PASSES, STEP_SUM>(
            acc,
            [&](int mt, float2& lo, float2& hi) {
                lo = *reinterpret_cast<const float2*>(a_lane + (size_t)(mt * 16) * lda + k);
                hi = *reinterpret_cast<const float2*>(a_lane + (size_t)(mt * 16 + 8) * lda + k);
            },
            [&](int nt, float& b0, float& b1) {
                b0 = __ldg(bp + nt * 8);
                b1 = __ldg(bp + nt * 8 + ldw);
            });
    }
}

// The same for the bf16 chain: A [M][lda] and w [K][ldw] bf16, m16n8k16
// products, fp32 accumulation in mma order. A lane loads its fragments
// itself (32-bit loads of two k-neighbours of A; two 16-bit loads of w per
// register), in the layout of mma_bf16.
__device__ __forceinline__ void gemm_wide(const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* __restrict__ w, int ldw, int c0,
                                          int K, float (&acc)[WideTile::MT][WideTile::NT][4],
                                          const Lane& ln) {
    using TL = WideTile;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    const __nv_bfloat16* a_lane = A + (size_t)ln.row0 * lda + 2 * ln.t;
    const unsigned short* b_lane = reinterpret_cast<const unsigned short*>(w) +
                                   (size_t)(2 * ln.t) * ldw + c0 + ln.col0 - 2 * ln.t + ln.g;
    for (int k = 0; k < K; k += 16) {
        uint32_t b[TL::NT][2];
        const unsigned short* bp = b_lane + (size_t)k * ldw;
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt) {
            const unsigned short* q = bp + nt * 8;
            b[nt][0] = (uint32_t)__ldg(q) | ((uint32_t)__ldg(q + ldw) << 16);
            b[nt][1] = (uint32_t)__ldg(q + 8 * (size_t)ldw) | ((uint32_t)__ldg(q + 9 * (size_t)ldw) << 16);
        }
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt) {
            const __nv_bfloat16* ap = a_lane + (size_t)(mt * 16) * lda + k;
            uint32_t a[4];
            a[0] = *reinterpret_cast<const uint32_t*>(ap);                       // row g, k 2t..
            a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * (size_t)lda);     // row g + 8
            a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);                   // row g, k 2t + 8..
            a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * (size_t)lda + 8); // row g + 8, k 2t + 8..
#pragma unroll
            for (int nt = 0; nt < TL::NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
    }
}

// Store the lane's fragments of `acc` to columns c0.. of rows [0, M) of an
// [.., ld] array of type Act.
template <class Act>
__device__ __forceinline__ void store_rows_wide(Act* dst, int ld, int c0,
                                                const float (&acc)[WideTile::MT][WideTile::NT][4],
                                                const Lane& ln) {
#pragma unroll
    for (int mt = 0; mt < WideTile::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < WideTile::NT; ++nt)
                store2(dst + (size_t)(ln.row0 + mt * 16 + 8 * h) * ld + c0 + ln.col0 + nt * 8,
                       acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// Sum v over the four lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// Band offset of non-self offset slot e in [0, 2W): -W..-1, 1..W.
__device__ __forceinline__ int band_offset(int e, int W) { return e < W ? e - W : e - W + 1; }

template <class In>
struct Type { using type = In; };
template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<HD>{}, Type<In>{}, Int<MODE>{}) for the run-time hidden width hd
// (a native width: 32, 64, 128, 256 or 512), input type In of a / bs (bf16 when bf16_in, else
// fp32) and mode: CHAIN_BF16 when chain_bf16, else the TF32 passes (1 or
// 3; the bf16 chain takes either and makes one bf16 pass). The bf16 chain
// is instantiated once per (hd, In). cudaErrorInvalidValue for anything
// else.
// f(Type<In>{}, Int<MODE>{}) for the input type and mode, as dispatch
// below; for the wide kernels, which take the width at run time.
template <class F>
cudaError_t dispatch_mode(int bf16_in, int passes, int chain_bf16, F&& f) {
    auto by_mode = [&](auto t) -> cudaError_t {
        if (passes != 1 && passes != 3) return cudaErrorInvalidValue;
        if (chain_bf16) return f(t, Int<CHAIN_BF16>{});
        if (passes == 1) return f(t, Int<1>{});
        return f(t, Int<3>{});
    };
    return bf16_in ? by_mode(Type<__nv_bfloat16>{}) : by_mode(Type<float>{});
}

template <class F>
cudaError_t dispatch(int hd, int bf16_in, int passes, int chain_bf16, F&& f) {
    auto by_hd = [&](auto t, auto m) -> cudaError_t {
        switch (hd) {
            case 32:  return f(Int<32>{}, t, m);
            case 64:  return f(Int<64>{}, t, m);
            case 128: return f(Int<128>{}, t, m);
            case 256: return f(Int<256>{}, t, m);
            case 512: return f(Int<512>{}, t, m);
            default:  return cudaErrorInvalidValue;
        }
    };
    auto by_mode = [&](auto t) -> cudaError_t {
        if (passes != 1 && passes != 3) return cudaErrorInvalidValue;
        if (chain_bf16) return by_hd(t, Int<CHAIN_BF16>{});
        if (passes == 1) return by_hd(t, Int<1>{});
        return by_hd(t, Int<3>{});
    };
    return bf16_in ? by_mode(Type<__nv_bfloat16>{}) : by_mode(Type<float>{});
}

}  // namespace egnn
