// Shared pieces of the EGNN band kernels (egnn_band_fwd.cu, egnn_band_bwd.cu):
// a 64-edge-row x Hd tile times an Hd x Hd weight on the tensor cores.
//
// Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, in one of
// two modes (PASSES), the JAX side's `precision` argument:
// - 3 passes (Precision.HIGHEST, an fp32 model): each fp32 operand is split
//   in registers as it is loaded,
//       big = rna_tf32(x),  small = rna_tf32(x - big)
//   (rna_tf32: cvt.rna.tf32.f32's rounding, in integer operations), and the
//   tile accumulates small*big + big*small + big*big in fp32. That keeps ~22
//   of fp32's 24 significant bits per product: it is how Precision.HIGHEST
//   reaches fp32 accuracy through multi-pass products on the TPU.
// - 1 pass (precision=None, a bf16 model): each operand is rounded once,
//   big*big, ~11 significant bits per product, fp32 accumulation. It is the
//   backend's fast product on fp32 operands (XLA:GPU's TF32); the JAX side's
//   bf16 model asks for it because its projections a, bs are bf16 already.
// mma.sync takes its fragments from registers, so the split costs no shared
// memory (wgmma would need split copies of both operands in swizzled shared
// memory).
//
// Inputs a and bs arrive as fp32 or, from a bf16 model, as bf16. They are
// read as they lie, 16 bytes per load (4 fp32 or 8 bf16 values), and
// widened to fp32 in registers (exactly: a bf16 value is the top half of
// an fp32 one); the edge chain runs in fp32 either way.
//
// Layout: 256 threads = 8 warps as WM x WN; warp (wm, wn) owns MT m16 row
// tiles and NT n8 column tiles. A lane (group g = lane / 4, t = lane % 4)
// holds, in m16n8k8 terms, rows mt*16 + g and mt*16 + 8 + g of each of its
// row tiles and columns nt*8 + 2t, +1 of each of its column tiles:
// acc[mt][nt][2*h + c] is row mt*16 + 8h + g, column nt*8 + 2t + c (plus the
// warp's offsets). Edge row r of a step is (offset slot r / T, receiver
// r % T), so every row a lane holds belongs to receiver g.
//
// Shared memory: the activation tile A is row-major [M][AS], AS = HD + 8
// (AS = 8 mod 32), so the float2 fragment loads and stores of a half-warp
// touch 32 distinct banks. Inside each 8-wide k step the k order is
// permuted (mma slot t <-> column 2t, slot t + 4 <-> column 2t + 1), so a
// lane reads its two A values of a row as one float2; B is read with the
// same permutation. The weight W [HD][HD] (in, out) streams through a ring
// of STAGES chunks of BK rows with cp.async; ring rows have the stride
// BS = HD + 4 (= 4 mod 32), so the B fragment loads (rows 2t and 2t + 1,
// column g) are conflict-free too.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace egnn {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int T = 8;          // receivers per tile
constexpr int OPS = 8;        // band offsets per step
constexpr int M = T * OPS;    // edge rows per step

template <int HD>
struct Tile {
    static constexpr int WN = HD / 8 < NWARPS ? HD / 8 : NWARPS;   // warps across columns
    static constexpr int WM = NWARPS / WN;                          // warps across rows
    static constexpr int MT = M / 16 / WM;                          // m16 tiles per warp
    static constexpr int NT = HD / 8 / WN;                          // n8 tiles per warp
    static constexpr int AS = HD + 8;                               // A row stride
    static constexpr int BS = HD + 4;                               // ring row stride
    static_assert(WM * WN == NWARPS && MT >= 1 && NT >= 1, "tile does not divide");
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
    for (int v = tid; v < BK * F4R; v += THREADS) {
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

// Write the lane's fragments of `acc` into the [M][AS] tile A (float2 per
// row and column pair; conflict-free). The caller synchronises afterwards.
template <int HD>
__device__ __forceinline__ void store_tile(float* A, const float (&acc)[Tile<HD>::MT][Tile<HD>::NT][4],
                                           const Lane& ln) {
    using TL = Tile<HD>;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < TL::NT; ++nt)
                *reinterpret_cast<float2*>(A + (ln.row0 + mt * 16 + 8 * h) * TL::AS + ln.col0 + nt * 8) =
                    make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
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

// f(Int<HD>{}, Type<In>{}, Int<PASSES>{}) for the run-time hidden width hd
// (32, 64, 128 or 256), input type In of a / bs (bf16 when bf16_in, else
// fp32) and TF32 passes (1 or 3); cudaErrorInvalidValue for anything else.
template <class F>
cudaError_t dispatch(int hd, int bf16_in, int passes, F&& f) {
    auto by_hd = [&](auto t, auto p) -> cudaError_t {
        switch (hd) {
            case 32:  return f(Int<32>{}, t, p);
            case 64:  return f(Int<64>{}, t, p);
            case 128: return f(Int<128>{}, t, p);
            case 256: return f(Int<256>{}, t, p);
            default:  return cudaErrorInvalidValue;
        }
    };
    auto by_passes = [&](auto t) -> cudaError_t {
        if (passes == 1) return by_hd(t, Int<1>{});
        if (passes == 3) return by_hd(t, Int<3>{});
        return cudaErrorInvalidValue;
    };
    return bf16_in ? by_passes(Type<__nv_bfloat16>{}) : by_passes(Type<float>{});
}

}  // namespace egnn
