// Shared pieces of the EGNN band kernels (egnn_band_fwd.cu, egnn_band_bwd.cu):
// a 64-row edge tile times an Hd x Hd weight streamed through shared memory.
//
// Layout: 256 threads = 8 warps; warp rg owns edge rows rg*8 .. rg*8+7, and
// lane `lane` owns the Hd/32 columns Cols<HD>::col(lane, j). The activation
// tile is stored transposed, [HD][MP], so one float4 read gives a thread its
// 8 rows of one input feature; the weight [HD][HD] (in, out) streams through
// a double-buffered ring of BK rows with cp.async.

#pragma once

#include <cuda_runtime.h>

namespace egnn {

constexpr int THREADS = 256;
constexpr int T = 8;          // receivers per block
constexpr int OPS = 8;        // band offsets per step
constexpr int M = T * OPS;    // edge rows per step
constexpr int MP = M + 4;     // row stride of the transposed activation tile
constexpr int BK = 16;        // weight rows per streamed chunk
constexpr int RPT = 8;        // rows per thread (8 row groups of 8 rows)

constexpr int RECV = RPT / OPS;   // receivers per thread

static_assert(M == RPT * (THREADS / 32), "one warp per 8-row group");
static_assert(RPT % OPS == 0, "a thread's rows cover whole receivers");

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

template <int HD>
struct Cols {
    static constexpr int CPT = HD / 32;            // columns per thread
    static constexpr int V = CPT < 4 ? CPT : 4;    // contiguous columns per group
    // column of the thread's j-th value: groups of V contiguous columns,
    // neighbouring lanes on neighbouring groups (conflict-free smem reads).
    __device__ static __forceinline__ int col(int lane, int j) {
        return (j / V) * (32 * V) + lane * V + (j % V);
    }
};

// Issue the cp.async copies of weight rows [kc*BK, kc*BK + BK) into `dst`.
template <int HD>
__device__ __forceinline__ void load_chunk(const float* __restrict__ w, int kc,
                                           float* dst, int tid) {
    constexpr int F4 = BK * HD / 4;
    const float* src = w + (size_t)kc * BK * HD;
    for (int v = tid; v < F4; v += THREADS) cp_async16(dst + 4 * v, src + 4 * v);
    cp_async_commit();
}

// acc[8][CPT] = act^T[rows of this thread, :] @ w[:, cols of this thread].
// `act` is the transposed activation tile [HD][MP]; `w` is [HD][HD] (in, out).
// Ends with a block barrier, so `act` may be overwritten afterwards.
template <int HD>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ w, const float* act,
                                          float* wbuf, float (&acc)[RPT][HD / 32],
                                          int tid, int rg, int lane) {
    using C = Cols<HD>;
    constexpr int NCHUNK = HD / BK;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) acc[i][j] = 0.f;

    load_chunk<HD>(w, 0, wbuf, tid);
    for (int kc = 0; kc < NCHUNK; ++kc) {
        if (kc + 1 < NCHUNK) {
            load_chunk<HD>(w, kc + 1, wbuf + ((kc + 1) & 1) * BK * HD, tid);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* wb = wbuf + (kc & 1) * BK * HD;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float* arow = act + (kc * BK + kk) * MP + rg * RPT;
            const float4 a0 = *reinterpret_cast<const float4*>(arow);
            const float4 a1 = *reinterpret_cast<const float4*>(arow + 4);
            const float av[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            float bv[C::CPT];
            const float* brow = wb + kk * HD;
            if constexpr (C::V == 4) {
#pragma unroll
                for (int g = 0; g < C::CPT / 4; ++g) {
                    const float4 t = *reinterpret_cast<const float4*>(brow + C::col(lane, 4 * g));
                    bv[4 * g] = t.x; bv[4 * g + 1] = t.y; bv[4 * g + 2] = t.z; bv[4 * g + 3] = t.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < C::CPT; ++j) bv[j] = brow[C::col(lane, j)];
            }
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < C::CPT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();   // buffer (kc & 1) is refilled two chunks later
    }
}

// Write the thread's acc[8][CPT] into the transposed tile act[HD][MP].
template <int HD>
__device__ __forceinline__ void store_tile_t(float* act, const float (&acc)[RPT][HD / 32],
                                             int rg, int lane) {
    using C = Cols<HD>;
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) {
        float* dst = act + C::col(lane, j) * MP + rg * RPT;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
}

// Sum v over the 32 lanes of each warp, for each of the thread's 8 rows.
__device__ __forceinline__ void warp_sum_rows(float (&v)[RPT]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < RPT; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
}

// Band offset of non-self offset slot e in [0, 2W): -W..-1, 1..W.
__device__ __forceinline__ int band_offset(int e, int W) { return e < W ? e - W : e - W + 1; }

}  // namespace egnn
