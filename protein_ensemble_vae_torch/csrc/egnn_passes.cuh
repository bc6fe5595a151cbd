// Passes shared by the band kernels' sources: kernel 1's slice sum
// (egnn_band_fwd.cu, egnn_band_fwd_sm90.cu) and kernel 2's node and reduce
// passes with their scratch helpers (egnn_band_bwd.cu,
// egnn_band_bwd_sm90.cu). Each source compiles its own copy, in the
// translation unit's one unnamed namespace (a second, nested one would give
// nvcc's host stubs two candidates for it).

#pragma once

#include "egnn_tile.cuh"

namespace {

using namespace egnn;

constexpr int NVEC = 4;      // vector grads summed per column: w_d, b_e2, b_x1, w_x2

__host__ __device__ inline size_t align4(size_t n) { return (n + 3) & ~size_t(3); }
__host__ __device__ inline size_t vpart_stride(int hd) { return align4((size_t)NVEC * hd + 1); }
inline int n_items(int B, int L, int W) {
    return B * ((L + T - 1) / T) * ((2 * W + OPS - 1) / OPS);
}

// out[k] = sum over s of part[s][k], in slice order (float4 over agg).
__global__ void __launch_bounds__(THREADS)
egnn_band_fwd_sum(const float* __restrict__ part_agg, const float* __restrict__ part_delta,
                  float* __restrict__ agg, float* __restrict__ delta, size_t n_agg4,
                  size_t n_delta, int S) {
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n_agg4 + n_delta; k += stride) {
        if (k < n_agg4) {
            const float4* p = reinterpret_cast<const float4*>(part_agg) + k;
            float4 t = p[0];
            for (int s = 1; s < S; ++s) {
                const float4 q = p[(size_t)s * n_agg4];
                t.x += q.x; t.y += q.y; t.z += q.z; t.w += q.w;
            }
            reinterpret_cast<float4*>(agg)[k] = t;
        } else {
            const size_t q = k - n_agg4;
            float t = part_delta[q];
            for (int s = 1; s < S; ++s) t += part_delta[(size_t)s * n_delta + q];
            delta[q] = t;
        }
    }
}

// d_a, d_bs, d_x of residue (b, i): gathers over the 2W edges of i as a
// receiver (d_a, d_x += d_rel) and as a sender (d_bs, d_x -= d_rel), in
// offset order, skipping the rows of items with no valid edge. cot_pre is
// read in the chain's type Act; d_a, d_bs are summed in fp32 and stored in
// Out, the type of a and bs.
template <class Out, class Act>
__global__ void __launch_bounds__(THREADS)
egnn_bwd_nodes(const Act* __restrict__ cotpre, const float* __restrict__ drel,
               const int* __restrict__ flags, Out* __restrict__ da, Out* __restrict__ dbs,
               float* __restrict__ dx, int L, int hd, int W) {
    extern __shared__ int erows[];   // [2][2W]: scratch row of (i, e) and of (i - d(e), e), or -1
    const int i = blockIdx.x, b = blockIdx.y;
    const int n_off = 2 * W;
    const int n_steps = (n_off + OPS - 1) / OPS;
    const int n_tiles = (L + T - 1) / T;
    const size_t row = (size_t)b * L + i;
    auto erow = [&](int r, int e) -> int {
        const int item = (b * n_tiles + r / T) * n_steps + e / OPS;
        return flags[item] ? item * M + (e % OPS) * T + r % T : -1;
    };
    for (int e = threadIdx.x; e < n_off; e += blockDim.x) {
        erows[e] = erow(i, e);
        const int r = i - band_offset(e, W);   // receiver whose edge e reaches i
        erows[n_off + e] = (r >= 0 && r < L) ? erow(r, e) : -1;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < hd; c += blockDim.x) {
        float sa = 0.f, sb = 0.f;
        for (int e = 0; e < n_off; ++e) {
            if (erows[e] >= 0) sa += to_float(cotpre[(size_t)erows[e] * hd + c]);
            if (erows[n_off + e] >= 0) sb += to_float(cotpre[(size_t)erows[n_off + e] * hd + c]);
        }
        store(da + row * hd + c, sa);
        store(dbs + row * hd + c, sb);
    }
    if (threadIdx.x < 3) {
        const int d = threadIdx.x;
        float sx = 0.f;
        for (int e = 0; e < n_off; ++e) {
            if (erows[e] >= 0) sx += drel[(size_t)erows[e] * 3 + d];
            if (erows[n_off + e] >= 0) sx -= drel[(size_t)erows[n_off + e] * 3 + d];
        }
        dx[row * 3 + d] = sx;
    }
}

// The valid items of slice sl of `items` work items (nsplit slices), in
// order, into `list` (by warp 0); returns their count to every thread.
__device__ __forceinline__ int valid_items(const int* __restrict__ flags, int items, int nsplit,
                                           int sl, int* list) {
    __shared__ int n_valid;
    const int per = (items + nsplit - 1) / nsplit;
    const int it0 = sl * per, it1 = min(items, it0 + per);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
        int cnt = 0;
        for (int base = it0; base < it1; base += 32) {
            const int it = base + lane;
            const bool f = it < it1 && flags[it] != 0;
            const unsigned mask = __ballot_sync(0xffffffffu, f);
            if (f) list[cnt + __popc(mask & ((1u << lane) - 1u))] = it;
            cnt += __popc(mask);
        }
        if (lane == 0) n_valid = cnt;
    }
    __syncthreads();
    return n_valid;
}

// Sum the partials in index order: the nsplit weight-grad slices into
// dw_e2 / dw_x1, the nblk per-block vector partials into dvec.
__global__ void egnn_bwd_reduce(const float* __restrict__ wpart, const float* __restrict__ vpart,
                                float* __restrict__ dw_e2, float* __restrict__ dw_x1,
                                float* __restrict__ dvec, int hd, int nblk, int nsplit) {
    const size_t n_w = (size_t)hd * hd;
    const size_t n_v = (size_t)NVEC * hd + 1;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx < 2 * n_w) {
        const int z = idx >= n_w;
        const size_t k = idx - z * n_w;
        float t = 0.f;
        for (int sl = 0; sl < nsplit; ++sl) t += wpart[((size_t)z * nsplit + sl) * n_w + k];
        (z ? dw_x1 : dw_e2)[k] = t;
    } else if (idx < 2 * n_w + n_v) {
        const size_t q = idx - 2 * n_w;
        float t = 0.f;
        for (int blk = 0; blk < nblk; ++blk) t += vpart[(size_t)blk * vpart_stride(hd) + q];
        dvec[q] = t;
    }
}

}  // namespace
