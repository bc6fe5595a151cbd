// EGNN band forward: fused message passing of one banded EGNN layer, fp32.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/egnn_band.py (entered through `egnn_band_fused`). For receiver i
// and band offset d = j - i in [-W, W] \ {0}:
//     pre  = a_i + bs_j + |x_i - x_j|^2 * w_d
//     m    = silu(silu(pre) @ W_e2 + b_e2)
//     agg_i       = sum_d valid * m
//     raw_delta_i = sum_d valid * (silu(m @ W_x1 + b_x1) . w_x2 + b_x2) * (x_i - x_j)
// valid = 0 <= j < L and cmask_i > 0.5 and cmask_j > 0.5. Nothing of size
// K = 2W+1 reaches device memory: each output row is written once.
//
// What bounds it: operations. Per edge the two Hd x Hd products cost
// 4*Hd^2 FLOP (262,144 at Hd=256) against ~2*Hd*4 bytes of fresh input, so
// the kernel sits far above the card's fp32 ridge. It runs in full fp32 FMA
// (no TF32): the JAX side calls its kernel with Precision.HIGHEST for fp32
// models.
//
// Design:
// - One block per (batch row, tile of T = 8 receivers), 256 threads. The
//   block walks the 2W non-self offsets OPS = 8 at a time, so one step is a
//   64-row edge tile (row r = receiver (r / 8), offset slot (r % 8)).
//   Small tiles matter at one block per SM: 16 receivers per block would
//   leave B=1 decodes on 16-40 of the 132 SMs, 8 use twice as many blocks,
//   each living half as long.
// - The x / cmask halo of the tile (T + 2W rows) is staged in shared memory
//   once; out-of-range senders read cmask 0 from the halo, so the ragged
//   ends of the sequence need no padded copy of bs or x. The bs and a rows
//   (1 KB each at Hd=256) are read through L1/L2 only for valid edges: a
//   shared bs halo would take (T + 2W) KB, the binding resource below.
// - Shared memory shapes the design: W_e2 and W_x1 together are 512 KB and
//   cannot stay resident (227 KB per block). Each 64 x Hd activation tile
//   lives in shared memory (transposed, 68 KB at Hd=256) and each weight
//   streams through a double-buffered ring of BK = 16 rows (32 KB) with
//   cp.async, once per GEMM per step: ~105 KB per block. Registers are what
//   limits residency (171 per thread at Hd=256, no spills: one block
//   per SM).
// - Each thread owns an 8-row x (Hd/32)-column register tile of both
//   products. Its 8 rows are 1 receiver x 8 offsets, so `agg` accumulates
//   in the thread's registers across all steps with no cross-thread
//   reduction; the per-row w_x2 dot product is reduced across the warp
//   (one warp = one row group) with shuffles.
// Later work: tensor cores (wgmma) in a TF32 or bf16 mode, TMA for the
// weight ring, and skipping fully-masked offset steps.

#include "egnn_tile.cuh"

namespace {

using namespace egnn;

template <int HD>
__global__ void __launch_bounds__(THREADS)
egnn_band_fwd_kernel(const float* __restrict__ a, const float* __restrict__ bs,
                     const float* __restrict__ x, const float* __restrict__ cmask,
                     const float* __restrict__ w_d, const float* __restrict__ w_e2,
                     const float* __restrict__ b_e2, const float* __restrict__ w_x1,
                     const float* __restrict__ b_x1, const float* __restrict__ w_x2,
                     const float* __restrict__ b_x2, float* __restrict__ agg,
                     float* __restrict__ delta, int L, int W) {
    using C = Cols<HD>;
    constexpr int CPT = C::CPT;
    extern __shared__ float4 smem4[];
    float* act = reinterpret_cast<float*>(smem4);      // [HD][MP]
    float* wbuf = act + HD * MP;                       // [2][BK][HD]
    float* row_valid = wbuf + 2 * BK * HD;             // [M]
    float* row_d2 = row_valid + M;                     // [M]
    float* row_rel = row_d2 + M;                       // [M][3]
    int* row_j = reinterpret_cast<int*>(row_rel + 3 * M);  // [M]
    float* halo_cm = reinterpret_cast<float*>(row_j + M);  // [T + 2W]
    float* halo_x = halo_cm + (T + 2 * W);                 // [T + 2W][3]

    const int b = blockIdx.y;
    const int i0 = blockIdx.x * T;
    const int tid = threadIdx.x;
    const int rg = tid / 32;     // row group: rows rg*8 .. rg*8+7
    const int lane = tid % 32;   // column group
    const size_t row0 = (size_t)b * L;
    const float* a_b = a + row0 * HD;
    const float* bs_b = bs + row0 * HD;

    // Halo row h holds sequence position i0 - W + h (cmask 0 outside [0, L)).
    const int H = T + 2 * W;
    for (int h = tid; h < H; h += THREADS) {
        const int s = i0 - W + h;
        const bool in = s >= 0 && s < L;
        halo_cm[h] = in ? cmask[row0 + s] : 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) halo_x[h * 3 + d] = in ? x[(row0 + s) * 3 + d] : 0.f;
    }

    float acc[RPT][CPT];
    float agg_r[RECV][CPT];  // this thread's receivers x CPT columns
    float delta_r[RECV][3];  // kept by lane 0 of each warp
#pragma unroll
    for (int u = 0; u < RECV; ++u) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) agg_r[u][j] = 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) delta_r[u][d] = 0.f;
    }

    float be2[CPT], bx1[CPT], wx2[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        be2[j] = b_e2[C::col(lane, j)];
        bx1[j] = b_x1[C::col(lane, j)];
        wx2[j] = w_x2[C::col(lane, j)];
    }
    const float bx2 = b_x2[0];

    const int n_off = 2 * W;
    const int n_steps = (n_off + OPS - 1) / OPS;
    for (int step = 0; step < n_steps; ++step) {
        __syncthreads();   // halo written / last step's row arrays read
        if (tid < M) {
            const int rr = tid / OPS, e = step * OPS + tid % OPS;
            const int i = i0 + rr;
            float v = 0.f, d2 = 0.f, rel[3] = {0.f, 0.f, 0.f};
            int j = 0;
            if (e < n_off && i < L) {
                const int d = e < W ? e - W : e - W + 1;   // skip the self edge
                const int hi = rr + W, hj = hi + d;
                j = i + d;
                if (halo_cm[hi] > 0.5f && halo_cm[hj] > 0.5f) {
                    v = 1.f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) rel[c] = halo_x[hi * 3 + c] - halo_x[hj * 3 + c];
                    d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                }
            }
            row_valid[tid] = v;
            row_d2[tid] = d2;
            row_j[tid] = j;
#pragma unroll
            for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
        }
        __syncthreads();

        // act^T = silu(a_i + bs_j + d2 * w_d); rows of invalid edges are 0.
        constexpr int HD4 = HD / 4;
        for (int idx = tid; idx < M * HD4; idx += THREADS) {
            const int r = idx / HD4, c4 = idx % HD4;
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            if (row_valid[r] > 0.f) {
                const int i = i0 + r / OPS;
                const float4 av = __ldg(reinterpret_cast<const float4*>(a_b + (size_t)i * HD) + c4);
                const float4 bv = __ldg(reinterpret_cast<const float4*>(bs_b + (size_t)row_j[r] * HD) + c4);
                const float4 wd = __ldg(reinterpret_cast<const float4*>(w_d) + c4);
                const float d2 = row_d2[r];
                p[0] = silu(av.x + bv.x + d2 * wd.x);
                p[1] = silu(av.y + bv.y + d2 * wd.y);
                p[2] = silu(av.z + bv.z + d2 * wd.z);
                p[3] = silu(av.w + bv.w + d2 * wd.w);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) act[(4 * c4 + q) * MP + r] = p[q];
        }
        __syncthreads();

        // m = silu(act @ W_e2 + b_e2); agg += valid * m
        gemm_tile<HD>(w_e2, act, wbuf, acc, tid, rg, lane);
        float valid[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) valid[i] = row_valid[rg * RPT + i];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const float m = silu(acc[i][j] + be2[j]);
                acc[i][j] = m;
                if (valid[i] > 0.f) agg_r[i / OPS][j] += m;
            }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            float* dst = act + C::col(lane, j) * MP + rg * RPT;
            *reinterpret_cast<float4*>(dst) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
            *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
        }
        __syncthreads();

        // wsc = silu(m @ W_x1 + b_x1) . w_x2 + b_x2; delta += valid * wsc * rel
        gemm_tile<HD>(w_x1, act, wbuf, acc, tid, rg, lane);
        float part[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) s = fmaf(silu(acc[i][j] + bx1[j]), wx2[j], s);
            part[i] = s;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int i = 0; i < RPT; ++i) part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
        if (lane == 0) {
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = rg * RPT + i;
                if (valid[i] > 0.f) {
                    const float wsc = part[i] + bx2;
#pragma unroll
                    for (int d = 0; d < 3; ++d) delta_r[i / OPS][d] += wsc * row_rel[r * 3 + d];
                }
            }
        }
    }

    // Each output row is written once, by the threads that own it.
#pragma unroll
    for (int u = 0; u < RECV; ++u) {
        const int i = i0 + rg * RECV + u;
        if (i >= L) continue;
        float* dst = agg + (row0 + i) * HD;
#pragma unroll
        for (int j = 0; j < CPT; ++j) dst[C::col(lane, j)] = agg_r[u][j];
        if (lane == 0) {
#pragma unroll
            for (int d = 0; d < 3; ++d) delta[(row0 + i) * 3 + d] = delta_r[u][d];
        }
    }
}

size_t smem_bytes(int hd, int W) {
    return sizeof(float) * ((size_t)hd * MP + 2 * BK * hd + 6 * M + 4 * (T + 2 * W));
}

template <int HD>
cudaError_t launch(const float* a, const float* bs, const float* x, const float* cmask,
                   const float* w_d, const float* w_e2, const float* b_e2,
                   const float* w_x1, const float* b_x1, const float* w_x2,
                   const float* b_x2, float* agg, float* delta, int B, int L, int W,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes(HD, W);
    cudaError_t err = cudaFuncSetAttribute(egnn_band_fwd_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((L + T - 1) / T, B);
    egnn_band_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
        a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, agg, delta, L, W);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs at hidden width `hd` and band half-width W.
size_t egnn_band_fwd_smem_bytes(int hd, int W) { return smem_bytes(hd, W); }

// Launch on `stream`; returns the CUDA error code of the launch (0 = success).
// All pointers are device pointers to contiguous fp32 arrays, 16-byte aligned:
// a, bs [B, L, hd]; x [B, L, 3]; cmask [B, L]; w_d, b_e2, b_x1, w_x2 [hd];
// w_e2, w_x1 [hd, hd] (in, out); b_x2 [1]; agg [B, L, hd]; delta [B, L, 3].
int egnn_band_fwd_f32(const float* a, const float* bs, const float* x, const float* cmask,
                      const float* w_d, const float* w_e2, const float* b_e2,
                      const float* w_x1, const float* b_x1, const float* w_x2,
                      const float* b_x2, float* agg, float* delta, int B, int L, int hd,
                      int W, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32:  return launch<32>(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, agg, delta, B, L, W, s);
        case 64:  return launch<64>(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, agg, delta, B, L, W, s);
        case 128: return launch<128>(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, agg, delta, B, L, W, s);
        case 256: return launch<256>(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, agg, delta, B, L, W, s);
        default:  return cudaErrorInvalidValue;
    }
}

const char* egnn_band_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
