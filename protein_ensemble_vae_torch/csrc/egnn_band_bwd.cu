// EGNN band backward: the gradient of egnn_band_fwd.cu's function, fp32.
//
// Replaces the TPU kernel `_bwd_merged_kernel` (with `_edge_chain_cotangents`)
// of the JAX package's ops/pallas/egnn_band.py, entered through `_fused_bwd`.
// Per valid edge (i, j = i + d) it recomputes the forward chain
//     pre = a_i + bs_j + d2 * w_d,  m1 = silu(pre),  u = m1 @ W_e2 + b_e2,
//     m = silu(u),  v = m @ W_x1 + b_x1,  w1 = silu(v),  wsc = w1 . w_x2 + b_x2
// and the cotangent chain, given g_agg and g_delta:
//     cot_wsc = valid * (g_delta_i . rel)       cot_v = cot_wsc * w_x2 * silu'(v)
//     cot_m   = valid * g_agg_i + cot_v @ W_x1^T  cot_u = cot_m * silu'(u)
//     cot_pre = (cot_u @ W_e2^T) * silu'(pre)   cot_d2 = cot_pre . w_d
//     d_rel   = valid * wsc * g_delta_i + 2 * rel * cot_d2
// and emits d_a_i += cot_pre, d_bs_j += cot_pre, d_x_i += d_rel, d_x_j -= d_rel,
// dW_e2 = sum m1^T cot_u, dW_x1 = sum m^T cot_v, and the bias / vector grads.
//
// What bounds it: operations. Six Hd x Hd products per edge (two recomputed,
// two cotangent, two weight-grad outer products): 12 Hd^2 FLOP per edge.
//
// Design. The TPU kernel relied on its grid running in order: it added the
// sender cotangents into padded windows and the weight grads into shared
// outputs. GPU blocks run in parallel and in no order, so every sum across
// blocks here is a separate pass in a fixed order, with no atomics: two
// launches on the same inputs give bitwise-identical outputs.
//   1. edge pass (one block per batch row x 8 receivers, 256 threads, the
//      forward kernel's 64-edge tiles and weight-streaming ring): the four
//      products of the chain per tile (W_e2^T and W_x1^T arrive transposed,
//      so all four stream row-major). It writes, per edge, m1, m, cot_u,
//      cot_v, cot_pre [E, Hd] and d_rel [E, 3] (E = B * L * 2W, invalid
//      edges hold zero cotangents) to a scratch buffer, and per block its
//      column sums of the vector grads (w_d, b_e2, b_x1, w_x2, b_x2).
//      Shared memory: the transposed activation tile (68 KB at Hd = 256),
//      silu'(u) of the tile (64 KB) and the ring (32 KB). Keeping the
//      [Hd, Hd] weight-grad sums in the block (256 KB each) would not fit;
//      the per-edge activations are what makes them one large product.
//   2. node pass (one block per residue): d_a_i = sum over i's 2W edges of
//      cot_pre, d_bs_j = sum over the 2W edges that reach j (a gather, not
//      a scatter), d_x likewise from d_rel. Fixed order, each row written once.
//   3. weight-grad pass: dW_e2 = M1^T @ COT_U and dW_x1 = MM^T @ COT_V as
//      split-K products (64 x 64 output tiles, NSPLIT slices of E), each
//      slice written to its own partial.
//   4. reduce pass: the NSPLIT weight-grad partials and the per-block
//      vector partials summed in index order.
// Scratch: 5 E Hd + 3 E floats of edge data, 2 NSPLIT Hd^2 of weight-grad
// partials, (L/8) B (4 Hd + 1) of vector partials: 420 MB at B4/L256/Hd256/W40.
// Later work: tensor cores (wgmma), the weight grads without the per-edge
// round trip, skipping fully masked offset steps.

#include "egnn_tile.cuh"

namespace {

using namespace egnn;

constexpr int NSPLIT = 16;   // slices of the edge dimension in the weight-grad pass
constexpr int NVEC = 4;      // vector grads summed per column: w_d, b_e2, b_x1, w_x2

__host__ __device__ inline size_t align4(size_t n) { return (n + 3) & ~size_t(3); }

struct Scratch {
    float *m1, *mm, *cotu, *cotv, *cotpre, *drel, *vpart, *wpart;
};

__host__ __device__ inline size_t vpart_stride(int hd) { return align4((size_t)NVEC * hd + 1); }

inline size_t scratch_floats(int B, int L, int hd, int W, Scratch* s, float* base) {
    const size_t E = (size_t)B * L * 2 * W;
    const size_t nblk = (size_t)B * ((L + T - 1) / T);
    size_t off = 0;
    auto take = [&](float** p, size_t n) {
        if (s) *p = base + off;
        off += align4(n);
    };
    Scratch tmp;
    Scratch* t = s ? s : &tmp;
    take(&t->m1, E * hd);
    take(&t->mm, E * hd);
    take(&t->cotu, E * hd);
    take(&t->cotv, E * hd);
    take(&t->cotpre, E * hd);
    take(&t->drel, E * 3);
    take(&t->vpart, nblk * vpart_stride(hd));
    take(&t->wpart, (size_t)2 * NSPLIT * hd * hd);
    return off;
}

// Sum the thread's per-column values s[j] over the 8 row groups of the block
// (fixed order) and add them into colacc[q * HD + c]. Begins and ends with a
// block barrier.
template <int HD>
__device__ __forceinline__ void col_reduce(const float (&s)[HD / 32], float* red, float* colacc,
                                           int q, int tid, int rg, int lane) {
    using C = Cols<HD>;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) red[rg * HD + C::col(lane, j)] = s[j];
    __syncthreads();
    for (int c = tid; c < HD; c += THREADS) {
        float t = 0.f;
#pragma unroll
        for (int g = 0; g < THREADS / 32; ++g) t += red[g * HD + c];
        colacc[q * HD + c] += t;
    }
    __syncthreads();
}

// Store the thread's 8 rows x CPT columns of `acc` into an [E, HD] array at
// the rows' edge indices (row_out < 0: the row is outside the band).
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[RPT][HD / 32],
                                           const int* row_out, int rg, int lane) {
    using C = Cols<HD>;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int er = row_out[rg * RPT + i];
        if (er < 0) continue;
        float* d = dst + (size_t)er * HD;
        if constexpr (C::V == 4) {
#pragma unroll
            for (int g = 0; g < C::CPT / 4; ++g)
                *reinterpret_cast<float4*>(d + C::col(lane, 4 * g)) =
                    make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
        } else {
#pragma unroll
            for (int j = 0; j < C::CPT; ++j) d[C::col(lane, j)] = acc[i][j];
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
egnn_bwd_edges(const float* __restrict__ a, const float* __restrict__ bs,
               const float* __restrict__ x, const float* __restrict__ cmask,
               const float* __restrict__ w_d, const float* __restrict__ w_e2,
               const float* __restrict__ b_e2, const float* __restrict__ w_x1,
               const float* __restrict__ b_x1, const float* __restrict__ w_x2,
               const float* __restrict__ b_x2, const float* __restrict__ w_e2t,
               const float* __restrict__ w_x1t, const float* __restrict__ g_agg,
               const float* __restrict__ g_delta, Scratch s, int L, int W) {
    using C = Cols<HD>;
    constexpr int CPT = C::CPT;
    extern __shared__ float4 smem4[];
    float* act = reinterpret_cast<float*>(smem4);      // [HD][MP]
    float* dsu = act + HD * MP;                        // [M][HD]  silu'(u)
    float* wbuf = dsu + M * HD;                        // [2][BK][HD]
    float* red = wbuf + 2 * BK * HD;                   // [8][HD]
    float* colacc = red + 8 * HD;                      // [NVEC * HD + 1]
    float* row_valid = colacc + align4(NVEC * HD + 1); // [M]
    float* row_d2 = row_valid + M;                     // [M]
    float* row_cw = row_d2 + M;                        // [M] cot_wsc
    float* row_wsc = row_cw + M;                       // [M]
    float* row_rel = row_wsc + M;                      // [M][3]
    int* row_j = reinterpret_cast<int*>(row_rel + 3 * M);  // [M]
    int* row_out = row_j + M;                              // [M] edge index or -1
    float* halo_cm = reinterpret_cast<float*>(row_out + M);  // [T + 2W]
    float* halo_x = halo_cm + (T + 2 * W);                   // [T + 2W][3]

    const int b = blockIdx.y;
    const int i0 = blockIdx.x * T;
    const int tid = threadIdx.x;
    const int rg = tid / 32;     // row group = the receiver of the thread's rows
    const int lane = tid % 32;
    const size_t row0 = (size_t)b * L;
    const float* a_b = a + row0 * HD;
    const float* bs_b = bs + row0 * HD;
    const int n_off = 2 * W;
    const int my_i = i0 + rg;    // RPT == OPS: a thread's 8 rows share one receiver

    const int H = T + 2 * W;
    for (int h = tid; h < H; h += THREADS) {
        const int sq = i0 - W + h;
        const bool in = sq >= 0 && sq < L;
        halo_cm[h] = in ? cmask[row0 + sq] : 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) halo_x[h * 3 + d] = in ? x[(row0 + sq) * 3 + d] : 0.f;
    }
    for (int q = tid; q < NVEC * HD + 1; q += THREADS) colacc[q] = 0.f;

    float acc[RPT][CPT];
    float cs[CPT];           // per-column sums over the thread's rows
    float part[RPT];         // per-row sums over the columns (warp-reduced)
    float gagg[CPT];         // g_agg of the thread's receiver

    const int n_steps = (n_off + OPS - 1) / OPS;
    for (int step = 0; step < n_steps; ++step) {
        __syncthreads();
        if (tid < M) {
            const int rr = tid / OPS, e = step * OPS + tid % OPS;
            const int i = i0 + rr;
            float v = 0.f, d2 = 0.f, cw = 0.f, rel[3] = {0.f, 0.f, 0.f};
            int j = 0, out = -1;
            if (e < n_off && i < L) {
                const int d = band_offset(e, W);
                const int hi = rr + W, hj = hi + d;
                j = i + d;
                out = (int)((row0 + i) * n_off + e);
                if (halo_cm[hi] > 0.5f && halo_cm[hj] > 0.5f) {
                    v = 1.f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) rel[c] = halo_x[hi * 3 + c] - halo_x[hj * 3 + c];
                    d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                    const float* gd = g_delta + (row0 + i) * 3;
                    cw = gd[0] * rel[0] + gd[1] * rel[1] + gd[2] * rel[2];
                }
            }
            row_valid[tid] = v;
            row_d2[tid] = d2;
            row_cw[tid] = cw;
            row_j[tid] = j;
            row_out[tid] = out;
#pragma unroll
            for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
        }
        __syncthreads();

        // m1 = silu(pre) into act^T and to the scratch; rows of invalid edges are 0.
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
            if (row_out[r] >= 0)
                *reinterpret_cast<float4*>(s.m1 + (size_t)row_out[r] * HD + 4 * c4) =
                    make_float4(p[0], p[1], p[2], p[3]);
        }
        if (my_i < L) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) gagg[j] = __ldg(g_agg + (row0 + my_i) * HD + C::col(lane, j));
        } else {
#pragma unroll
            for (int j = 0; j < CPT; ++j) gagg[j] = 0.f;
        }
        __syncthreads();

        // u = m1 @ W_e2 + b_e2; m = silu(u) -> act^T and scratch; keep silu'(u).
        gemm_tile<HD>(w_e2, act, wbuf, acc, tid, rg, lane);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int c = C::col(lane, j);
                const float u = acc[i][j] + __ldg(b_e2 + c);
                dsu[(rg * RPT + i) * HD + c] = dsilu(u);
                acc[i][j] = silu(u);
            }
        store_rows<HD>(s.mm, acc, row_out, rg, lane);
        store_tile_t<HD>(act, acc, rg, lane);
        __syncthreads();

        // v = m @ W_x1 + b_x1; wsc = silu(v) . w_x2 + b_x2; cot_v.
        gemm_tile<HD>(w_x1, act, wbuf, acc, tid, rg, lane);
#pragma unroll
        for (int j = 0; j < CPT; ++j) cs[j] = 0.f;
        float cs2[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) cs2[j] = 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const float cw = row_cw[rg * RPT + i];
            float sw = 0.f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int c = C::col(lane, j);
                const float v = acc[i][j] + __ldg(b_x1 + c);
                const float wx2 = __ldg(w_x2 + c);
                const float w1 = silu(v);
                sw = fmaf(w1, wx2, sw);
                const float cot_v = cw * wx2 * dsilu(v);
                cs[j] += w1 * cw;          // w_x2 grad
                cs2[j] += cot_v;           // b_x1 grad
                acc[i][j] = cot_v;
            }
            part[i] = sw;
        }
        warp_sum_rows(part);
        if (lane == 0) {
            const float bx2 = b_x2[0];
#pragma unroll
            for (int i = 0; i < RPT; ++i) row_wsc[rg * RPT + i] = part[i] + bx2;
        }
        store_rows<HD>(s.cotv, acc, row_out, rg, lane);
        store_tile_t<HD>(act, acc, rg, lane);
        col_reduce<HD>(cs, red, colacc, 3, tid, rg, lane);
        col_reduce<HD>(cs2, red, colacc, 2, tid, rg, lane);

        // cot_m = valid * g_agg + cot_v @ W_x1^T; cot_u = cot_m * silu'(u).
        gemm_tile<HD>(w_x1t, act, wbuf, acc, tid, rg, lane);
#pragma unroll
        for (int j = 0; j < CPT; ++j) cs[j] = 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = rg * RPT + i;
            const float valid = row_valid[r];
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int c = C::col(lane, j);
                const float cot_u = (valid * gagg[j] + acc[i][j]) * dsu[r * HD + c];
                cs[j] += cot_u;
                acc[i][j] = cot_u;
            }
        }
        store_rows<HD>(s.cotu, acc, row_out, rg, lane);
        store_tile_t<HD>(act, acc, rg, lane);
        col_reduce<HD>(cs, red, colacc, 1, tid, rg, lane);

        // cot_pre = (cot_u @ W_e2^T) * silu'(pre); cot_d2 = cot_pre . w_d.
        gemm_tile<HD>(w_e2t, act, wbuf, acc, tid, rg, lane);
#pragma unroll
        for (int j = 0; j < CPT; ++j) cs[j] = 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = rg * RPT + i;
            float sd = 0.f;
            if (row_valid[r] > 0.f) {
                const float d2 = row_d2[r];
                const float* bs_j = bs_b + (size_t)row_j[r] * HD;
                const float* a_i = a_b + (size_t)my_i * HD;
#pragma unroll
                for (int j = 0; j < CPT; ++j) {
                    const int c = C::col(lane, j);
                    const float wd = __ldg(w_d + c);
                    const float pre = __ldg(a_i + c) + __ldg(bs_j + c) + d2 * wd;
                    const float cp = acc[i][j] * dsilu(pre);
                    acc[i][j] = cp;
                    sd = fmaf(cp, wd, sd);
                    cs[j] += cp * d2;      // w_d grad
                }
            } else {
#pragma unroll
                for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
            }
            part[i] = sd;
        }
        warp_sum_rows(part);
        store_rows<HD>(s.cotpre, acc, row_out, rg, lane);
        if (lane == 0) {
            const float* gd = g_delta + (row0 + (my_i < L ? my_i : 0)) * 3;
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = rg * RPT + i;
                const int er = row_out[r];
                if (er < 0) continue;
                const float vw = row_valid[r] * row_wsc[r];
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    s.drel[(size_t)er * 3 + d] = vw * gd[d] + 2.f * row_rel[r * 3 + d] * part[i];
            }
        }
        col_reduce<HD>(cs, red, colacc, 0, tid, rg, lane);
        if (tid == 0) {
            float t = 0.f;
            for (int r = 0; r < M; ++r) t += row_cw[r];
            colacc[NVEC * HD] += t;   // b_x2 grad
        }
    }
    __syncthreads();
    float* vp = s.vpart + ((size_t)b * gridDim.x + blockIdx.x) * vpart_stride(HD);
    for (int q = tid; q < NVEC * HD + 1; q += THREADS) vp[q] = colacc[q];
}

// d_a, d_bs, d_x of residue (b, i): gathers over the 2W edges of i as a
// receiver (d_a, d_x += d_rel) and as a sender (d_bs, d_x -= d_rel).
__global__ void __launch_bounds__(THREADS)
egnn_bwd_nodes(const float* __restrict__ cotpre, const float* __restrict__ drel,
               float* __restrict__ da, float* __restrict__ dbs, float* __restrict__ dx,
               int L, int hd, int W) {
    const int i = blockIdx.x, b = blockIdx.y;
    const int n_off = 2 * W;
    const size_t row = (size_t)b * L + i;
    for (int c = threadIdx.x; c < hd; c += THREADS) {
        float sa = 0.f, sb = 0.f;
        for (int e = 0; e < n_off; ++e) {
            sa += cotpre[(row * n_off + e) * hd + c];
            const int r = i - band_offset(e, W);     // receiver whose edge e reaches i
            if (r >= 0 && r < L) sb += cotpre[(((size_t)b * L + r) * n_off + e) * hd + c];
        }
        da[row * hd + c] = sa;
        dbs[row * hd + c] = sb;
    }
    if (threadIdx.x < 3) {
        const int d = threadIdx.x;
        float sx = 0.f;
        for (int e = 0; e < n_off; ++e) {
            sx += drel[(row * n_off + e) * 3 + d];
            const int r = i - band_offset(e, W);
            if (r >= 0 && r < L) sx -= drel[(((size_t)b * L + r) * n_off + e) * 3 + d];
        }
        dx[row * 3 + d] = sx;
    }
}

// Split-K weight grads: part[z][s] = X_z[rows of slice s]^T @ Y_z[same rows],
// z = 0: (m1, cot_u) -> dW_e2, z = 1: (m, cot_v) -> dW_x1. One block per
// TW x TW output tile, 256 threads as 16 x 16, each R x R outputs.
template <int TW>
__global__ void __launch_bounds__(THREADS)
egnn_bwd_wgrad(const float* __restrict__ x0, const float* __restrict__ y0,
               const float* __restrict__ x1, const float* __restrict__ y1,
               float* __restrict__ part, size_t E, int hd) {
    constexpr int KB = 16, R = TW / 16;
    __shared__ __align__(16) float xs[KB][TW];
    __shared__ __align__(16) float ys[KB][TW];
    const int tiles_n = hd / TW;
    const int m0 = (blockIdx.x / tiles_n) * TW, n0 = (blockIdx.x % tiles_n) * TW;
    const int sl = blockIdx.y, z = blockIdx.z;
    const float* X = z ? x1 : x0;
    const float* Y = z ? y1 : y0;
    const size_t per = (E + NSPLIT - 1) / NSPLIT;
    const size_t k0 = sl * per, k1 = k0 + per < E ? k0 + per : E;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[R][R];
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
        for (int q = 0; q < R; ++q) acc[p][q] = 0.f;
    constexpr int F4 = KB * TW / 4;   // float4s per staged operand
    for (size_t k = k0; k < k1; k += KB) {
        for (int v = threadIdx.x; v < F4; v += THREADS) {
            const int kk = v / (TW / 4), c4 = v % (TW / 4);
            float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
            if (k + kk < k1) {
                xv = *reinterpret_cast<const float4*>(X + (k + kk) * hd + m0 + 4 * c4);
                yv = *reinterpret_cast<const float4*>(Y + (k + kk) * hd + n0 + 4 * c4);
            }
            *reinterpret_cast<float4*>(&xs[kk][4 * c4]) = xv;
            *reinterpret_cast<float4*>(&ys[kk][4 * c4]) = yv;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
            float xv[R], yv[R];
#pragma unroll
            for (int p = 0; p < R; ++p) xv[p] = xs[kk][ty * R + p];
#pragma unroll
            for (int q = 0; q < R; ++q) yv[q] = ys[kk][tx * R + q];
#pragma unroll
            for (int p = 0; p < R; ++p)
#pragma unroll
                for (int q = 0; q < R; ++q) acc[p][q] = fmaf(xv[p], yv[q], acc[p][q]);
        }
        __syncthreads();
    }
    float* out = part + ((size_t)z * NSPLIT + sl) * hd * hd;
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
        for (int q = 0; q < R; ++q) out[(size_t)(m0 + ty * R + p) * hd + n0 + tx * R + q] = acc[p][q];
}

// Sum the partials in index order: the NSPLIT weight-grad slices into
// dw_e2 / dw_x1, the per-block vector partials into dvec.
__global__ void egnn_bwd_reduce(const float* __restrict__ wpart, const float* __restrict__ vpart,
                                float* __restrict__ dw_e2, float* __restrict__ dw_x1,
                                float* __restrict__ dvec, int hd, int nblk) {
    const size_t n_w = (size_t)hd * hd;
    const size_t n_v = (size_t)NVEC * hd + 1;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx < 2 * n_w) {
        const int z = idx >= n_w;
        const size_t k = idx - z * n_w;
        float t = 0.f;
        for (int sl = 0; sl < NSPLIT; ++sl) t += wpart[((size_t)z * NSPLIT + sl) * n_w + k];
        (z ? dw_x1 : dw_e2)[k] = t;
    } else if (idx < 2 * n_w + n_v) {
        const size_t q = idx - 2 * n_w;
        float t = 0.f;
        for (int blk = 0; blk < nblk; ++blk) t += vpart[(size_t)blk * vpart_stride(hd) + q];
        dvec[q] = t;
    }
}

size_t edge_smem_bytes(int hd, int W) {
    return sizeof(float) * ((size_t)hd * MP + (size_t)M * hd + 2 * BK * hd + 8 * hd
                            + align4(NVEC * hd + 1) + 9 * M + 4 * (T + 2 * W));
}

template <int HD>
cudaError_t launch(const float* const* in, float* da, float* dbs, float* dx, float* dw_e2,
                   float* dw_x1, float* dvec, float* scratch, int B, int L, int W,
                   cudaStream_t stream) {
    Scratch s;
    scratch_floats(B, L, HD, W, &s, scratch);
    const size_t smem = edge_smem_bytes(HD, W);
    cudaError_t err = cudaFuncSetAttribute(egnn_bwd_edges<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (L + T - 1) / T;
    egnn_bwd_edges<HD><<<dim3(n_tiles, B), THREADS, smem, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
        in[11], in[12], in[13], in[14], s, L, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    egnn_bwd_nodes<<<dim3(L, B), THREADS, 0, stream>>>(s.cotpre, s.drel, da, dbs, dx, L, HD, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    constexpr int TW = HD < 64 ? HD : 64;
    const size_t E = (size_t)B * L * 2 * W;
    egnn_bwd_wgrad<TW><<<dim3((HD / TW) * (HD / TW), NSPLIT, 2), THREADS, 0, stream>>>(
        s.m1, s.cotu, s.mm, s.cotv, s.wpart, E, HD);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t n_out = 2 * (size_t)HD * HD + NVEC * HD + 1;
    egnn_bwd_reduce<<<(unsigned)((n_out + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        s.wpart, s.vpart, dw_e2, dw_x1, dvec, HD, B * n_tiles);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch one call needs (the caller allocates it).
size_t egnn_band_bwd_scratch_floats(int B, int L, int hd, int W) {
    return scratch_floats(B, L, hd, W, nullptr, nullptr);
}

// Shared memory one block of the edge pass needs.
size_t egnn_band_bwd_smem_bytes(int hd, int W) { return edge_smem_bytes(hd, W); }

// Launch the four passes on `stream`; returns the CUDA error code (0 = success).
// Device pointers to contiguous fp32 arrays, 16-byte aligned:
// a, bs, g_agg [B, L, hd]; x, g_delta [B, L, 3]; cmask [B, L]; w_d, b_e2, b_x1,
// w_x2 [hd]; w_e2, w_x1 and their transposes w_e2t, w_x1t [hd, hd]; b_x2 [1].
// Outputs: da, dbs [B, L, hd]; dx [B, L, 3]; dw_e2, dw_x1 [hd, hd] (in, out);
// dvec [4 hd + 1] = (dw_d, db_e2, db_x1, dw_x2, db_x2); scratch as sized above.
int egnn_band_bwd_f32(const float* a, const float* bs, const float* x, const float* cmask,
                      const float* w_d, const float* w_e2, const float* b_e2,
                      const float* w_x1, const float* b_x1, const float* w_x2,
                      const float* b_x2, const float* w_e2t, const float* w_x1t,
                      const float* g_agg, const float* g_delta, float* da, float* dbs,
                      float* dx, float* dw_e2, float* dw_x1, float* dvec, float* scratch,
                      int B, int L, int hd, int W, void* stream) {
    const float* in[15] = {a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                           w_e2t, w_x1t, g_agg, g_delta};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32:  return launch<32>(in, da, dbs, dx, dw_e2, dw_x1, dvec, scratch, B, L, W, s);
        case 64:  return launch<64>(in, da, dbs, dx, dw_e2, dw_x1, dvec, scratch, B, L, W, s);
        case 128: return launch<128>(in, da, dbs, dx, dw_e2, dw_x1, dvec, scratch, B, L, W, s);
        case 256: return launch<256>(in, da, dbs, dx, dw_e2, dw_x1, dvec, scratch, B, L, W, s);
        default:  return cudaErrorInvalidValue;
    }
}

const char* egnn_band_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
