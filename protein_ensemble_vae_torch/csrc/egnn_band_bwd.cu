// EGNN band backward: the gradient of egnn_band_fwd.cu's function, in its
// modes (input type of a / bs; TF32 passes of the fp32 chain, or the bf16
// chain; egnn_tile.cuh).
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
// In the fp32-chain modes the chain and every sum run in fp32. In the bf16
// chain (chain_dtype=bfloat16) the recomputed forward and the cotangent
// chain run in bf16 as `_edge_chain_cotangents` rounds them: g_agg and
// cot_wsc cast to bf16, every elementwise op and `_dsilu` in bf16, each
// product's fp32 sum rounded to bf16; cot_d2 sums the bf16 cot_pre * w_d
// in fp32; d_rel, d_a, d_bs, d_x, the weight-grad products (bf16 operands)
// and the bias / vector grads sum in fp32, as in the other modes. d_a and
// d_bs are written in the type of a and bs (rounded to nearest even from
// bf16's fp32 sums, as the JAX side's `_fused_bwd` casts them).
//
// What bounds it: operations. Six Hd x Hd products per edge (two recomputed,
// two cotangent, two weight-grad outer products): 12 Hd^2 FLOP per edge. All
// six run on the tensor cores in the mode's passes: 3xTF32 reaches fp32
// accuracy as the JAX side's Precision.HIGHEST does through multi-pass
// products on the TPU, one pass is its precision=None (the JAX side passes
// `precision` to the cotangent and weight-grad products too,
// `_edge_chain_cotangents`); the tensor-core floor is PASSES x the FLOP at
// the TF32 rate, or in the bf16 chain the FLOP at the bf16 rate. The
// gradients' sums do not need kernel 1's per-step rounding (STEP_SUM off: a
// whole-model gradient check passes either way, and it would cost a fifth
// of the time), up to Hd 256. At Hd 512 the weight-grad pass takes four
// times fewer slices (its 32 output tiles fill the card at 9), so one
// accumulator sums ~9,000 edge rows: there it sums each k8 step in
// round-to-nearest fp32 (WGRAD_STEP_SUM), which brought dW_e2 from 2-5x the
// model-level gradient tolerance to within it (PERF.md, section 6). What
// holds the kernel above its floor: mma.sync latency at 16 warps per SM,
// 128 registers with spills, the elementwise chain, and the per-edge
// scratch round trip (see PERF.md).
//
// Design. The TPU kernel relied on its grid running in order: it added the
// sender cotangents into padded windows and the weight grads into shared
// outputs. GPU blocks run in parallel and in no order, so every sum across
// blocks here is a separate pass in a fixed order, with no atomics: two
// launches on the same inputs give bitwise-identical outputs.
//   1. edge pass, a persistent grid of G blocks, one per resident slot (two
//      per SM up to Hd = 256, one 512-thread block at Hd = 512; the caller
//      picks G from the occupancy query). The work items are (batch row, tile of 8
//      receivers, step of 8 band offsets), step fastest; block g takes items
//      g, g + G, ..., so each block's vector-grad partial is a fixed sum.
//      Per item: the four products of the chain on the 64-edge tile (W_e2^T
//      and W_x1^T arrive transposed, so all four stream row-major through
//      the cp.async ring). It writes m1, m, cot_u, cot_v, cot_pre [64, Hd]
//      and d_rel [64, 3] of the item to its 64 scratch rows (item-major),
//      and a flag per item. An item with no valid edge (padding, a masked
//      tile or window) writes nothing but its flag 0, and the later passes
//      skip it. Invalid edges of a valid item hold zero cotangents and m1.
//      silu'(u) waits in the item's own cot_u rows until cot_u overwrites
//      it, so shared memory holds only the 66 KB activation tile, a 4-stage
//      ring of 8-row chunks (33 KB) and the row / column sums: ~108 KB, two
//      blocks (16 warps) per SM. At Hd = 512 the tile (133 KB), the ring
//      (66 KB) and the sums take ~217 KB of the 227 KB a block may have:
//      one 16-warp block per SM, the same registers per thread.
//   2. node pass (one block per residue): d_a_i = sum over i's 2W edges of
//      cot_pre, d_bs_j = sum over the 2W edges that reach j (a gather, not
//      a scatter), d_x likewise from d_rel; rows of flag-0 items are skipped.
//   3. weight-grad pass: dW_e2 = M1^T @ COT_U and dW_x1 = M^T @ COT_V as
//      split-K 3xTF32 products: 128 x 128 output tiles (64 x 32 per warp; 32
//      tiles at Hd = 512),
//      NSPLIT slices of the items (the caller sizes NSPLIT so the grid fills
//      two slots per SM), flag-0 items skipped; each slice writes its own
//      partial.
//   4. reduce pass: the NSPLIT weight-grad partials and the G vector
//      partials summed in index order.
// Scratch, by mode: 5 R Hd activations (m1, m, cot_u, cot_v, cot_pre; R =
// 64 x items, = B L 2W when 8 divides L and 2W) in fp32, or in bf16 in the
// bf16 chain, 3 R floats of d_rel, the flags, G (4 Hd + 1) floats of vector
// partials; the weight-grad partials (2 NSPLIT Hd^2 floats) reuse cot_pre's
// rows where they fit, which the node pass has consumed by then: ~421 MB at
// B4/L256/Hd256/W40 in the fp32 chain, ~212 MB in the bf16 chain, twice
// that at Hd 512. The
// bf16 chain's weight-grad pass runs m16n8k16 bf16 products on the bf16
// activations (ldmatrix.trans fragments), summed in fp32.
// Left for later: wgmma for the products, TMA for the ring, the weight
// grads without the per-edge scratch round trip.

#include "egnn_tile.cuh"

namespace {

using namespace egnn;

constexpr int BK = 8;        // weight rows per ring chunk (fp32 chain)
constexpr int BKH = 16;      // weight rows per ring chunk (bf16 chain)
constexpr int STAGES = 4;    // ring depth
constexpr bool STEP_SUM = false;  // round-to-nearest sum of each k8 step (egnn_tile.cuh)
// the same in the weight-grad pass, by width (see the top of this file)
template <int HD>
constexpr bool WGRAD_STEP_SUM = HD >= 512;
constexpr int NVEC = 4;      // vector grads summed per column: w_d, b_e2, b_x1, w_x2

__host__ __device__ inline size_t align4(size_t n) { return (n + 3) & ~size_t(3); }
__host__ __device__ inline size_t vpart_stride(int hd) { return align4((size_t)NVEC * hd + 1); }
inline int n_items(int B, int L, int W) {
    return B * ((L + T - 1) / T) * ((2 * W + OPS - 1) / OPS);
}

// The scratch arrays; the edge activations (m1, m, cot_u, cot_v, cot_pre)
// in the chain's type Act.
template <class Act>
struct Scratch {
    Act *m1, *mm, *cotu, *cotv, *cotpre;
    float *drel, *vpart, *wpart;
    int* flags;
};

// Floats of scratch for the chain's type Act; with s, also carve `base` into s.
template <class Act>
inline size_t scratch_floats(int B, int L, int hd, int W, int G, int nsplit, Scratch<Act>* s,
                             float* base) {
    const size_t R = (size_t)n_items(B, L, W) * M;
    const size_t act = R * hd * sizeof(Act) / sizeof(float);   // floats of one activation array
    size_t off = 0;
    auto take = [&](size_t n) {
        float* p = base ? base + off : nullptr;
        off += align4(n);
        return p;
    };
    Act** acts[5] = {&s->m1, &s->mm, &s->cotu, &s->cotv, &s->cotpre};
    for (Act** p : acts) *p = reinterpret_cast<Act*>(take(act));
    s->drel = take(R * 3);
    s->flags = reinterpret_cast<int*>(take((size_t)n_items(B, L, W)));
    s->vpart = take((size_t)G * vpart_stride(hd));
    const size_t n_wpart = (size_t)2 * nsplit * hd * hd;
    // cot_pre is consumed before the weight-grad pass
    s->wpart = n_wpart <= act ? reinterpret_cast<float*>(s->cotpre) : take(n_wpart);
    return off;
}

template <int HD, int MODE>
struct BwdSmem {
    using TL = Tile<HD>;
    static constexpr bool CB = Chain<MODE>::BF16;
    static constexpr int A = 0;                                           // [M][AS] of Act
    static constexpr int RING = A + (CB ? M * TL::AS / 2 : M * TL::AS);   // ring
    static constexpr int RED1 = RING + (CB ? RingH<HD, BKH, STAGES>::FLOATS
                                           : Ring<HD, BK, STAGES>::FLOATS);  // [WN][M] wsc partials
    static constexpr int RED2 = RED1 + TL::WN * M;                        // [WN][M] cot_d2 partials
    static constexpr int COLACC = RED2 + TL::WN * M;                      // [WM][NVEC][HD]
    static constexpr int VALID = COLACC + TL::WM * NVEC * HD;             // [M]
    static constexpr int D2 = VALID + M;                                  // [M]
    static constexpr int CW = D2 + M;                                     // [M] cot_wsc
    static constexpr int REL = CW + M;                                    // [M][3]
    static constexpr int J = REL + 3 * M;                                 // [M] (int)
    static constexpr int FLOATS = J + M;
};

// Add the lane's per-column sums v[nt][c] (over its rows) into colacc[q],
// summed first over the 8 lane groups of the warp (fixed shuffle order);
// lanes of group 0 own the warp's columns, so no two lanes add to one word.
template <int HD>
__device__ __forceinline__ void flush_cols(float* colacc, float (&v)[Tile<HD>::NT][2],
                                           const Lane& ln) {
#pragma unroll
    for (int nt = 0; nt < Tile<HD>::NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float s = v[nt][c];
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            if (ln.g == 0) colacc[ln.col0 + nt * 8 + c] += s;
            v[nt][c] = 0.f;
        }
}

// Store the lane's fragments of `acc` to rows [0, M) of an [.., HD] array
// of type Act (in fp32 a warp writes whole 32-byte sectors).
template <int HD, class Act>
__device__ __forceinline__ void store_rows(Act* __restrict__ dst,
                                           const float (&acc)[Tile<HD>::MT][Tile<HD>::NT][4],
                                           const Lane& ln) {
    using TL = Tile<HD>;
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < TL::NT; ++nt)
                store2(dst + (size_t)(ln.row0 + mt * 16 + 8 * h) * HD + ln.col0 + nt * 8,
                       acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

template <int HD, class In, int MODE>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
egnn_bwd_edges(const In* __restrict__ a, const In* __restrict__ bs,
               const float* __restrict__ x, const float* __restrict__ cmask,
               const typename Chain<MODE>::Act* __restrict__ w_d,
               const typename Chain<MODE>::Act* __restrict__ w_e2,
               const typename Chain<MODE>::Act* __restrict__ b_e2,
               const typename Chain<MODE>::Act* __restrict__ w_x1,
               const typename Chain<MODE>::Act* __restrict__ b_x1,
               const typename Chain<MODE>::Act* __restrict__ w_x2,
               const typename Chain<MODE>::Act* __restrict__ b_x2,
               const typename Chain<MODE>::Act* __restrict__ w_e2t,
               const typename Chain<MODE>::Act* __restrict__ w_x1t,
               const float* __restrict__ g_agg, const float* __restrict__ g_delta,
               Scratch<typename Chain<MODE>::Act> s, int L, int W, int items) {
    using TL = Tile<HD>;
    using SM = BwdSmem<HD, MODE>;
    using Act = typename Chain<MODE>::Act;
    constexpr bool CB = Chain<MODE>::BF16;
    constexpr int MT = TL::MT, NT = TL::NT, AS = TL::AS;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    Act* A = reinterpret_cast<Act*>(sm + SM::A);
    Act* ring = reinterpret_cast<Act*>(sm + SM::RING);
    float* red1 = sm + SM::RED1;
    float* red2 = sm + SM::RED2;
    float* row_valid = sm + SM::VALID;
    float* row_d2 = sm + SM::D2;
    float* row_cw = sm + SM::CW;
    float* row_rel = sm + SM::REL;
    int* row_j = reinterpret_cast<int*>(sm + SM::J);
    // acc = A @ w in the mode's products
    auto gemm = [&](const Act* w, float (&acc)[MT][NT][4]) {
        if constexpr (CB) gemm_tile<HD, BKH, STAGES>(w, A, ring, acc, threadIdx.x);
        else gemm_tile<HD, BK, STAGES, MODE, STEP_SUM>(w, A, ring, acc, threadIdx.x);
    };

    const int tid = threadIdx.x;
    const Lane ln = Lane::of<HD>(tid);
    const int warp = tid / 32;
    const int wm = warp / TL::WN, wn = warp % TL::WN;
    const int n_off = 2 * W;
    const int n_steps = (n_off + OPS - 1) / OPS;
    const int n_tiles = (L + T - 1) / T;
    const float bx2 = to_float(b_x2[0]);

    // column sums of the vector grads (w_d, b_e2, b_x1, w_x2), per row-warp
    float* colacc = sm + SM::COLACC + wm * NVEC * HD;
    for (int k = tid; k < TL::WM * NVEC * HD; k += TL::THREADS) sm[SM::COLACC + k] = 0.f;
    float cs[2][NT][2];      // the lane's column sums of one epilogue
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) cs[q][nt][0] = cs[q][nt][1] = 0.f;
    float cw_sum = 0.f;      // tid < M: b_x2 grad
    float acc[MT][NT][4];

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int step = item % n_steps;
        const int i0 = ((item / n_steps) % n_tiles) * T;
        const int b = item / (n_steps * n_tiles);
        const size_t row0 = (size_t)b * L;
        const In* a_b = a + row0 * HD;
        const In* bs_b = bs + row0 * HD;
        const size_t erow = (size_t)item * M;   // the item's first scratch row
        const int my_i = i0 + ln.g;              // the receiver of the lane's rows
        Act* cotu_rows = s.cotu + erow * HD;

        __syncthreads();   // last item's row arrays and reductions are consumed
        float v = 0.f;
        if (tid < M) {
            const int o = tid / T, rr = tid % T;
            const int e = step * OPS + o, i = i0 + rr;
            float d2 = 0.f, cw = 0.f, rel[3] = {0.f, 0.f, 0.f};
            int j = 0;
            if (e < n_off && i < L) {
                j = i + band_offset(e, W);
                if (j >= 0 && j < L && cmask[row0 + i] > 0.5f && cmask[row0 + j] > 0.5f) {
                    v = 1.f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                    d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                    const float* gd = g_delta + (row0 + i) * 3;
                    cw = gd[0] * rel[0] + gd[1] * rel[1] + gd[2] * rel[2];
                }
            }
            row_valid[tid] = v;
            row_d2[tid] = d2;
            row_cw[tid] = cw;
            row_j[tid] = j;
#pragma unroll
            for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
        }
        const int any = __syncthreads_or(v > 0.f);
        if (tid == 0) s.flags[item] = any;
        if (!any) continue;   // no valid edge: the later passes skip the item

        // m1 = silu(pre) into A and to the scratch; rows of invalid edges are
        // 0. Each thread reads 16 bytes of a_i and of bs_j (NV values) at a time.
        constexpr int NV = Vec<In>::N, HDV = HD / NV;
#pragma unroll 4
        for (int idx = tid; idx < M * HDV; idx += TL::THREADS) {
            const int r = idx / HDV, c = NV * (idx % HDV);
            float p[NV];
#pragma unroll
            for (int q = 0; q < NV; ++q) p[q] = 0.f;
            if (row_valid[r] > 0.f) {
                const int i = i0 + r % T;
                float av[NV], bv[NV];
                load_vec(a_b + (size_t)i * HD + c, av);
                load_vec(bs_b + (size_t)row_j[r] * HD + c, bv);
                const float d2 = row_d2[r];
#pragma unroll
                for (int q4 = 0; q4 < NV / 4; ++q4) {
                    const float4 wd = load4(w_d + c + 4 * q4);
                    const float w4[4] = {wd.x, wd.y, wd.z, wd.w};
#pragma unroll
                    for (int q = 4 * q4; q < 4 * q4 + 4; ++q) {
                        if constexpr (CB) p[q] = silu_bf16(pre_bf16(av[q], bv[q], rbf(d2), w4[q % 4]));
                        else p[q] = silu(av[q] + bv[q] + d2 * w4[q % 4]);
                    }
                }
            }
#pragma unroll
            for (int q4 = 0; q4 < NV / 4; ++q4) {
                const float4 pv = make_float4(p[4 * q4], p[4 * q4 + 1], p[4 * q4 + 2], p[4 * q4 + 3]);
                store4(A + r * AS + c + 4 * q4, pv);
                store4(s.m1 + (erow + r) * HD + c + 4 * q4, pv);
            }
        }
        __syncthreads();

        // u = m1 @ W_e2 + b_e2; m = silu(u) -> A and scratch. silu'(u) waits
        // for the cotangent in the item's cot_u rows (each lane rereads and
        // overwrites its own fragments), which keeps shared memory for two
        // blocks per SM.
        gemm(w_e2, acc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const float2 be = load2(b_e2 + ln.col0 + nt * 8);
                    float u0 = acc[mt][nt][2 * h] + be.x, u1 = acc[mt][nt][2 * h + 1] + be.y;
                    if constexpr (CB) {
                        u0 = rbf(rbf(acc[mt][nt][2 * h]) + be.x);
                        u1 = rbf(rbf(acc[mt][nt][2 * h + 1]) + be.y);
                        store2(cotu_rows + (size_t)(ln.row0 + mt * 16 + 8 * h) * HD + ln.col0 + nt * 8,
                               dsilu_bf16(u0), dsilu_bf16(u1));
                        acc[mt][nt][2 * h] = silu_bf16(u0);
                        acc[mt][nt][2 * h + 1] = silu_bf16(u1);
                    } else {
                        store2(cotu_rows + (size_t)(ln.row0 + mt * 16 + 8 * h) * HD + ln.col0 + nt * 8,
                               dsilu(u0), dsilu(u1));
                        acc[mt][nt][2 * h] = silu(u0);
                        acc[mt][nt][2 * h + 1] = silu(u1);
                    }
                }
        store_rows<HD>(s.mm + erow * HD, acc, ln);
        store_tile<HD>(A, acc, ln);
        __syncthreads();

        // v = m @ W_x1 + b_x1; wsc = silu(v) . w_x2 + b_x2 (per row); cot_v.
        gemm(w_x1, acc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = ln.row0 + mt * 16 + 8 * h;
                const float cw = CB ? rbf(row_cw[r]) : row_cw[r];   // cot_wsc
                float sw = 0.f;
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const float2 bx = load2(b_x1 + ln.col0 + nt * 8);
                    const float2 wx = load2(w_x2 + ln.col0 + nt * 8);
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const float wx2 = c ? wx.y : wx.x;
                        float w1, cot_v;
                        if constexpr (CB) {
                            const float vv = rbf(rbf(acc[mt][nt][2 * h + c]) + (c ? bx.y : bx.x));
                            w1 = silu_bf16(vv);
                            cot_v = rbf(rbf(cw * wx2) * dsilu_bf16(vv));
                        } else {
                            const float vv = acc[mt][nt][2 * h + c] + (c ? bx.y : bx.x);
                            w1 = silu(vv);
                            cot_v = cw * wx2 * dsilu(vv);
                        }
                        sw = fmaf(w1, wx2, sw);
                        cs[0][nt][c] += w1 * cw;   // w_x2 grad
                        cs[1][nt][c] += cot_v;     // b_x1 grad
                        acc[mt][nt][2 * h + c] = cot_v;
                    }
                }
                sw = quad_sum(sw);
                if (ln.t == 0) red1[wn * M + r] = sw;
            }
        store_rows<HD>(s.cotv + erow * HD, acc, ln);
        store_tile<HD>(A, acc, ln);
        flush_cols<HD>(colacc + 3 * HD, cs[0], ln);
        flush_cols<HD>(colacc + 2 * HD, cs[1], ln);
        __syncthreads();

        // cot_m = valid * g_agg + cot_v @ W_x1^T; cot_u = cot_m * silu'(u).
        gemm(w_x1t, acc);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            float2 gv = my_i < L
                ? __ldg(reinterpret_cast<const float2*>(g_agg + (row0 + my_i) * HD + ln.col0 + nt * 8))
                : make_float2(0.f, 0.f);
            if constexpr (CB) gv = make_float2(rbf(gv.x), rbf(gv.y));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float valid = row_valid[ln.row0 + mt * 16 + 8 * h];
                    Act* p = cotu_rows + (size_t)(ln.row0 + mt * 16 + 8 * h) * HD + ln.col0 + nt * 8;
                    const float2 ds = ld2(p);
                    float cu0, cu1;
                    if constexpr (CB) {
                        cu0 = rbf(rbf(valid * gv.x + rbf(acc[mt][nt][2 * h])) * ds.x);
                        cu1 = rbf(rbf(valid * gv.y + rbf(acc[mt][nt][2 * h + 1])) * ds.y);
                    } else {
                        cu0 = (valid * gv.x + acc[mt][nt][2 * h]) * ds.x;
                        cu1 = (valid * gv.y + acc[mt][nt][2 * h + 1]) * ds.y;
                    }
                    store2(p, cu0, cu1);
                    cs[0][nt][0] += cu0;   // b_e2 grad
                    cs[0][nt][1] += cu1;
                    acc[mt][nt][2 * h] = cu0;
                    acc[mt][nt][2 * h + 1] = cu1;
                }
        }
        store_tile<HD>(A, acc, ln);
        flush_cols<HD>(colacc + 1 * HD, cs[0], ln);
        __syncthreads();

        // cot_pre = (cot_u @ W_e2^T) * silu'(pre); cot_d2 = cot_pre . w_d (per
        // row; in the bf16 chain an fp32 sum of the bf16 products).
        gemm(w_e2t, acc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = ln.row0 + mt * 16 + 8 * h;
                float sd = 0.f;
                if (row_valid[r] > 0.f) {
                    const float d2 = row_d2[r];
                    const In* a_i = a_b + (size_t)my_i * HD + ln.col0;
                    const In* bs_j = bs_b + (size_t)row_j[r] * HD + ln.col0;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        const float2 av = load2(a_i + nt * 8);
                        const float2 bv = load2(bs_j + nt * 8);
                        const float2 wd = load2(w_d + ln.col0 + nt * 8);
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const float wdc = c ? wd.y : wd.x;
                            float cp;
                            if constexpr (CB) {
                                const float pre = pre_bf16(c ? av.y : av.x, c ? bv.y : bv.x, rbf(d2), wdc);
                                cp = rbf(rbf(acc[mt][nt][2 * h + c]) * dsilu_bf16(pre));
                                sd += rbf(cp * wdc);
                            } else {
                                const float pre = (c ? av.y : av.x) + (c ? bv.y : bv.x) + d2 * wdc;
                                cp = acc[mt][nt][2 * h + c] * dsilu(pre);
                                sd = fmaf(cp, wdc, sd);
                            }
                            acc[mt][nt][2 * h + c] = cp;
                            cs[0][nt][c] += cp * d2;   // w_d grad
                        }
                    }
                } else {
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
                }
                sd = quad_sum(sd);
                if (ln.t == 0) red2[wn * M + r] = sd;
            }
        store_rows<HD>(s.cotpre + erow * HD, acc, ln);
        flush_cols<HD>(colacc + 0 * HD, cs[0], ln);
        __syncthreads();

        // d_rel = valid * wsc * g_delta_i + 2 * rel * cot_d2, per row.
        if (tid < M) {
            const int r = tid;
            float wsc = 0.f, cd2 = 0.f;
#pragma unroll
            for (int q = 0; q < TL::WN; ++q) {
                wsc += red1[q * M + r];
                cd2 += red2[q * M + r];
            }
            const float vw = row_valid[r] * (CB ? rbf(rbf(wsc) + bx2) : wsc + bx2);
            float gd[3] = {0.f, 0.f, 0.f};
            if (row_valid[r] > 0.f) {
#pragma unroll
                for (int c = 0; c < 3; ++c) gd[c] = g_delta[(row0 + i0 + r % T) * 3 + c];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c)
                s.drel[(erow + r) * 3 + c] = vw * gd[c] + 2.f * row_rel[r * 3 + c] * cd2;
            cw_sum += row_cw[r];   // b_x2 grad
        }
    }

    // The block's vector-grad partial: the column sums of the WM row-warps
    // added in warp order, and the b_x2 grad summed over the rows in order.
    __syncthreads();
    float* stage_cw = sm + SM::A;   // [M]
    if (tid < M) stage_cw[tid] = cw_sum;
    __syncthreads();
    float* vp = s.vpart + (size_t)blockIdx.x * vpart_stride(HD);
    for (int k = tid; k < NVEC * HD; k += TL::THREADS) {
        float t = 0.f;
        for (int q = 0; q < TL::WM; ++q) t += sm[SM::COLACC + q * NVEC * HD + k];
        vp[k] = t;
    }
    if (tid == 0) {
        float t = 0.f;
        for (int r = 0; r < M; ++r) t += stage_cw[r];
        vp[NVEC * HD] = t;
    }
}

// The wide edge pass (hd > 512, WIDE_GROUP | hd; egnn_tile.cuh): the same
// items, chain, rounding and scratch rows as egnn_bwd_edges, each product
// run over the hd output columns in groups of WIDE_GROUP with its A operand
// read from the item's own scratch rows (m1, m, cot_v, cot_u: written by
// this block before a barrier), so shared memory holds only the row
// arrays and the per-row sums. The vector-grad column sums go straight to
// the block's partial in device memory (each column owned by one lane per
// group: a fixed order, no atomics); the per-row dot products (wsc,
// cot_d2) are summed over the warps, then over the groups, in order.
template <class In, int MODE>
__global__ void __launch_bounds__(WideTile::THREADS, WideTile::MIN_BLOCKS)
egnn_bwd_edges_wide(const In* __restrict__ a, const In* __restrict__ bs,
                    const float* __restrict__ x, const float* __restrict__ cmask,
                    const typename Chain<MODE>::Act* __restrict__ w_d,
                    const typename Chain<MODE>::Act* __restrict__ w_e2,
                    const typename Chain<MODE>::Act* __restrict__ b_e2,
                    const typename Chain<MODE>::Act* __restrict__ w_x1,
                    const typename Chain<MODE>::Act* __restrict__ b_x1,
                    const typename Chain<MODE>::Act* __restrict__ w_x2,
                    const typename Chain<MODE>::Act* __restrict__ b_x2,
                    const typename Chain<MODE>::Act* __restrict__ w_e2t,
                    const typename Chain<MODE>::Act* __restrict__ w_x1t,
                    const float* __restrict__ g_agg, const float* __restrict__ g_delta,
                    Scratch<typename Chain<MODE>::Act> s, int L, int hd, int W, int items) {
    using TL = WideTile;
    using Act = typename Chain<MODE>::Act;
    constexpr bool CB = Chain<MODE>::BF16;
    constexpr int MT = TL::MT, NT = TL::NT;
    __shared__ float red1[TL::WN * M], red2[TL::WN * M];   // wsc, cot_d2 partials of a group
    __shared__ float sum1[M], sum2[M];                     // the same summed over groups
    __shared__ float row_valid[M], row_d2[M], row_cw[M], row_rel[3 * M];
    __shared__ int row_j[M];
    // products in the mode; the fp32 chain's gradients without STEP_SUM, as egnn_bwd_edges
    auto gemm = [&](const Act* A, const Act* w, int c0, float (&acc)[MT][NT][4], const Lane& ln) {
        if constexpr (CB) gemm_wide(A, hd, w, hd, c0, hd, acc, ln);
        else gemm_wide<MODE, STEP_SUM>(A, hd, w, hd, c0, hd, acc, ln);
    };

    const int tid = threadIdx.x;
    const Lane ln = Lane::of<WIDE_GROUP>(tid);
    const int wn = (tid / 32) % TL::WN;
    const int n_off = 2 * W;
    const int n_steps = (n_off + OPS - 1) / OPS;
    const int n_tiles = (L + T - 1) / T;
    const float bx2 = to_float(b_x2[0]);

    // this block's vector-grad partial (w_d, b_e2, b_x1, w_x2 columns; b_x2)
    float* vp = s.vpart + (size_t)blockIdx.x * vpart_stride(hd);
    for (int k = tid; k < NVEC * hd; k += TL::THREADS) vp[k] = 0.f;
    float cs[2][NT][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) cs[q][nt][0] = cs[q][nt][1] = 0.f;
    float cw_sum = 0.f;      // tid < M: b_x2 grad
    float acc[MT][NT][4];

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int step = item % n_steps;
        const int i0 = ((item / n_steps) % n_tiles) * T;
        const int b = item / (n_steps * n_tiles);
        const size_t row0 = (size_t)b * L;
        const In* a_b = a + row0 * hd;
        const In* bs_b = bs + row0 * hd;
        const size_t erow = (size_t)item * M;
        const int my_i = i0 + ln.g;
        Act* m1_rows = s.m1 + erow * hd;
        Act* mm_rows = s.mm + erow * hd;
        Act* cotu_rows = s.cotu + erow * hd;
        Act* cotv_rows = s.cotv + erow * hd;

        __syncthreads();   // last item's row arrays and sums are consumed
        float v = 0.f;
        if (tid < M) {
            const int o = tid / T, rr = tid % T;
            const int e = step * OPS + o, i = i0 + rr;
            float d2 = 0.f, cw = 0.f, rel[3] = {0.f, 0.f, 0.f};
            int j = 0;
            if (e < n_off && i < L) {
                j = i + band_offset(e, W);
                if (j >= 0 && j < L && cmask[row0 + i] > 0.5f && cmask[row0 + j] > 0.5f) {
                    v = 1.f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                    d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                    const float* gd = g_delta + (row0 + i) * 3;
                    cw = gd[0] * rel[0] + gd[1] * rel[1] + gd[2] * rel[2];
                }
            }
            row_valid[tid] = v;
            row_d2[tid] = d2;
            row_cw[tid] = cw;
            row_j[tid] = j;
            sum1[tid] = sum2[tid] = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
        }
        const int any = __syncthreads_or(v > 0.f);
        if (tid == 0) s.flags[item] = any;
        if (!any) continue;

        // m1 = silu(pre) to the scratch rows; rows of invalid edges are 0
        constexpr int NV = Vec<In>::N;
        const int hdv = hd / NV;
        for (int idx = tid; idx < M * hdv; idx += TL::THREADS) {
            const int r = idx / hdv, c = NV * (idx % hdv);
            float p[NV];
#pragma unroll
            for (int q = 0; q < NV; ++q) p[q] = 0.f;
            if (row_valid[r] > 0.f) {
                float av[NV], bv[NV];
                load_vec(a_b + (size_t)(i0 + r % T) * hd + c, av);
                load_vec(bs_b + (size_t)row_j[r] * hd + c, bv);
                const float d2 = row_d2[r];
#pragma unroll
                for (int q4 = 0; q4 < NV / 4; ++q4) {
                    const float4 wd = load4(w_d + c + 4 * q4);
                    const float w4[4] = {wd.x, wd.y, wd.z, wd.w};
#pragma unroll
                    for (int q = 4 * q4; q < 4 * q4 + 4; ++q) {
                        if constexpr (CB) p[q] = silu_bf16(pre_bf16(av[q], bv[q], rbf(d2), w4[q % 4]));
                        else p[q] = silu(av[q] + bv[q] + d2 * w4[q % 4]);
                    }
                }
            }
#pragma unroll
            for (int q4 = 0; q4 < NV / 4; ++q4)
                store4(m1_rows + (size_t)r * hd + c + 4 * q4,
                       make_float4(p[4 * q4], p[4 * q4 + 1], p[4 * q4 + 2], p[4 * q4 + 3]));
        }
        __syncthreads();

        // u = m1 @ W_e2 + b_e2: silu'(u) waits in the cot_u rows, m = silu(u)
        for (int c0 = 0; c0 < hd; c0 += WIDE_GROUP) {
            gemm(m1_rows, w_e2, c0, acc, ln);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        const int col = c0 + ln.col0 + nt * 8;
                        const float2 be = load2(b_e2 + col);
                        Act* du = cotu_rows + (size_t)(ln.row0 + mt * 16 + 8 * h) * hd + col;
                        if constexpr (CB) {
                            const float u0 = rbf(rbf(acc[mt][nt][2 * h]) + be.x);
                            const float u1 = rbf(rbf(acc[mt][nt][2 * h + 1]) + be.y);
                            store2(du, dsilu_bf16(u0), dsilu_bf16(u1));
                            acc[mt][nt][2 * h] = silu_bf16(u0);
                            acc[mt][nt][2 * h + 1] = silu_bf16(u1);
                        } else {
                            const float u0 = acc[mt][nt][2 * h] + be.x;
                            const float u1 = acc[mt][nt][2 * h + 1] + be.y;
                            store2(du, dsilu(u0), dsilu(u1));
                            acc[mt][nt][2 * h] = silu(u0);
                            acc[mt][nt][2 * h + 1] = silu(u1);
                        }
                    }
            store_rows_wide(mm_rows, hd, c0, acc, ln);
        }
        __syncthreads();   // m complete

        // v = m @ W_x1 + b_x1; wsc = silu(v) . w_x2 + b_x2 (per row); cot_v
        for (int c0 = 0; c0 < hd; c0 += WIDE_GROUP) {
            gemm(mm_rows, w_x1, c0, acc, ln);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = ln.row0 + mt * 16 + 8 * h;
                    const float cw = CB ? rbf(row_cw[r]) : row_cw[r];   // cot_wsc
                    float sw = 0.f;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        const float2 bx = load2(b_x1 + c0 + ln.col0 + nt * 8);
                        const float2 wx = load2(w_x2 + c0 + ln.col0 + nt * 8);
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const float wx2 = c ? wx.y : wx.x;
                            float w1, cot_v;
                            if constexpr (CB) {
                                const float vv = rbf(rbf(acc[mt][nt][2 * h + c]) + (c ? bx.y : bx.x));
                                w1 = silu_bf16(vv);
                                cot_v = rbf(rbf(cw * wx2) * dsilu_bf16(vv));
                            } else {
                                const float vv = acc[mt][nt][2 * h + c] + (c ? bx.y : bx.x);
                                w1 = silu(vv);
                                cot_v = cw * wx2 * dsilu(vv);
                            }
                            sw = fmaf(w1, wx2, sw);
                            cs[0][nt][c] += w1 * cw;   // w_x2 grad
                            cs[1][nt][c] += cot_v;     // b_x1 grad
                            acc[mt][nt][2 * h + c] = cot_v;
                        }
                    }
                    sw = quad_sum(sw);
                    if (ln.t == 0) red1[wn * M + r] = sw;
                }
            store_rows_wide(cotv_rows, hd, c0, acc, ln);
            flush_cols<WIDE_GROUP>(vp + 3 * hd + c0, cs[0], ln);
            flush_cols<WIDE_GROUP>(vp + 2 * hd + c0, cs[1], ln);
            __syncthreads();
            if (tid < M) {
                float t = 0.f;
#pragma unroll
                for (int q = 0; q < TL::WN; ++q) t += red1[q * M + tid];
                sum1[tid] += t;
            }
            __syncthreads();   // red1 consumed; after the last group, cot_v complete
        }

        // cot_m = valid * g_agg + cot_v @ W_x1^T; cot_u = cot_m * silu'(u)
        for (int c0 = 0; c0 < hd; c0 += WIDE_GROUP) {
            gemm(cotv_rows, w_x1t, c0, acc, ln);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int col = c0 + ln.col0 + nt * 8;
                float2 gv = my_i < L
                    ? __ldg(reinterpret_cast<const float2*>(g_agg + (row0 + my_i) * hd + col))
                    : make_float2(0.f, 0.f);
                if constexpr (CB) gv = make_float2(rbf(gv.x), rbf(gv.y));
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float valid = row_valid[ln.row0 + mt * 16 + 8 * h];
                        Act* p = cotu_rows + (size_t)(ln.row0 + mt * 16 + 8 * h) * hd + col;
                        const float2 ds = ld2(p);
                        float cu0, cu1;
                        if constexpr (CB) {
                            cu0 = rbf(rbf(valid * gv.x + rbf(acc[mt][nt][2 * h])) * ds.x);
                            cu1 = rbf(rbf(valid * gv.y + rbf(acc[mt][nt][2 * h + 1])) * ds.y);
                        } else {
                            cu0 = (valid * gv.x + acc[mt][nt][2 * h]) * ds.x;
                            cu1 = (valid * gv.y + acc[mt][nt][2 * h + 1]) * ds.y;
                        }
                        store2(p, cu0, cu1);
                        cs[0][nt][0] += cu0;   // b_e2 grad
                        cs[0][nt][1] += cu1;
                    }
            }
            flush_cols<WIDE_GROUP>(vp + 1 * hd + c0, cs[0], ln);
        }
        __syncthreads();   // cot_u complete

        // cot_pre = (cot_u @ W_e2^T) * silu'(pre); cot_d2 = cot_pre . w_d (per row)
        for (int c0 = 0; c0 < hd; c0 += WIDE_GROUP) {
            gemm(cotu_rows, w_e2t, c0, acc, ln);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = ln.row0 + mt * 16 + 8 * h;
                    float sd = 0.f;
                    if (row_valid[r] > 0.f) {
                        const float d2 = row_d2[r];
                        const In* a_i = a_b + (size_t)my_i * hd + c0 + ln.col0;
                        const In* bs_j = bs_b + (size_t)row_j[r] * hd + c0 + ln.col0;
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt) {
                            const float2 av = load2(a_i + nt * 8);
                            const float2 bv = load2(bs_j + nt * 8);
                            const float2 wd = load2(w_d + c0 + ln.col0 + nt * 8);
#pragma unroll
                            for (int c = 0; c < 2; ++c) {
                                const float wdc = c ? wd.y : wd.x;
                                float cp;
                                if constexpr (CB) {
                                    const float pre = pre_bf16(c ? av.y : av.x, c ? bv.y : bv.x, rbf(d2), wdc);
                                    cp = rbf(rbf(acc[mt][nt][2 * h + c]) * dsilu_bf16(pre));
                                    sd += rbf(cp * wdc);
                                } else {
                                    const float pre = (c ? av.y : av.x) + (c ? bv.y : bv.x) + d2 * wdc;
                                    cp = acc[mt][nt][2 * h + c] * dsilu(pre);
                                    sd = fmaf(cp, wdc, sd);
                                }
                                acc[mt][nt][2 * h + c] = cp;
                                cs[0][nt][c] += cp * d2;   // w_d grad
                            }
                        }
                    } else {
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt) acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
                    }
                    sd = quad_sum(sd);
                    if (ln.t == 0) red2[wn * M + r] = sd;
                }
            store_rows_wide(s.cotpre + erow * hd, hd, c0, acc, ln);
            flush_cols<WIDE_GROUP>(vp + 0 * hd + c0, cs[0], ln);
            __syncthreads();
            if (tid < M) {
                float t = 0.f;
#pragma unroll
                for (int q = 0; q < TL::WN; ++q) t += red2[q * M + tid];
                sum2[tid] += t;
            }
            __syncthreads();   // red2 consumed
        }

        // d_rel = valid * wsc * g_delta_i + 2 * rel * cot_d2, per row
        if (tid < M) {
            const int r = tid;
            const float vw = row_valid[r] * (CB ? rbf(rbf(sum1[r]) + bx2) : sum1[r] + bx2);
            float gd[3] = {0.f, 0.f, 0.f};
            if (row_valid[r] > 0.f) {
#pragma unroll
                for (int c = 0; c < 3; ++c) gd[c] = g_delta[(row0 + i0 + r % T) * 3 + c];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c)
                s.drel[(erow + r) * 3 + c] = vw * gd[c] + 2.f * row_rel[r * 3 + c] * sum2[r];
            cw_sum += row_cw[r];   // b_x2 grad
        }
    }

    // the b_x2 grad summed over the rows in order
    __syncthreads();
    if (tid < M) sum1[tid] = cw_sum;
    __syncthreads();
    if (tid == 0) {
        float t = 0.f;
        for (int r = 0; r < M; ++r) t += sum1[r];
        vp[NVEC * hd] = t;
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

// Split-K weight grads on the tensor cores (PASSES TF32 passes; SUM: each
// k8 step summed in round-to-nearest fp32, as STEP_SUM in egnn_tile.cuh):
// part[z][sl] = X_z[rows of slice sl]^T @ Y_z[same rows], z = 0: (m1, cot_u)
// -> dW_e2, z = 1: (m, cot_v) -> dW_x1. One block per TW x TW output tile
// and slice; 8 warps as 2 x 4, each (TW/2) x (TW/4). The slice's valid
// items (in order) stream through a cp.async ring of KC-row chunks of both
// operands, stored [k][TW + 8] (conflict-free fragment loads).
template <int TW>
struct Wgrad {
    static constexpr int KC = 16, STG = 3, XS = TW + 8;
    static constexpr int MT = TW / 32, NT = TW / 32;
    static constexpr int STAGE = 2 * KC * XS;   // X chunk, then Y chunk
    static constexpr size_t smem(int per) { return sizeof(float) * STG * STAGE + sizeof(int) * per; }
};

template <int TW, int PASSES, bool SUM>
__global__ void __launch_bounds__(THREADS)
egnn_bwd_wgrad(const float* __restrict__ x0, const float* __restrict__ y0,
               const float* __restrict__ x1, const float* __restrict__ y1,
               const int* __restrict__ flags, float* __restrict__ part, int items, int hd,
               int nsplit) {
    using C = Wgrad<TW>;
    constexpr int CPI = M / C::KC;   // chunks per item
    extern __shared__ float4 smem4[];
    float* stages = reinterpret_cast<float*>(smem4);
    int* list = reinterpret_cast<int*>(stages + C::STG * C::STAGE);
    const int tiles_n = hd / TW;
    const int m0 = (blockIdx.x / tiles_n) * TW, n0 = (blockIdx.x % tiles_n) * TW;
    const int sl = blockIdx.y, z = blockIdx.z;
    const float* X = z ? x1 : x0;
    const float* Y = z ? y1 : y0;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int nchunk = valid_items(flags, items, nsplit, sl, list) * CPI;
    auto load = [&](int q, int slot) {
        const size_t r0 = (size_t)list[q / CPI] * M + (q % CPI) * C::KC;
        float* xs = stages + slot * C::STAGE;
        float* ys = xs + C::KC * C::XS;
        for (int v = tid; v < C::KC * TW / 4; v += THREADS) {
            const int kk = v / (TW / 4), c4 = v % (TW / 4);
            cp_async16(xs + kk * C::XS + 4 * c4, X + (r0 + kk) * hd + m0 + 4 * c4);
            cp_async16(ys + kk * C::XS + 4 * c4, Y + (r0 + kk) * hd + n0 + 4 * c4);
        }
    };

    float acc[C::MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    const int am = (warp / 4) * (TW / 2) + g;   // the lane's output row in the tile
    const int bn = (warp % 4) * (TW / 4) + g;   // the lane's B column in the tile

#pragma unroll
    for (int s = 0; s < C::STG - 1; ++s) {
        if (s < nchunk) load(s, s);
        cp_async_commit();
    }
    for (int q = 0; q < nchunk; ++q) {
        cp_async_wait<C::STG - 2>();
        __syncthreads();
        const int nq = q + C::STG - 1;
        if (nq < nchunk) load(nq, nq % C::STG);
        cp_async_commit();
        const float* xs = stages + (q % C::STG) * C::STAGE;
        const float* ys = xs + C::KC * C::XS;
#pragma unroll
        for (int k8 = 0; k8 < C::KC; k8 += 8) {
            const float* xp = xs + (k8 + t) * C::XS + am;
            const float* yp = ys + (k8 + t) * C::XS + bn;
            mma_k8<C::MT, C::NT, PASSES, SUM>(
                acc,
                [&](int mt, float2& lo, float2& hi) {
                    lo = make_float2(xp[mt * 16], xp[4 * C::XS + mt * 16]);
                    hi = make_float2(xp[mt * 16 + 8], xp[4 * C::XS + mt * 16 + 8]);
                },
                [&](int nt, float& b0, float& b1) {
                    b0 = yp[nt * 8];
                    b1 = yp[4 * C::XS + nt * 8];
                });
        }
    }
    cp_async_wait<0>();

    float* out = part + ((size_t)z * nsplit + sl) * hd * hd;
    const int orow = m0 + am, ocol = n0 + (warp % 4) * (TW / 4) + 2 * t;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < C::NT; ++nt)
                *reinterpret_cast<float2*>(out + (size_t)(orow + mt * 16 + 8 * h) * hd + ocol + nt * 8) =
                    make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// The bf16 chain's weight grads: the same split-K products and tiles as
// egnn_bwd_wgrad, on the bf16 activations with m16n8k16 bf16 products
// (fp32 sums). X^T's fragments come by ldmatrix.x4.trans and Y's by
// ldmatrix.x2.trans from KC-row chunks stored [k][TW + 8] (rows of 16 mod
// 128 bytes: conflict-free).
template <int TW>
struct WgradH {
    static constexpr int KC = 32, STG = 3, XS = TW + 8;
    static constexpr int MT = TW / 32, NT = TW / 32;
    static constexpr int STAGE = 2 * KC * XS;   // X chunk, then Y chunk (bf16 values)
    static constexpr size_t smem(int per) {
        return sizeof(__nv_bfloat16) * STG * STAGE + sizeof(int) * per;
    }
};

template <int TW>
__global__ void __launch_bounds__(THREADS)
egnn_bwd_wgrad_bf16(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ y0,
                    const __nv_bfloat16* __restrict__ x1, const __nv_bfloat16* __restrict__ y1,
                    const int* __restrict__ flags, float* __restrict__ part, int items, int hd,
                    int nsplit) {
    using C = WgradH<TW>;
    constexpr int CPI = M / C::KC;   // chunks per item
    extern __shared__ float4 smem4[];
    __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem4);
    int* list = reinterpret_cast<int*>(stages + C::STG * C::STAGE);
    const int tiles_n = hd / TW;
    const int m0 = (blockIdx.x / tiles_n) * TW, n0 = (blockIdx.x % tiles_n) * TW;
    const int sl = blockIdx.y, z = blockIdx.z;
    const __nv_bfloat16* X = z ? x1 : x0;
    const __nv_bfloat16* Y = z ? y1 : y0;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4, q = lane >> 3, i = lane & 7;
    const int nchunk = valid_items(flags, items, nsplit, sl, list) * CPI;
    auto load = [&](int qc, int slot) {
        const size_t r0 = (size_t)list[qc / CPI] * M + (qc % CPI) * C::KC;
        __nv_bfloat16* xs = stages + slot * C::STAGE;
        __nv_bfloat16* ys = xs + C::KC * C::XS;
        for (int v = tid; v < C::KC * TW / 8; v += THREADS) {
            const int kk = v / (TW / 8), c8 = v % (TW / 8);
            cp_async16(xs + kk * C::XS + 8 * c8, X + (r0 + kk) * hd + m0 + 8 * c8);
            cp_async16(ys + kk * C::XS + 8 * c8, Y + (r0 + kk) * hd + n0 + 8 * c8);
        }
    };

    float acc[C::MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
    const int wm0 = (warp / 4) * (TW / 2), wn0 = (warp % 4) * (TW / 4);
    // ldmatrix rows: X^T.x4.trans matrix q = (k +8 (q >> 1), m +8 (q & 1));
    // Y.x2.trans matrix q = (k +8 (q & 1)) at the warp's first column
    const int a_ld = (i + (q >> 1) * 8) * C::XS + wm0 + (q & 1) * 8;
    const int b_ld = (i + (q & 1) * 8) * C::XS + wn0;

#pragma unroll
    for (int st = 0; st < C::STG - 1; ++st) {
        if (st < nchunk) load(st, st);
        cp_async_commit();
    }
    for (int qc = 0; qc < nchunk; ++qc) {
        cp_async_wait<C::STG - 2>();
        __syncthreads();
        const int nq = qc + C::STG - 1;
        if (nq < nchunk) load(nq, nq % C::STG);
        cp_async_commit();
        const __nv_bfloat16* xs = stages + (qc % C::STG) * C::STAGE;
        const __nv_bfloat16* ys = xs + C::KC * C::XS;
#pragma unroll
        for (int k16 = 0; k16 < C::KC; k16 += 16) {
            uint32_t bf[C::NT][2];
#pragma unroll
            for (int nt = 0; nt < C::NT; ++nt) ldsm_x2_trans(bf[nt], ys + b_ld + k16 * C::XS + nt * 8);
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt) {
                uint32_t af[4];
                ldsm_x4_trans(af, xs + a_ld + k16 * C::XS + mt * 16);
#pragma unroll
                for (int nt = 0; nt < C::NT; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
            }
        }
    }
    cp_async_wait<0>();

    float* out = part + ((size_t)z * nsplit + sl) * hd * hd;
    const int orow = m0 + wm0 + g, ocol = n0 + wn0 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < C::NT; ++nt)
                *reinterpret_cast<float2*>(out + (size_t)(orow + mt * 16 + 8 * h) * hd + ocol + nt * 8) =
                    make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
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

// Passes 2-4 (nodes, weight grads, reduce) after an edge pass, at width hd
// (TW: the weight-grad tile edge; SUM: its per-k8-step sums).
template <class In, int MODE, int TW, bool SUM>
cudaError_t launch_tail(const Scratch<typename Chain<MODE>::Act>& s, In* da, In* dbs, float* dx,
                        float* dw_e2, float* dw_x1, float* dvec, int B, int L, int hd, int W,
                        int G, int nsplit, cudaStream_t stream) {
    using Act = typename Chain<MODE>::Act;
    const int items = n_items(B, L, W);
    cudaError_t err;
    egnn_bwd_nodes<In, Act><<<dim3(L, B), THREADS, 2 * 2 * W * sizeof(int), stream>>>(
        s.cotpre, s.drel, s.flags, da, dbs, dx, L, hd, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int per = (items + nsplit - 1) / nsplit;
    const dim3 wgrid((hd / TW) * (hd / TW), nsplit, 2);
    if constexpr (Chain<MODE>::BF16) {
        const size_t wsmem = WgradH<TW>::smem(per);
        auto wgrad = egnn_bwd_wgrad_bf16<TW>;
        err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
        if (err != cudaSuccess) return err;
        wgrad<<<wgrid, THREADS, wsmem, stream>>>(s.m1, s.cotu, s.mm, s.cotv, s.flags, s.wpart,
                                                 items, hd, nsplit);
    } else {
        const size_t wsmem = Wgrad<TW>::smem(per);
        auto wgrad = egnn_bwd_wgrad<TW, MODE, SUM>;
        err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
        if (err != cudaSuccess) return err;
        wgrad<<<wgrid, THREADS, wsmem, stream>>>(s.m1, s.cotu, s.mm, s.cotv, s.flags, s.wpart,
                                                 items, hd, nsplit);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t n_out = 2 * (size_t)hd * hd + NVEC * hd + 1;
    egnn_bwd_reduce<<<(unsigned)((n_out + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        s.wpart, s.vpart, dw_e2, dw_x1, dvec, hd, G, nsplit);
    return cudaGetLastError();
}

template <int HD, class In, int MODE>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const void* const* wts, const float* g_agg, const float* g_delta, In* da,
                   In* dbs, float* dx, float* dw_e2, float* dw_x1, float* dvec, float* scratch,
                   int B, int L, int W, int G, int nsplit, cudaStream_t stream) {
    using Act = typename Chain<MODE>::Act;
    if (G < 1 || nsplit < 1) return cudaErrorInvalidValue;
    Scratch<Act> s;
    scratch_floats(B, L, HD, W, G, nsplit, &s, scratch);
    const int items = n_items(B, L, W);
    const Act* w[9];
    for (int k = 0; k < 9; ++k) w[k] = static_cast<const Act*>(wts[k]);
    constexpr size_t smem = sizeof(float) * BwdSmem<HD, MODE>::FLOATS;
    auto edges = egnn_bwd_edges<HD, In, MODE>;
    cudaError_t err = cudaFuncSetAttribute(edges, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    edges<<<G, Tile<HD>::THREADS, smem, stream>>>(
        a, bs, x, cmask, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], g_agg, g_delta,
        s, L, W, items);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return launch_tail<In, MODE, (HD < 128 ? HD : 128), WGRAD_STEP_SUM<HD>>(
        s, da, dbs, dx, dw_e2, dw_x1, dvec, B, L, HD, W, G, nsplit, stream);
}

// The wide variant (hd > 512, WIDE_GROUP | hd): egnn_bwd_edges_wide, then
// the same passes 2-4 (128-wide weight-grad tiles, each k8 step summed as
// at Hd 512: one slice sums every item's rows).
template <class In, int MODE>
cudaError_t launch_wide(const In* a, const In* bs, const float* x, const float* cmask,
                        const void* const* wts, const float* g_agg, const float* g_delta, In* da,
                        In* dbs, float* dx, float* dw_e2, float* dw_x1, float* dvec,
                        float* scratch, int B, int L, int hd, int W, int G, int nsplit,
                        cudaStream_t stream) {
    using Act = typename Chain<MODE>::Act;
    if (!wide_width(hd) || G < 1 || nsplit < 1) return cudaErrorInvalidValue;
    Scratch<Act> s;
    scratch_floats(B, L, hd, W, G, nsplit, &s, scratch);
    const int items = n_items(B, L, W);
    const Act* w[9];
    for (int k = 0; k < 9; ++k) w[k] = static_cast<const Act*>(wts[k]);
    egnn_bwd_edges_wide<In, MODE><<<G, WideTile::THREADS, 0, stream>>>(
        a, bs, x, cmask, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], g_agg, g_delta,
        s, L, hd, W, items);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_tail<In, MODE, 128, true>(s, da, dbs, dx, dw_e2, dw_x1, dvec, B, L, hd, W, G,
                                            nsplit, stream);
}

}  // namespace

extern "C" {

// Floats of scratch one call needs (the caller allocates it), for a grid of
// G edge-pass blocks and nsplit weight-grad slices: the edge activations
// are bf16 in the bf16 chain (chain_bf16), fp32 otherwise.
size_t egnn_band_bwd_scratch_floats(int B, int L, int hd, int W, int G, int nsplit,
                                    int chain_bf16) {
    if (chain_bf16) {
        Scratch<__nv_bfloat16> s;
        return scratch_floats(B, L, hd, W, G, nsplit, &s, nullptr);
    }
    Scratch<float> s;
    return scratch_floats(B, L, hd, W, G, nsplit, &s, nullptr);
}

// Edge-pass blocks of the mode (bf16_in, passes, chain_bf16) at width hd
// that one SM holds at once (its persistent grid's slots per SM), or a
// negative CUDA error code.
int egnn_band_bwd_blocks_per_sm(int hd, int bf16_in, int passes, int chain_bf16) {
    int n = 0;
    if (hd > 512) {   // the wide variant
        if (!wide_width(hd)) return -static_cast<int>(cudaErrorInvalidValue);
        const cudaError_t err = dispatch_mode(bf16_in, passes, chain_bf16, [&](auto in_c, auto m_c) {
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, egnn_bwd_edges_wide<typename decltype(in_c)::type, decltype(m_c)::value>,
                WideTile::THREADS, 0);
        });
        return err == cudaSuccess ? n : -static_cast<int>(err);
    }
    const cudaError_t err = dispatch(hd, bf16_in, passes, chain_bf16,
                                     [&](auto hd_c, auto in_c, auto m_c) {
        constexpr int HD = decltype(hd_c)::value, MODE = decltype(m_c)::value;
        constexpr size_t smem = sizeof(float) * BwdSmem<HD, MODE>::FLOATS;
        auto edges = egnn_bwd_edges<HD, typename decltype(in_c)::type, MODE>;
        cudaError_t e = cudaFuncSetAttribute(edges, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, edges, Tile<HD>::THREADS,
                                                             smem);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch the four passes on `stream`; returns the CUDA error code (0 = success).
// Device pointers to contiguous arrays, 16-byte aligned: a, bs [B, L, hd] and
// da, dbs [B, L, hd] in bf16 when bf16_in, else fp32; the weights w_d, b_e2,
// b_x1, w_x2 [hd], w_e2, w_x1 and their transposes w_e2t, w_x1t [hd, hd],
// b_x2 [1] in bf16 when chain_bf16, else fp32; the rest fp32: g_agg
// [B, L, hd]; x, g_delta [B, L, 3]; cmask [B, L]; dx [B, L, 3]; dw_e2,
// dw_x1 [hd, hd] (in, out); dvec [4 hd + 1] = (dw_d, db_e2, db_x1, dw_x2,
// db_x2); scratch as sized above. passes: TF32 passes per product of the
// fp32 chain (3 or 1; either with the bf16 chain). G: blocks of the
// persistent edge pass; nsplit: slices of the weight grads.
int egnn_band_bwd_launch(const void* a, const void* bs, const float* x, const float* cmask,
                         const void* w_d, const void* w_e2, const void* b_e2, const void* w_x1,
                         const void* b_x1, const void* w_x2, const void* b_x2,
                         const void* w_e2t, const void* w_x1t, const float* g_agg,
                         const float* g_delta, void* da, void* dbs, float* dx, float* dw_e2,
                         float* dw_x1, float* dvec, float* scratch, int B, int L, int hd, int W,
                         int G, int nsplit, int bf16_in, int passes, int chain_bf16,
                         void* stream) {
    const void* wts[9] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, w_e2t, w_x1t};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (hd > 512)   // the wide variant
        return dispatch_mode(bf16_in, passes, chain_bf16, [&](auto in_c, auto m_c) {
            using In = typename decltype(in_c)::type;
            return launch_wide<In, decltype(m_c)::value>(
                static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, wts, g_agg,
                g_delta, static_cast<In*>(da), static_cast<In*>(dbs), dx, dw_e2, dw_x1, dvec,
                scratch, B, L, hd, W, G, nsplit, s);
        });
    return dispatch(hd, bf16_in, passes, chain_bf16, [&](auto hd_c, auto in_c, auto m_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(hd_c)::value, In, decltype(m_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, wts, g_agg,
            g_delta, static_cast<In*>(da), static_cast<In*>(dbs), dx, dw_e2, dw_x1, dvec,
            scratch, B, L, W, G, nsplit, s);
    });
}

const char* egnn_band_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
