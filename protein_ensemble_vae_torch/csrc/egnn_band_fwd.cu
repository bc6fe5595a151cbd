// EGNN band forward: fused message passing of one banded EGNN layer, fp32
// or bf16 inputs a / bs, fp32 or bf16 edge chain.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/egnn_band.py (entered through `egnn_band_fused`). For receiver i
// and band offset d = j - i in [-W, W] \ {0}:
//     pre  = a_i + bs_j + |x_i - x_j|^2 * w_d
//     m    = silu(silu(pre) @ W_e2 + b_e2)
//     agg_i       = sum_d valid * m
//     raw_delta_i = sum_d valid * (silu(m @ W_x1 + b_x1) . w_x2 + b_x2) * (x_i - x_j)
// valid = 0 <= j < L and cmask_i > 0.5 and cmask_j > 0.5. Nothing of size
// K = 2W+1 reaches device memory.
//
// Modes (template arguments; egnn_tile.cuh): the input type In of a / bs,
// fp32 or, from a bf16 model, bf16 (read as bf16 and widened in registers:
// half the bytes), and MODE: the TF32 passes per product of the fp32 chain,
// the JAX side's `precision` (3 for Precision.HIGHEST, an fp32 model; 1 for
// precision=None, a bf16 model), or CHAIN_BF16, its
// chain_dtype=bfloat16: the chain in bf16, rounded where the JAX kernel
// rounds it (d2 and the products rounded to bf16, every elementwise op in
// bf16), bf16 weights (the caller casts them once per call), bf16
// tensor-core products; the agg and raw_delta sums and d2 stay fp32. The
// outputs are fp32 in every mode.
//
// What bounds it: operations. Per edge the two Hd x Hd products cost
// 4*Hd^2 FLOP (262,144 at Hd=256) against ~2*Hd*4 bytes of fresh input, far
// above the card's ridge. The products run on the tensor cores. In 3xTF32
// they reach fp32 accuracy the way the JAX side's Precision.HIGHEST does
// through multi-pass products on the TPU, with each k8 step summed in
// round-to-nearest fp32 (STEP_SUM): without it the tensor cores'
// round-toward-zero accumulation left errors of ~1e-6 of the output that a
// whole model summed coherently. In one pass the operands' TF32 rounding
// (~1e-3 relative) is three orders above that drift, so STEP_SUM is off.
// The rest of the chain is fp32 FMA. The tensor-core floor is PASSES x the
// FLOP at the TF32 rate; what holds the kernel well above it is the latency
// of mma.sync's register-fed chains at 16 warps per SM and, in one pass,
// the fp32 elementwise chain, which does not shrink (see PERF.md). In the
// bf16 chain the floor is the FLOP at the bf16 rate, twice TF32's; its
// elementwise chain costs more instructions than the fp32 one (a rounding
// after every op), the A tile and the ring chunks half the bytes.
//
// Design:
// - A block owns (batch row, tile of T = 8 receivers, slice of the band
//   offsets) and walks its slice OPS = 8 offsets at a time: one step is a
//   64-row edge tile, row r = (offset slot r / 8, receiver r % 8), so each
//   lane's accumulator rows belong to one receiver and `agg` sums in the
//   lane's registers across the steps with no cross-thread reduction.
// - Filling the card: one block per (batch row, tile) gives 32 blocks at
//   B1/L256 and 320 (1.2 waves of the 264 resident blocks) at B10/L256.
//   The caller splits the 2W offsets into S slices so that the grid spans
//   several waves (ops/kernels/egnn_band.py: fwd_slices); with S > 1 each
//   block writes its partial agg / raw_delta and a second kernel of the
//   same call sums the S partials in slice order (bitwise reproducible).
// - A step with no valid edge (the receiver tile or its whole sender window
//   masked, e.g. the padding of a length bucket) is skipped: it would add
//   exact zeros.
// - Shared memory: W_e2 and W_x1 (512 KB at Hd = 256) cannot stay resident,
//   so each streams through a 4-stage cp.async ring of 8-row chunks (33 KB)
//   once per product per step; with the 66 KB activation tile a block needs
//   ~102 KB, and two blocks share an SM (launch bounds cap the registers
//   at 128 per thread, with a few hundred bytes of spills). The bf16 chain
//   streams 16-row bf16 chunks (the same 8 KB each, 34 KB of ring) beside a
//   34 KB bf16 tile: ~70 KB.
// - Hd = 512 (egnn_tile.cuh: Tile<512>): a 512-thread block, one per SM,
//   each warp with Hd 256's fragments (the same registers per thread); the
//   133 KB fp32 tile and a 66 KB ring take ~200 KB of the SM's 227 KB, the
//   bf16 chain's 66 KB tile and 66 KB ring ~139 KB. The launch plan reads
//   the resident blocks from the occupancy query (fwd_plan).
// - Per-row reductions (the w_x2 dot product) sum each lane's columns, then
//   the four lanes of a quad with shuffles, then the warps that own the
//   row's other columns through shared memory, always in the same order.
// The fp32 chain at the native widths runs on wgmma instead: the one-pass
// mode at widths 32 to 256 in egnn_band_fwd_sm90.cu, 3xTF32 at 32 to 256
// and both modes at Hd 512 in egnn_band_fwd_sm90_hd512.cu; this file no
// longer builds them (Tile<HD> runs the bf16 chain only). The bf16 chain
// too runs on wgmma at every width (egnn_band_fwd_sm90*.cu), so no mode
// launches this file's kernels: they remain as the baseline the A/B scripts
// time (scripts/band_kernels_ab.py).

#include "egnn_passes.cuh"

namespace {

using namespace egnn;

constexpr int BK = 8;        // weight rows per ring chunk (fp32 chain)
constexpr int BKH = 16;      // weight rows per ring chunk (bf16 chain)
constexpr int STAGES = 4;    // ring depth

template <int HD, int MODE>
struct FwdSmem {
    using TL = Tile<HD>;
    static constexpr bool CB = Chain<MODE>::BF16;
    static constexpr int A = 0;                                          // [M][AS] of Act
    static constexpr int RING = A + (CB ? M * TL::AS / 2 : M * TL::AS);  // ring
    static constexpr int RED = RING + (CB ? RingH<HD, BKH, STAGES>::FLOATS
                                          : Ring<HD, BK, STAGES>::FLOATS);  // [WN][M]
    static constexpr int VALID = RED + TL::WN * M;                       // [M]
    static constexpr int D2 = VALID + M;                                 // [M]
    static constexpr int REL = D2 + M;                                   // [M][3]
    static constexpr int J = REL + 3 * M;                                // [M] (int)
    static constexpr int FLOATS = J + M;
};

template <int HD, class In, int MODE>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
egnn_band_fwd_kernel(const In* __restrict__ a, const In* __restrict__ bs,
                     const float* __restrict__ x, const float* __restrict__ cmask,
                     const typename Chain<MODE>::Act* __restrict__ w_d,
                     const typename Chain<MODE>::Act* __restrict__ w_e2,
                     const typename Chain<MODE>::Act* __restrict__ b_e2,
                     const typename Chain<MODE>::Act* __restrict__ w_x1,
                     const typename Chain<MODE>::Act* __restrict__ b_x1,
                     const typename Chain<MODE>::Act* __restrict__ w_x2,
                     const typename Chain<MODE>::Act* __restrict__ b_x2, float* __restrict__ agg,
                     float* __restrict__ delta, int L, int W, int steps_per_slice) {
    using TL = Tile<HD>;
    using SM = FwdSmem<HD, MODE>;
    using Act = typename Chain<MODE>::Act;
    constexpr bool CB = Chain<MODE>::BF16;
    constexpr int MT = TL::MT, NT = TL::NT, AS = TL::AS;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    Act* A = reinterpret_cast<Act*>(sm + SM::A);
    Act* ring = reinterpret_cast<Act*>(sm + SM::RING);
    float* red = sm + SM::RED;
    float* row_valid = sm + SM::VALID;
    float* row_d2 = sm + SM::D2;
    float* row_rel = sm + SM::REL;
    int* row_j = reinterpret_cast<int*>(sm + SM::J);
    // acc = A @ w in the mode's products; 3xTF32 sums each k8 step in
    // round-to-nearest fp32 (STEP_SUM, egnn_tile.cuh)
    auto gemm = [&](const Act* w, float (&acc)[MT][NT][4]) {
        if constexpr (CB) gemm_tile<HD, BKH, STAGES>(w, A, ring, acc, threadIdx.x);
        else gemm_tile<HD, BK, STAGES, MODE, MODE == 3>(w, A, ring, acc, threadIdx.x);
    };

    const int B = gridDim.y;
    const int b = blockIdx.y;
    const int i0 = blockIdx.x * T;
    const int tid = threadIdx.x;
    const Lane ln = Lane::of<HD>(tid);
    const int wn = (tid / 32) % TL::WN;
    const size_t row0 = (size_t)b * L;
    const In* a_b = a + row0 * HD;
    const In* bs_b = bs + row0 * HD;
    // with S > 1 slices, block z writes the z-th partial [S][B][L][...]
    agg += (size_t)blockIdx.z * B * L * HD;
    delta += (size_t)blockIdx.z * B * L * 3;

    const int n_off = 2 * W;
    const int n_steps = (n_off + OPS - 1) / OPS;
    const int s0 = blockIdx.z * steps_per_slice;
    const int s1 = min(n_steps, s0 + steps_per_slice);

    float agg_r[NT][2];   // receiver g, the lane's columns (summed over its rows)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) agg_r[nt][0] = agg_r[nt][1] = 0.f;
    float delta_r = 0.f;  // tid < 3T: receiver tid / 3, coordinate tid % 3
    const float bx2 = to_float(b_x2[0]);
    float acc[MT][NT][4];

    for (int step = s0; step < s1; ++step) {
        __syncthreads();   // last step's row arrays and red are consumed
        float v = 0.f;
        if (tid < M) {
            const int o = tid / T, rr = tid % T;
            const int e = step * OPS + o, i = i0 + rr;
            float d2 = 0.f, rel[3] = {0.f, 0.f, 0.f};
            int j = 0;
            if (e < n_off && i < L) {
                j = i + band_offset(e, W);
                if (j >= 0 && j < L && cmask[row0 + i] > 0.5f && cmask[row0 + j] > 0.5f) {
                    v = 1.f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                    d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                }
            }
            row_valid[tid] = v;
            row_d2[tid] = d2;
            row_j[tid] = j;
#pragma unroll
            for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
        }
        if (!__syncthreads_or(v > 0.f)) continue;   // no valid edge: adds exact zeros

        // A = silu(a_i + bs_j + d2 * w_d); rows of invalid edges are 0. Each
        // thread reads 16 bytes of a_i and of bs_j (NV values) at a time.
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
            for (int q4 = 0; q4 < NV / 4; ++q4)
                store4(A + r * AS + c + 4 * q4,
                       make_float4(p[4 * q4], p[4 * q4 + 1], p[4 * q4 + 2], p[4 * q4 + 3]));
        }
        __syncthreads();

        // m = silu(A @ W_e2 + b_e2); agg += valid * m; A = m.
        gemm(w_e2, acc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const bool ok = row_valid[ln.row0 + mt * 16 + 8 * h] > 0.f;
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const float2 be = load2(b_e2 + ln.col0 + nt * 8);
                    float m0, m1;
                    if constexpr (CB) {
                        m0 = silu_bf16(rbf(rbf(acc[mt][nt][2 * h]) + be.x));
                        m1 = silu_bf16(rbf(rbf(acc[mt][nt][2 * h + 1]) + be.y));
                    } else {
                        m0 = silu(acc[mt][nt][2 * h] + be.x);
                        m1 = silu(acc[mt][nt][2 * h + 1] + be.y);
                    }
                    acc[mt][nt][2 * h] = m0;
                    acc[mt][nt][2 * h + 1] = m1;
                    if (ok) {
                        agg_r[nt][0] += m0;
                        agg_r[nt][1] += m1;
                    }
                }
            }
        store_tile<HD>(A, acc, ln);
        __syncthreads();

        // wsc = silu(m @ W_x1 + b_x1) . w_x2 + b_x2, reduced per row (in
        // the bf16 chain: fp32 sums of the bf16 products, rounded once).
        gemm(w_x1, acc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float s = 0.f;
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const float2 bx = load2(b_x1 + ln.col0 + nt * 8);
                    const float2 wx = load2(w_x2 + ln.col0 + nt * 8);
                    if constexpr (CB) {
                        s = fmaf(silu_bf16(rbf(rbf(acc[mt][nt][2 * h]) + bx.x)), wx.x, s);
                        s = fmaf(silu_bf16(rbf(rbf(acc[mt][nt][2 * h + 1]) + bx.y)), wx.y, s);
                    } else {
                        s = fmaf(silu(acc[mt][nt][2 * h] + bx.x), wx.x, s);
                        s = fmaf(silu(acc[mt][nt][2 * h + 1] + bx.y), wx.y, s);
                    }
                }
                s = quad_sum(s);
                if (ln.t == 0) red[wn * M + ln.row0 + mt * 16 + 8 * h] = s;
            }
        __syncthreads();
        // delta_i += sum over the step's offsets of valid * wsc * rel
        if (tid < 3 * T) {
            const int rr = tid / 3, c = tid % 3;
            for (int o = 0; o < OPS; ++o) {
                const int r = o * T + rr;
                if (row_valid[r] > 0.f) {
                    float wsc = 0.f;
#pragma unroll
                    for (int q = 0; q < TL::WN; ++q) wsc += red[q * M + r];
                    wsc = CB ? rbf(rbf(wsc) + bx2) : wsc + bx2;
                    delta_r += wsc * row_rel[r * 3 + c];
                }
            }
        }
    }

    // Each output row is written once. With WM > 1 warps per column, the
    // row-tile halves are summed in warp order through shared memory.
    const int i = i0 + ln.g;
    if constexpr (TL::WM > 1) {
        __syncthreads();
        const int wm = (tid / 32) / TL::WN;
        float* part = sm + SM::A;   // [WM][T][HD] (fits in either tile type)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
            *reinterpret_cast<float2*>(part + (wm * T + ln.g) * HD + ln.col0 + nt * 8) =
                make_float2(agg_r[nt][0], agg_r[nt][1]);
        __syncthreads();
        if (wm == 0) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    float s = 0.f;
                    for (int q = 0; q < TL::WM; ++q) s += part[(q * T + ln.g) * HD + ln.col0 + nt * 8 + c];
                    agg_r[nt][c] = s;
                }
        }
        if (wm == 0 && i < L) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
                *reinterpret_cast<float2*>(agg + (row0 + i) * HD + ln.col0 + nt * 8) =
                    make_float2(agg_r[nt][0], agg_r[nt][1]);
        }
    } else if (i < L) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
            *reinterpret_cast<float2*>(agg + (row0 + i) * HD + ln.col0 + nt * 8) =
                make_float2(agg_r[nt][0], agg_r[nt][1]);
    }
    if (tid < 3 * T && i0 + tid / 3 < L) delta[(row0 + i0 + tid / 3) * 3 + tid % 3] = delta_r;
}

// The wide variant (hd > 512, WIDE_GROUP | hd; egnn_tile.cuh): the same
// function, steps and rounding as egnn_band_fwd_kernel, one persistent
// block per resident slot walking the (batch row, tile) items g, g + G, ...
// and every step of each. A step's m1 and m rows ([M][hd] each, in the
// chain's type) lie in the block's two scratch buffers, X and Y; each
// product runs over the hd output columns in groups of WIDE_GROUP. The lane
// that owns (receiver g, column) in a group adds the step's valid messages
// to agg in device memory (the item's agg rows are zeroed first); the
// per-row w_x2 dot products are summed over the warps, then over the
// groups, in a fixed order. Deterministic, no atomics.
template <class In, int MODE>
__global__ void __launch_bounds__(WideTile::THREADS, WideTile::MIN_BLOCKS)
egnn_band_fwd_wide(const In* __restrict__ a, const In* __restrict__ bs,
                   const float* __restrict__ x, const float* __restrict__ cmask,
                   const typename Chain<MODE>::Act* __restrict__ w_d,
                   const typename Chain<MODE>::Act* __restrict__ w_e2,
                   const typename Chain<MODE>::Act* __restrict__ b_e2,
                   const typename Chain<MODE>::Act* __restrict__ w_x1,
                   const typename Chain<MODE>::Act* __restrict__ b_x1,
                   const typename Chain<MODE>::Act* __restrict__ w_x2,
                   const typename Chain<MODE>::Act* __restrict__ b_x2, float* __restrict__ agg,
                   float* __restrict__ delta, typename Chain<MODE>::Act* scratch, int B, int L,
                   int hd, int W) {
    using TL = WideTile;
    using Act = typename Chain<MODE>::Act;
    constexpr bool CB = Chain<MODE>::BF16;
    constexpr int MT = TL::MT, NT = TL::NT;
    __shared__ float red[TL::WN * M];
    __shared__ float rowsum[M];   // the w_x2 dot product of each row, summed over groups
    __shared__ float row_valid[M], row_d2[M], row_rel[3 * M];
    __shared__ int row_j[M];
    Act* X = scratch + (size_t)blockIdx.x * 2 * M * hd;   // m1 of the step
    Act* Y = X + (size_t)M * hd;                           // m of the step

    const int tid = threadIdx.x;
    const Lane ln = Lane::of<WIDE_GROUP>(tid);
    const int wn = (tid / 32) % TL::WN;
    const int n_off = 2 * W;
    const int n_steps = (n_off + OPS - 1) / OPS;
    const int n_tiles = (L + T - 1) / T;
    const float bx2 = to_float(b_x2[0]);
    float acc[MT][NT][4];

    for (int item = blockIdx.x; item < B * n_tiles; item += gridDim.x) {
        const int b = item / n_tiles;
        const int i0 = (item % n_tiles) * T;
        const size_t row0 = (size_t)b * L;
        const In* a_b = a + row0 * hd;
        const In* bs_b = bs + row0 * hd;
        const int my_i = i0 + ln.g;
        __syncthreads();   // the last item's row arrays are consumed
        for (int k = tid; k < T * hd; k += TL::THREADS)
            if (i0 + k / hd < L) agg[(row0 + i0) * hd + k] = 0.f;
        float delta_r = 0.f;   // tid < 3T: receiver tid / 3, coordinate tid % 3

        for (int step = 0; step < n_steps; ++step) {
            __syncthreads();   // row arrays, red and rowsum consumed; agg zeroed
            float v = 0.f;
            if (tid < M) {
                const int o = tid / T, rr = tid % T;
                const int e = step * OPS + o, i = i0 + rr;
                float d2 = 0.f, rel[3] = {0.f, 0.f, 0.f};
                int j = 0;
                if (e < n_off && i < L) {
                    j = i + band_offset(e, W);
                    if (j >= 0 && j < L && cmask[row0 + i] > 0.5f && cmask[row0 + j] > 0.5f) {
                        v = 1.f;
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            rel[c] = x[(row0 + i) * 3 + c] - x[(row0 + j) * 3 + c];
                        d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
                    }
                }
                row_valid[tid] = v;
                row_d2[tid] = d2;
                row_j[tid] = j;
                rowsum[tid] = 0.f;
#pragma unroll
                for (int c = 0; c < 3; ++c) row_rel[tid * 3 + c] = rel[c];
            }
            if (!__syncthreads_or(v > 0.f)) continue;   // no valid edge: adds exact zeros

            // X = silu(a_i + bs_j + d2 * w_d); rows of invalid edges are 0
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
                    store4(X + (size_t)r * hd + c + 4 * q4,
                           make_float4(p[4 * q4], p[4 * q4 + 1], p[4 * q4 + 2], p[4 * q4 + 3]));
            }
            __syncthreads();

            // Y = m = silu(X @ W_e2 + b_e2); agg_i += sum over the step of valid * m
            for (int c0 = 0; c0 < hd; c0 += WIDE_GROUP) {
                if constexpr (CB) gemm_wide(X, hd, w_e2, hd, c0, hd, acc, ln);
                else gemm_wide<MODE, MODE == 3>(X, hd, w_e2, hd, c0, hd, acc, ln);
                float sum[NT][2];
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) sum[nt][0] = sum[nt][1] = 0.f;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const bool ok = row_valid[ln.row0 + mt * 16 + 8 * h] > 0.f;
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt) {
                            const float2 be = load2(b_e2 + c0 + ln.col0 + nt * 8);
                            float m0, m1;
                            if constexpr (CB) {
                                m0 = silu_bf16(rbf(rbf(acc[mt][nt][2 * h]) + be.x));
                                m1 = silu_bf16(rbf(rbf(acc[mt][nt][2 * h + 1]) + be.y));
                            } else {
                                m0 = silu(acc[mt][nt][2 * h] + be.x);
                                m1 = silu(acc[mt][nt][2 * h + 1] + be.y);
                            }
                            acc[mt][nt][2 * h] = m0;
                            acc[mt][nt][2 * h + 1] = m1;
                            if (ok) {
                                sum[nt][0] += m0;
                                sum[nt][1] += m1;
                            }
                        }
                    }
                store_rows_wide(Y, hd, c0, acc, ln);
                if (my_i < L) {
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        float2* p = reinterpret_cast<float2*>(agg + (row0 + my_i) * hd + c0 +
                                                              ln.col0 + nt * 8);
                        const float2 o = *p;
                        *p = make_float2(o.x + sum[nt][0], o.y + sum[nt][1]);
                    }
                }
            }
            __syncthreads();   // Y complete

            // wsc = silu(Y @ W_x1 + b_x1) . w_x2 + b_x2, per row
            for (int c0 = 0; c0 < hd; c0 += WIDE_GROUP) {
                if constexpr (CB) gemm_wide(Y, hd, w_x1, hd, c0, hd, acc, ln);
                else gemm_wide<MODE, MODE == 3>(Y, hd, w_x1, hd, c0, hd, acc, ln);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float sw = 0.f;
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt) {
                            const float2 bx = load2(b_x1 + c0 + ln.col0 + nt * 8);
                            const float2 wx = load2(w_x2 + c0 + ln.col0 + nt * 8);
                            if constexpr (CB) {
                                sw = fmaf(silu_bf16(rbf(rbf(acc[mt][nt][2 * h]) + bx.x)), wx.x, sw);
                                sw = fmaf(silu_bf16(rbf(rbf(acc[mt][nt][2 * h + 1]) + bx.y)), wx.y, sw);
                            } else {
                                sw = fmaf(silu(acc[mt][nt][2 * h] + bx.x), wx.x, sw);
                                sw = fmaf(silu(acc[mt][nt][2 * h + 1] + bx.y), wx.y, sw);
                            }
                        }
                        sw = quad_sum(sw);
                        if (ln.t == 0) red[wn * M + ln.row0 + mt * 16 + 8 * h] = sw;
                    }
                __syncthreads();
                if (tid < M) {
                    float t = 0.f;
#pragma unroll
                    for (int q = 0; q < TL::WN; ++q) t += red[q * M + tid];
                    rowsum[tid] += t;
                }
                __syncthreads();   // red consumed
            }
            // delta_i += sum over the step's offsets of valid * wsc * rel
            if (tid < 3 * T) {
                const int rr = tid / 3, c = tid % 3;
                for (int o = 0; o < OPS; ++o) {
                    const int r = o * T + rr;
                    if (row_valid[r] > 0.f) {
                        const float wsc = CB ? rbf(rbf(rowsum[r]) + bx2) : rowsum[r] + bx2;
                        delta_r += wsc * row_rel[r * 3 + c];
                    }
                }
            }
        }
        if (tid < 3 * T && i0 + tid / 3 < L) delta[(row0 + i0 + tid / 3) * 3 + tid % 3] = delta_r;
    }
}

template <int HD, class In, int MODE>
cudaError_t launch(const In* a, const In* bs, const float* x, const float* cmask,
                   const void* const* wts, float* agg, float* delta, float* part_agg,
                   float* part_delta, int B, int L, int W, int S, cudaStream_t stream) {
    using Act = typename Chain<MODE>::Act;
    constexpr size_t smem = sizeof(float) * FwdSmem<HD, MODE>::FLOATS;
    auto kernel = egnn_band_fwd_kernel<HD, In, MODE>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int n_steps = (2 * W + OPS - 1) / OPS;
    const int per = (n_steps + S - 1) / S;
    if (S < 1 || (S - 1) * per >= n_steps || (S > 1 && (!part_agg || !part_delta)))
        return cudaErrorInvalidValue;   // every slice must own at least one step
    const Act* w[7];
    for (int k = 0; k < 7; ++k) w[k] = static_cast<const Act*>(wts[k]);
    dim3 grid((L + T - 1) / T, B, S);
    kernel<<<grid, Tile<HD>::THREADS, smem, stream>>>(
        a, bs, x, cmask, w[0], w[1], w[2], w[3], w[4], w[5], w[6],
        S > 1 ? part_agg : agg, S > 1 ? part_delta : delta, L, W, per);
    if ((err = cudaGetLastError()) != cudaSuccess || S == 1) return err;
    const size_t n_agg4 = (size_t)B * L * HD / 4, n_delta = (size_t)B * L * 3;
    const size_t blocks = (n_agg4 + n_delta + THREADS - 1) / THREADS;
    egnn_band_fwd_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(
        part_agg, part_delta, agg, delta, n_agg4, n_delta, S);
    return cudaGetLastError();
}

template <class In, int MODE>
cudaError_t launch_wide(const In* a, const In* bs, const float* x, const float* cmask,
                        const void* const* wts, float* agg, float* delta, void* scratch, int B,
                        int L, int hd, int W, int G, cudaStream_t stream) {
    using Act = typename Chain<MODE>::Act;
    if (!wide_width(hd) || G < 1 || !scratch) return cudaErrorInvalidValue;
    const Act* w[7];
    for (int k = 0; k < 7; ++k) w[k] = static_cast<const Act*>(wts[k]);
    egnn_band_fwd_wide<In, MODE><<<G, WideTile::THREADS, 0, stream>>>(
        a, bs, x, cmask, w[0], w[1], w[2], w[3], w[4], w[5], w[6], agg, delta,
        static_cast<Act*>(scratch), B, L, hd, W);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the mode (bf16_in, passes, chain_bf16) at width hd that one SM
// holds at once, or a negative CUDA error code.
int egnn_band_fwd_blocks_per_sm(int hd, int bf16_in, int passes, int chain_bf16) {
    int n = 0;
    if (hd > 512) {   // the wide variant
        if (!wide_width(hd)) return -static_cast<int>(cudaErrorInvalidValue);
        const cudaError_t err = dispatch_mode(bf16_in, passes, chain_bf16, [&](auto in_c, auto m_c) {
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, egnn_band_fwd_wide<typename decltype(in_c)::type, decltype(m_c)::value>,
                WideTile::THREADS, 0);
        });
        return err == cudaSuccess ? n : -static_cast<int>(err);
    }
    const cudaError_t err = dispatch(hd, bf16_in, passes, chain_bf16,
                                     [&](auto hd_c, auto in_c, auto m_c) {
        constexpr int HD = decltype(hd_c)::value, MODE = decltype(m_c)::value;
        constexpr size_t smem = sizeof(float) * FwdSmem<HD, MODE>::FLOATS;
        auto kernel = egnn_band_fwd_kernel<HD, typename decltype(in_c)::type, MODE>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, Tile<HD>::THREADS,
                                                             smem);
    });
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launch on `stream`; returns the CUDA error code of the launch (0 = success).
// All pointers are device pointers to contiguous arrays, 16-byte aligned:
// a, bs [B, L, hd], bf16 when bf16_in, else fp32; x [B, L, 3], cmask [B, L]
// fp32; the weights w_d, b_e2, b_x1, w_x2 [hd], w_e2, w_x1 [hd, hd] (in,
// out), b_x2 [1], bf16 when chain_bf16, else fp32; agg [B, L, hd] and delta
// [B, L, 3] fp32. passes: TF32 passes per product of the fp32 chain (3 =
// fp32 accuracy, 1 = one-pass TF32; 1 or 3 with the bf16 chain, which
// makes one bf16 pass). S: slices of the 2W band offsets (1 = one block
// per (batch row, tile)); S > 1 needs part_agg [S, B, L, hd] and
// part_delta [S, B, L, 3] and runs a second kernel that sums them in slice
// order.
int egnn_band_fwd_launch(const void* a, const void* bs, const float* x, const float* cmask,
                         const void* w_d, const void* w_e2, const void* b_e2, const void* w_x1,
                         const void* b_x1, const void* w_x2, const void* b_x2, float* agg,
                         float* delta, float* part_agg, float* part_delta, int B, int L, int hd,
                         int W, int S, int bf16_in, int passes, int chain_bf16, void* stream) {
    const void* wts[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(hd, bf16_in, passes, chain_bf16, [&](auto hd_c, auto in_c, auto m_c) {
        using In = typename decltype(in_c)::type;
        return launch<decltype(hd_c)::value, In, decltype(m_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, wts, agg, delta,
            part_agg, part_delta, B, L, W, S, s);
    });
}

// The wide variant (hd > 512, a multiple of 256): floats of scratch for a
// grid of G blocks (two [64, hd] activation buffers each, in the chain's
// type), and its launch on `stream` with the arguments of
// egnn_band_fwd_launch (no slices: G persistent blocks, G >= 1).
size_t egnn_band_fwd_wide_scratch_floats(int hd, int G, int chain_bf16) {
    const size_t vals = (size_t)G * 2 * M * hd;
    return chain_bf16 ? (vals + 1) / 2 : vals;
}

int egnn_band_fwd_wide_launch(const void* a, const void* bs, const float* x, const float* cmask,
                              const void* w_d, const void* w_e2, const void* b_e2,
                              const void* w_x1, const void* b_x1, const void* w_x2,
                              const void* b_x2, float* agg, float* delta, void* scratch, int B,
                              int L, int hd, int W, int G, int bf16_in, int passes,
                              int chain_bf16, void* stream) {
    const void* wts[7] = {w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_mode(bf16_in, passes, chain_bf16, [&](auto in_c, auto m_c) {
        using In = typename decltype(in_c)::type;
        return launch_wide<In, decltype(m_c)::value>(
            static_cast<const In*>(a), static_cast<const In*>(bs), x, cmask, wts, agg, delta,
            scratch, B, L, hd, W, G, s);
    });
}

const char* egnn_band_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
