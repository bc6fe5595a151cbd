// Steric-clash loss over the N/CA/C backbone, fp32: one launch for the loss
// (forward) and one for its gradient (backward).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of the JAX
// package's ops/pallas/clash.py (entered through `clash_loss_pallas`). For
// backbones n, ca, c [B, L, 3] (residue r's atoms are n[r], ca[r], c[r]) and
// residue mask m [B, L]:
//     d_ij  = sqrt(|a_i - a_j|^2 + 1e-12)
//     pm_ij = m_ri m_rj [|r_i - r_j| >= 2]
//     viol  = max(clash_dist - d_ij, 0)
//     pen   = viol < soft_margin ? viol^2 / 2 : viol^2
//     total_b = sum_{i<j} pm_ij pen_ij,   count_b = 9 #{r < s - 1 : m_r m_s}
//     loss    = mean_b(total_b / (count_b + 1e-8))                   (forward)
//     d loss / d a_i = scale_b sum_j c_ij (a_i - a_j),
//     c_ij    = -(viol < soft_margin ? viol : 2 viol) pm_ij / d_ij,
//     scale_b = g / (B (count_b + 1e-8))                              (backward)
// The distance is the direct difference, as the dense `clash_loss` computes
// it (the TPU kernel used |a|^2 + |b|^2 - 2 a.b for its matrix unit).
//
// What bounds it: neither bytes nor operations. A launch reads 40 B per
// residue and the exact work is ~20 FLOP per atom pair, microseconds at
// B10/L640. What a launch costs is the latency of its chain: loads, a few
// barriers, and the fence and atomic of the cross-block sum. The design
// therefore keeps the chain short and fills the card:
// - Residues are tiled by 32 (one per lane); a block takes one pair of tiles
//   (I, J): the forward the unordered pairs I <= J, the backward every
//   ordered pair, so that each block owns the gradient of its I tile. The
//   grids hold B T (T + 1) / 2 and B T^2 blocks (T = L / 32 rounded up):
//   144 and 256 at B4/L256, 2100 and 4000 at B10/L640.
// - Each tile is cut into 4 groups of 8 residues. Two warps stage the two
//   tiles from the backbone as it lies (strided loads, no stacked copy) and
//   bound each group's valid atoms by a sphere. Then 4 x `split` warps visit
//   the pairs: warp w takes J group w % 4 and every split-th residue of it
//   against the 32 I residues; a lane skips the whole group pair when the
//   spheres lie further apart than clash_dist plus an fp32 margin; in a
//   folded chain most group pairs are out of reach. `split` (1, 2 or 4, chosen by
//   the wrapper from the grid size) puts more warps on each SM when the grid
//   is small, where one warp per scheduler left the pair loop latency-bound.
// - In a kept group pair, a residue pair is tested once against the
//   separation rule (no division), and an atom pair is rejected on
//   d^2 >= clash_dist^2 (1 + 1e-5) before any square root: only pairs that
//   may clash take sqrt and the division.
// - Sums across blocks are deterministic without atomic sums: every block
//   writes its partial, takes a ticket from an atomic counter, and the last
//   block of the launch (forward) or of an I tile (backward) sums the
//   partials in a fixed order and resets the counter for the next launch.
//   The ticket only chooses who sums, never the order of the sum.
// Both margins are exact in the sense the tests check: a pair whose viol is
// above 0 in the plain version is never rejected or culled. A non-finite
// coordinate of a valid atom is never culled or rejected either, so a NaN
// there reaches the sample's total and the gradient, as in the plain
// version. Masked atoms take no part in the sums: a NaN coordinate of a
// masked atom leaves the results finite, where the plain version's
// NaN x 0 makes the whole sample NaN.

#include <cuda_runtime.h>

namespace {

constexpr int TR = 32;                 // residues per tile (one per lane)
constexpr int GR = 8;                  // residues per culling group
constexpr int NG = TR / GR;            // groups per tile
constexpr int MAX_WARPS = 4 * NG;      // 4 x split warps per block, split <= 4
constexpr int SLOT = 9 * TR;           // backward partial: [atom type][residue][xyz]
// Rejection and culling margins (the CPU tests read them from this file).
constexpr float REJECT_REL = 1e-5f;
constexpr float CULL_ABS = 1e-4f;
constexpr float CULL_REL = 1e-5f;

struct Backbone {                      // n, ca, c share strides; mask [B, L]
    const float* at[3];
    const float* mask;
    long long sb, sr, sc, mb, mr;
    int B, L;
};

struct Tiles {
    float4 atom[2][TR][3];             // (x, y, z, residue mask) of tile I, tile J
    float4 sphere[2][NG];              // (centre, radius) per group; radius < 0: no valid atom
    float scale[2][NG];                // largest |coordinate| of the group's box
    float msum[2][3];                  // sum m, sum m^2, sum m_r m_{r+1} over the tile
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Warp `side` stages tile K of sample b (lane = residue) and bounds its
// groups; with `sums`, also the mask sums the forward's pair count needs.
__device__ void stage(const Backbone& bb, int b, int K, int side, bool sums, Tiles& sh) {
    const int lane = threadIdx.x & 31;
    const int r = K * TR + lane;
    float4 a[3];
    float m = 0.f;
    if (r < bb.L) {
        m = bb.mask[b * bb.mb + r * bb.mr];
        const long long base = b * bb.sb + r * bb.sr;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const float* p = bb.at[q] + base;
            a[q] = make_float4(p[0], p[bb.sc], p[2 * bb.sc], m);
        }
    } else {
#pragma unroll
        for (int q = 0; q < 3; ++q) a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) sh.atom[side][lane][q] = a[q];

    // a valid atom with a non-finite coordinate makes its group's sphere
    // unbounded, so the group is never culled and its pairs carry the NaN
    const bool valid = m != 0.f;
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
    float any = 0.f, bad = 0.f;
    if (valid) {
        any = 1.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            lx = fminf(lx, a[q].x); ly = fminf(ly, a[q].y); lz = fminf(lz, a[q].z);
            hx = fmaxf(hx, a[q].x); hy = fmaxf(hy, a[q].y); hz = fmaxf(hz, a[q].z);
            if (!(isfinite(a[q].x) && isfinite(a[q].y) && isfinite(a[q].z))) bad = 1.f;
        }
    }
#pragma unroll
    for (int off = 1; off < GR; off <<= 1) {       // within the lane's group of 8
        lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, off));
        ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, off));
        lz = fminf(lz, __shfl_xor_sync(0xffffffffu, lz, off));
        hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, off));
        hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, off));
        hz = fmaxf(hz, __shfl_xor_sync(0xffffffffu, hz, off));
        any = fmaxf(any, __shfl_xor_sync(0xffffffffu, any, off));
        bad = fmaxf(bad, __shfl_xor_sync(0xffffffffu, bad, off));
    }
    const bool empty = any == 0.f;
    const float cx = 0.5f * (lx + hx), cy = 0.5f * (ly + hy), cz = 0.5f * (lz + hz);
    float r2 = 0.f;
    if (valid) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const float dx = a[q].x - cx, dy = a[q].y - cy, dz = a[q].z - cz;
            r2 = fmaxf(r2, dx * dx + dy * dy + dz * dz);
        }
    }
#pragma unroll
    for (int off = 1; off < GR; off <<= 1) r2 = fmaxf(r2, __shfl_xor_sync(0xffffffffu, r2, off));
    if ((lane & (GR - 1)) == 0) {
        const int g = lane / GR;
        const float radius = empty ? -1.f : bad != 0.f ? INFINITY : sqrtf(r2);
        sh.sphere[side][g] = make_float4(cx, cy, cz, radius);
        sh.scale[side][g] = empty || bad != 0.f ? 0.f
            : fmaxf(fmaxf(fmaxf(fabsf(lx), fabsf(hx)), fmaxf(fabsf(ly), fabsf(hy))),
                    fmaxf(fabsf(lz), fabsf(hz)));
    }
    if (sums) {
        const float next = __shfl_down_sync(0xffffffffu, m, 1);
        const float s1 = warp_sum(m), s2 = warp_sum(m * m);
        const float adj = warp_sum(lane < 31 ? m * next : 0.f);
        if (lane == 0) {
            sh.msum[side][0] = s1;
            sh.msum[side][1] = s2;
            sh.msum[side][2] = adj;
        }
    }
}

// Whether the lane's I group and the warp's J group may hold a clashing
// pair: both hold a valid atom and their spheres lie within clash_dist plus
// the margin. An unbounded sphere (radius INFINITY) or a NaN centre keeps it.
__device__ __forceinline__ bool group_kept(const Tiles& sh, int gi, int gj, float clash_dist) {
    const float4 si = sh.sphere[0][gi], sj = sh.sphere[1][gj];
    if (si.w < 0.f || sj.w < 0.f) return false;
    const float dx = si.x - sj.x, dy = si.y - sj.y, dz = si.z - sj.z;
    const float lim = si.w + sj.w + clash_dist + CULL_ABS
                      + CULL_REL * (sh.scale[0][gi] + sh.scale[1][gj]);
    return !(dx * dx + dy * dy + dz * dz > lim * lim);
}

// Blocks of sample b: pair index p -> tiles I <= J, row-major.
__device__ __forceinline__ void fwd_tiles(int p, int T, int& I, int& J) {
    I = 0;
    while (p >= T - I) { p -= T - I; ++I; }
    J = I + p;
}

// The pair loop of warp w (lane = I residue): J group w % NG, its residues
// w / NG, w / NG + split, ... The forward adds each unordered pair's
// penalty to `acc` (r_j - r_i >= 2); the backward adds c_ij (a_i - a_j) to
// the lane's three atoms' gradients (|r_j - r_i| >= 2).
template <bool BWD>
__device__ __forceinline__ void visit(const Tiles& sh, int I, int J, int w, int split,
                                      float clash_dist, float soft_margin, float& acc,
                                      float (&gr)[3][3]) {
    const int lane = threadIdx.x & 31, gj = w % NG;
    float4 ai[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) ai[q] = sh.atom[0][lane][q];
    const float mi = ai[0].w;
    if (mi == 0.f || !group_kept(sh, lane / GR, gj, clash_dist)) return;
    const float cut2 = clash_dist * clash_dist * (1.f + REJECT_REL);
    const int ri = I * TR + lane;
    for (int t = w / NG; t < GR; t += split) {
        const int jl = gj * GR + t;
        const float4* aj = sh.atom[1][jl];
        const float mj = aj[0].w;
        const int sep = J * TR + jl - ri;
        if (mj == 0.f || (BWD ? (sep < 2 && sep > -2) : sep < 2)) continue;
#pragma unroll
        for (int qi = 0; qi < 3; ++qi)
#pragma unroll
            for (int qj = 0; qj < 3; ++qj) {
                const float4 v = aj[qj];
                const float dx = ai[qi].x - v.x, dy = ai[qi].y - v.y, dz = ai[qi].z - v.z;
                const float d2 = dx * dx + dy * dy + dz * dz;
                if (!(d2 >= cut2)) {                 // NaN is kept
                    const float d = sqrtf(d2 + 1e-12f);
                    if (BWD) {
                        const float viol = clash_dist - d;
                        if (!(viol <= 0.f)) {
                            const float dp = viol < soft_margin ? viol : 2.f * viol;
                            const float c = -dp * (mi * mj) / d;
                            gr[qi][0] = fmaf(c, dx, gr[qi][0]);
                            gr[qi][1] = fmaf(c, dy, gr[qi][1]);
                            gr[qi][2] = fmaf(c, dz, gr[qi][2]);
                        }
                    } else {
                        const float u = clash_dist - d;
                        const float viol = u < 0.f ? 0.f : u;   // relu, NaN kept
                        const float pen = viol < soft_margin ? 0.5f * viol * viol : viol * viol;
                        acc += pen * (mi * mj);
                    }
                }
            }
    }
}

__global__ void __launch_bounds__(32 * MAX_WARPS)
clash_fwd_kernel(Backbone bb, float* __restrict__ out, float* __restrict__ scratch,
                 int* __restrict__ ticket, float clash_dist, float soft_margin) {
    __shared__ Tiles sh;
    __shared__ float red[MAX_WARPS];
    __shared__ int last;
    const int B = bb.B, T = (bb.L + TR - 1) / TR, P = T * (T + 1) / 2;
    const int p = blockIdx.x, b = blockIdx.y;
    const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int I, J;
    fwd_tiles(p, T, I, J);
    if (w < 2) stage(bb, b, w == 0 ? I : J, w, true, sh);
    __syncthreads();

    float acc = 0.f, unused[3][3];
    visit<false>(sh, I, J, w, nw / NG, clash_dist, soft_margin, acc, unused);

    // fixed-order block sum; the pair count of the tile pair in closed form
    acc = warp_sum(acc);
    if (lane == 0) red[w] = acc;
    __syncthreads();
    float* part = scratch;                   // [B, P, 2]: penalty, pair count / 9
    float* ratio = scratch + 2 * B * P;      // [B]
    if (threadIdx.x == 0) {
        float pen = 0.f;
        for (int k = 0; k < nw; ++k) pen += red[k];
        const float sI = sh.msum[0][0], sJ = sh.msum[1][0];
        float cnt;
        if (J == I)
            cnt = 0.5f * (sI * sI - sh.msum[0][1]) - sh.msum[0][2];
        else
            cnt = sI * sJ - (J == I + 1 ? sh.atom[0][TR - 1][0].w * sh.atom[1][0][0].w : 0.f);
        part[(b * P + p) * 2] = pen;
        part[(b * P + p) * 2 + 1] = cnt;
        __threadfence();
        last = atomicAdd(ticket, 1) == B * P - 1;
    }
    __syncthreads();
    if (!last) return;

    // the launch's last block: warp w sums samples w, w + nw, ... in a fixed
    // order, then warp 0 the samples' ratios
    __threadfence();
    const float2* part2 = reinterpret_cast<const float2*>(part);
    for (int s = w; s < B; s += nw) {
        float sp = 0.f, sc = 0.f;
#pragma unroll 8
        for (int k = lane; k < P; k += 32) {
            const float2 v = __ldcg(part2 + s * P + k);
            sp += v.x;
            sc += v.y;
        }
        sp = warp_sum(sp);
        sc = warp_sum(sc);
        if (lane == 0) {
            const float count = 9.f * sc;
            out[1 + s] = sp;
            out[1 + B + s] = count;
            ratio[s] = sp / (count + 1e-8f);
        }
    }
    __syncthreads();
    if (w != 0) return;
    float sum = 0.f;
    for (int k = lane; k < B; k += 32) sum += __ldcg(ratio + k);
    sum = warp_sum(sum);
    if (lane == 0) {
        out[0] = sum / (float)B;
        *ticket = 0;
    }
}

__global__ void __launch_bounds__(32 * MAX_WARPS)
clash_bwd_kernel(Backbone bb, const float* __restrict__ g, const float* __restrict__ counts,
                 float* __restrict__ grad, float* __restrict__ scratch, int* __restrict__ ticket,
                 float clash_dist, float soft_margin) {
    __shared__ Tiles sh;
    extern __shared__ float red[];           // [warps][SLOT], dynamic
    __shared__ int last;
    const int T = gridDim.x;
    const int J = blockIdx.x, I = blockIdx.y, b = blockIdx.z;
    const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (w < 2) stage(bb, b, w == 0 ? I : J, w, false, sh);
    __syncthreads();

    float acc = 0.f, gr[3][3] = {};
    visit<true>(sh, I, J, w, nw / NG, clash_dist, soft_margin, acc, gr);

    // the warps' sums in warp order -> this block's partial slot
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k) red[w * SLOT + q * 3 * TR + lane * 3 + k] = gr[q][k];
    __syncthreads();
    const int row = b * T + I;               // (sample, I tile): T partial slots
    float* slots = scratch + (size_t)row * T * SLOT;
    for (int e = threadIdx.x; e < SLOT; e += blockDim.x) {
        float s = 0.f;
        for (int k = 0; k < nw; ++k) s += red[k * SLOT + e];
        slots[(size_t)J * SLOT + e] = s;
    }
    __threadfence();                         // every writer's slot is visible before the ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&ticket[row], 1) == T - 1;
    __syncthreads();
    if (!last) return;

    // the last block of the row sums the T slots in J order
    __threadfence();
    const float scale = __ldg(g) / ((float)bb.B * (__ldg(counts + b) + 1e-8f));
    const size_t L = bb.L;
    for (int e = threadIdx.x; e < SLOT; e += blockDim.x) {
        float s = 0.f;
        int k = 0;
        for (; k + 8 <= T; k += 8) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = __ldcg(slots + (size_t)(k + u) * SLOT + e);
#pragma unroll
            for (int u = 0; u < 8; ++u) s += v[u];
        }
        for (; k < T; ++k) s += __ldcg(slots + (size_t)k * SLOT + e);
        const int q = e / (3 * TR), rem = e - q * 3 * TR;
        const int r = I * TR + rem / 3;
        if (r < bb.L) grad[q * bb.B * L * 3 + ((size_t)b * L + I * TR) * 3 + rem] = scale * s;
    }
    if (threadIdx.x == 0) ticket[row] = 0;
}

__global__ void clash_noop_kernel() {}

Backbone backbone(const float* n, const float* ca, const float* c, const float* mask, int B,
                  int L, long long sb, long long sr, long long sc, long long mb, long long mr) {
    Backbone bb;
    bb.at[0] = n; bb.at[1] = ca; bb.at[2] = c;
    bb.mask = mask;
    bb.sb = sb; bb.sr = sr; bb.sc = sc; bb.mb = mb; bb.mr = mr;
    bb.B = B; bb.L = L;
    return bb;
}

}  // namespace

extern "C" {

// out [1 + 2B] = (loss, totals [B], counts [B]). n, ca, c: [B, L, 3] with
// element strides (sb, sr, sc), shared by the three; mask [B, L] with
// strides (mb, mr); fp32, device. split: 1, 2 or 4 (blocks of 128 x split
// threads). scratch: 2 B P + B floats, P = T (T + 1) / 2, T = ceil(L / 32);
// ticket: 1 int, zero before the first launch and left zero by every
// launch. Returns the CUDA error of the launch.
int clash_fwd_f32(const float* n, const float* ca, const float* c, const float* mask,
                  float* out, float* scratch, int* ticket, int B, int L, int split,
                  long long sb, long long sr, long long sc, long long mb, long long mr,
                  float clash_dist, float soft_margin, void* stream) {
    const int T = (L + TR - 1) / TR;
    clash_fwd_kernel<<<dim3(T * (T + 1) / 2, B), 32 * NG * split, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        backbone(n, ca, c, mask, B, L, sb, sr, sc, mb, mr), out, scratch, ticket, clash_dist,
        soft_margin);
    return cudaGetLastError();
}

// grad [3, B, L, 3] = (dn, dca, dc) of the loss, with upstream gradient
// *g (device scalar) and the forward's counts [B]. scratch: B T^2 9 * 32
// floats; ticket: B T ints, zero and left zero. Other arguments as above.
int clash_bwd_f32(const float* n, const float* ca, const float* c, const float* mask,
                  const float* g, const float* counts, float* grad, float* scratch, int* ticket,
                  int B, int L, int split, long long sb, long long sr, long long sc,
                  long long mb, long long mr, float clash_dist, float soft_margin,
                  void* stream) {
    const int T = (L + TR - 1) / TR;
    clash_bwd_kernel<<<dim3(T, T, B), 32 * NG * split, NG * split * SLOT * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
        backbone(n, ca, c, mask, B, L, sb, sr, sc, mb, mr), g, counts, grad, scratch, ticket,
        clash_dist, soft_margin);
    return cudaGetLastError();
}

// An empty kernel through the same interface: the launch floor.
int clash_noop(void* stream) {
    clash_noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return cudaGetLastError();
}

const char* clash_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
