// Steric-clash loss over the interleaved N/CA/C backbone atoms, fp32: the
// per-sample penalty sum (forward) and its gradient (backward).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of the JAX
// package's ops/pallas/clash.py (entered through `clash_loss_pallas`). For
// atoms a [B, A, 3] (A = 3L, atom k belongs to residue k / 3) and atom mask
// m [B, A]:
//     d_ij  = sqrt(|a_i - a_j|^2 + 1e-12)
//     pm_ij = m_i m_j [|i/3 - j/3| >= 2]
//     viol  = max(clash_dist - d_ij, 0)
//     pen   = viol < soft_margin ? viol^2 / 2 : viol^2
//     total_b = sum_{i<j} pm_ij pen_ij                        (forward)
//     grad_i  = scale_b sum_j c_ij (a_i - a_j),
//     c_ij    = -(viol < soft_margin ? viol : 2 viol) pm_ij / d_ij  (backward)
// The distance is the direct difference, as the dense `clash_loss` computes
// it (the TPU kernel used |a|^2 + |b|^2 - 2 a.b for its matrix unit).
//
// What bounds it: neither bytes nor operations. A launch reads 16 A bytes per
// sample and does ~20 FLOP per atom pair (a few MFLOP at A = 1920): the bound
// is microseconds and the launch itself costs more.
//
// Design: one block per (sample, 32 atom rows), 256 threads; a row's pairs are
// split over 8 threads, and the sender atoms stream through shared memory in
// tiles of 256. The TPU kernel summed across its sequential grid into one
// output (`out_ref[...] +=`); here each block writes its own partial sum and a
// second launch adds a sample's partials in tile order, so there are no
// atomics and the result is the same on every run. The forward sums the upper
// triangle (j > i) directly; the backward walks every j, so each block owns
// its rows' gradient outright. No padding of A is needed.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RT = 32;              // atom rows per block
constexpr int SPLIT = THREADS / RT; // threads per row
constexpr int JT = 256;             // sender atoms per shared-memory tile

__device__ __forceinline__ void stage(const float* __restrict__ atoms, const float* __restrict__ amask,
                                      int b, int A, int j0, float4* tile) {
    for (int t = threadIdx.x; t < JT; t += THREADS) {
        const int j = j0 + t;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < A) {
            const float* p = atoms + ((size_t)b * A + j) * 3;
            v = make_float4(p[0], p[1], p[2], amask[(size_t)b * A + j]);
        }
        tile[t] = v;
    }
}

__global__ void __launch_bounds__(THREADS)
clash_fwd_kernel(const float* __restrict__ atoms, const float* __restrict__ amask,
                 float* __restrict__ partial, int A, float clash_dist, float soft_margin) {
    __shared__ float4 tile[JT];
    __shared__ float warp_sum[THREADS / 32];
    const int b = blockIdx.y, i0 = blockIdx.x * RT;
    const int i = i0 + threadIdx.x / SPLIT, q = threadIdx.x % SPLIT;
    float ax = 0.f, ay = 0.f, az = 0.f, mi = 0.f;
    if (i < A) {
        const float* p = atoms + ((size_t)b * A + i) * 3;
        ax = p[0]; ay = p[1]; az = p[2];
        mi = amask[(size_t)b * A + i];
    }
    float acc = 0.f;
    for (int j0 = (i0 / JT) * JT; j0 < A; j0 += JT) {   // tiles holding some j > i0
        __syncthreads();
        stage(atoms, amask, b, A, j0, tile);
        __syncthreads();
        if (mi == 0.f) continue;
        for (int t = q; t < JT; t += SPLIT) {
            const int j = j0 + t;
            if (j <= i || j >= A) continue;
            const float4 v = tile[t];
            const int sep = i / 3 - j / 3;
            if (v.w == 0.f || (sep < 2 && sep > -2)) continue;
            const float dx = ax - v.x, dy = ay - v.y, dz = az - v.z;
            const float d = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
            const float viol = fmaxf(clash_dist - d, 0.f);
            const float pen = viol < soft_margin ? 0.5f * viol * viol : viol * viol;
            acc += pen * (mi * v.w);
        }
    }
    // fixed-order reductions: shuffle tree in the warp, then the warps in order
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        float t = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) t += warp_sum[w];
        partial[(size_t)b * gridDim.x + blockIdx.x] = t;
    }
}

__global__ void clash_sum_kernel(const float* __restrict__ partial, float* __restrict__ totals,
                                 int B, int n_tiles) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    float t = 0.f;
    for (int k = 0; k < n_tiles; ++k) t += partial[(size_t)b * n_tiles + k];
    totals[b] = t;
}

__global__ void __launch_bounds__(THREADS)
clash_bwd_kernel(const float* __restrict__ atoms, const float* __restrict__ amask,
                 const float* __restrict__ scale, float* __restrict__ grad, int A,
                 float clash_dist, float soft_margin) {
    __shared__ float4 tile[JT];
    const int b = blockIdx.y, i0 = blockIdx.x * RT;
    const int i = i0 + threadIdx.x / SPLIT, q = threadIdx.x % SPLIT;
    float ax = 0.f, ay = 0.f, az = 0.f, mi = 0.f;
    if (i < A) {
        const float* p = atoms + ((size_t)b * A + i) * 3;
        ax = p[0]; ay = p[1]; az = p[2];
        mi = amask[(size_t)b * A + i];
    }
    float gx = 0.f, gy = 0.f, gz = 0.f;
    for (int j0 = 0; j0 < A; j0 += JT) {
        __syncthreads();
        stage(atoms, amask, b, A, j0, tile);
        __syncthreads();
        if (mi == 0.f) continue;
        for (int t = q; t < JT; t += SPLIT) {
            const int j = j0 + t;
            if (j >= A) break;
            const float4 v = tile[t];
            const int sep = i / 3 - j / 3;
            if (v.w == 0.f || (sep < 2 && sep > -2)) continue;
            const float dx = ax - v.x, dy = ay - v.y, dz = az - v.z;
            const float d = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
            const float viol = fmaxf(clash_dist - d, 0.f);
            if (viol <= 0.f) continue;
            const float dp = viol < soft_margin ? viol : 2.f * viol;
            const float c = -dp * (mi * v.w) / d;
            gx = fmaf(c, dx, gx);
            gy = fmaf(c, dy, gy);
            gz = fmaf(c, dz, gz);
        }
    }
    // the row's 8 threads are 8 neighbouring lanes: a fixed shuffle tree
    for (int off = SPLIT / 2; off > 0; off >>= 1) {
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
        gy += __shfl_xor_sync(0xffffffffu, gy, off);
        gz += __shfl_xor_sync(0xffffffffu, gz, off);
    }
    if (q == 0 && i < A) {
        const float s = scale[b];
        float* g = grad + ((size_t)b * A + i) * 3;
        g[0] = s * gx;
        g[1] = s * gy;
        g[2] = s * gz;
    }
}

}  // namespace

extern "C" {

// Row tiles per sample: the forward's partial buffer holds B * this floats.
int clash_n_tiles(int A) { return (A + RT - 1) / RT; }

// totals [B] = per-sample upper-triangle penalty sums; partial is scratch of
// B * clash_n_tiles(A) floats. atoms [B, A, 3], amask [B, A]; fp32, device.
// Returns the CUDA error code of the launches (0 = success).
int clash_fwd_f32(const float* atoms, const float* amask, float* partial, float* totals,
                  int B, int A, float clash_dist, float soft_margin, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = clash_n_tiles(A);
    clash_fwd_kernel<<<dim3(n_tiles, B), THREADS, 0, s>>>(atoms, amask, partial, A,
                                                          clash_dist, soft_margin);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    clash_sum_kernel<<<(B + 127) / 128, 128, 0, s>>>(partial, totals, B, n_tiles);
    return cudaGetLastError();
}

// grad [B, A, 3] = scale[b] * d total_b / d atoms (each unordered pair
// counted once in total_b). atoms, amask as above; scale [B].
int clash_bwd_f32(const float* atoms, const float* amask, const float* scale, float* grad,
                  int B, int A, float clash_dist, float soft_margin, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    clash_bwd_kernel<<<dim3(clash_n_tiles(A), B), THREADS, 0, s>>>(atoms, amask, scale, grad, A,
                                                                   clash_dist, soft_margin);
    return cudaGetLastError();
}

const char* clash_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
