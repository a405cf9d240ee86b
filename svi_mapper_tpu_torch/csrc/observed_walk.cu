// The chi^2 and the back-substitution of the card's kernel route of bundle
// adjustment (solvers/ba.py:_CardKernelBuffers), over the observed
// (keyframe, landmark) slots only. The contract and the plain PyTorch
// versions are in ops/observed_walk.py.
//
// Replaces no TPU kernel: the JAX package (svi_mapper_tpu/solvers/ba.py)
// and the port's other routes compute both as dense [K, L] passes. Added
// because on a map segment, where a landmark is seen by ~9 of 128
// keyframes, those passes over every slot (the [K, L, 4] residuals written
// and read back, the [3, 6K, L] W planes read whole) took 4.3 of the card's
// 5.8 ms an LM iteration at 128 x 65,536, with 7.3 % of the slots observed.
//
// One walk, two entries. A block takes 32 landmarks (one a lane) and walks
// their keyframes with 8 warps: warp y takes keyframes y, y + 8, ..., reads
// the weights obs_w[k, l] of its 32 landmarks in one coalesced load and
// skips the slots where they are 0. An observed slot reads its 16 bytes of
// observation (chi^2) or its 18 W entries (back-substitution), each load
// coalesced across the lanes that observe keyframe k; the pose or the step
// of keyframe k is one address for the whole warp.
//
// 1. observed_chi2_kernel: per observed slot what _project -> robust_w ->
//    _chi2 compute (float32): the camera-frame point, the four stereo
//    residuals, the robust weight times obs_w, times err^2; added per thread
//    in float64, per block in a fixed tree into part[block];
//    observed_chi2_sum_kernel (one block) adds the blocks' partials in a
//    fixed order and writes the float32 sum.
// 2. observed_update_kernel: per landmark W^T dp = sum over its observing
//    keyframes of W[b, 6k + q, l] dp[k, q] (float32, each warp over its
//    keyframes, then the warps in warp order), then fused
//    X_new = X - Hll_inv (b_l + W^T dp).
//
// No atomics in any sum: the same inputs give the same bits run to run.
//
// What bounds them on an H100: memory. The weights are read whole (4 K L
// bytes: 33.5 MB at 128 x 65,536), the rest only at observed slots: ~612 K
// observations at 16 B of observation (chi^2) or 72 B of W (update), and
// 12 to 48 B a landmark. ~50 MB = 15 us (chi^2) and ~80 MB = 24 us (update)
// at 3.35 TB/s; ~40 and ~21 float operations an observation are far below
// the float32 rate. ops/paths.py:observed_chi2_work / observed_update_work
// count the bytes and operations of a call.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int WL = 32;                 // landmarks a block walks, one a lane
constexpr int WY = 8;                  // warps a block; warp y takes k = y (mod WY)
constexpr int WT = WL * WY;
constexpr int SUM_THREADS = 256;

struct Camera {
    float fx, fy, cx, cy, bq, kernel_px2;
};

// Adds v[0 .. WT) of shared memory in a fixed tree; thread 0 gets the sum.
__device__ __forceinline__ double block_sum(double* v) {
    for (int n = WT / 2; n > 0; n >>= 1) {
        if (threadIdx.x < n) v[threadIdx.x] += v[threadIdx.x + n];
        __syncthreads();
    }
    return v[0];
}

__global__ void __launch_bounds__(WT) observed_chi2_kernel(
    const float* __restrict__ T, const float* __restrict__ X, const float4* __restrict__ obs,
    const float* __restrict__ obs_w, double* __restrict__ part, int K, int L,
    const Camera cam) {
    __shared__ double acc_s[WT];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int l = blockIdx.x * WL + lane;
    double acc = 0.0;
    if (l < L) {
        const float px = __ldg(X + 3 * l);
        const float py = __ldg(X + 3 * l + 1);
        const float pz = __ldg(X + 3 * l + 2);
        for (int k = warp; k < K; k += WY) {
            const float m = __ldg(obs_w + (size_t)k * L + l);
            if (m == 0.0f) continue;
            const float* Tk = T + 16 * k;
            const float xc = __ldg(Tk + 0) * px + __ldg(Tk + 1) * py + __ldg(Tk + 2) * pz +
                             __ldg(Tk + 3);
            const float yc = __ldg(Tk + 4) * px + __ldg(Tk + 5) * py + __ldg(Tk + 6) * pz +
                             __ldg(Tk + 7);
            const float zc = __ldg(Tk + 8) * px + __ldg(Tk + 9) * py + __ldg(Tk + 10) * pz +
                             __ldg(Tk + 11);
            const float safe = fabsf(zc) < 1e-6f ? 1e-6f : zc;
            const float iz = 1.0f / safe;
            const float4 o = __ldg(obs + (size_t)k * L + l);
            const float u_l = cam.fx * xc * iz + cam.cx;
            const float v_l = cam.fy * yc * iz + cam.cy;
            const float u_r = (cam.fx * xc + cam.bq) * iz + cam.cx;
            const float r0 = u_l - o.x, r1 = v_l - o.y, r2 = u_r - o.z, r3 = v_l - o.w;
            const float err2 = r0 * r0 + r1 * r1 + r2 * r2 + r3 * r3;
            const float w = err2 > cam.kernel_px2 ? cam.kernel_px2 / fmaxf(err2, 1e-12f) : 1.0f;
            acc += (double)((w * m) * err2);
        }
    }
    acc_s[threadIdx.x] = acc;
    __syncthreads();
    const double s = block_sum(acc_s);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(SUM_THREADS) observed_chi2_sum_kernel(
    const double* __restrict__ part, int n, float* __restrict__ out) {
    __shared__ double acc_s[SUM_THREADS];
    double acc = 0.0;
    for (int i = threadIdx.x; i < n; i += SUM_THREADS) acc += part[i];
    acc_s[threadIdx.x] = acc;
    __syncthreads();
    for (int h = SUM_THREADS / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) acc_s[threadIdx.x] += acc_s[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) *out = (float)acc_s[0];
}

__global__ void __launch_bounds__(WT) observed_update_kernel(
    const float* __restrict__ W, const float* __restrict__ dp,
    const float* __restrict__ Hll_inv, const float* __restrict__ b_l,
    const float* __restrict__ X, const float* __restrict__ obs_w, float* __restrict__ X_new,
    int K, int L) {
    __shared__ float part[WY][3][WL];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int l = blockIdx.x * WL + lane;
    const size_t plane = (size_t)6 * K * L;   // floats of one W plane
    float v[3] = {0.f, 0.f, 0.f};
    if (l < L) {
        for (int k = warp; k < K; k += WY) {
            if (__ldg(obs_w + (size_t)k * L + l) == 0.0f) continue;
            const float* Wk = W + (size_t)6 * k * L + l;
#pragma unroll
            for (int q = 0; q < 6; ++q) {
                const float d = __ldg(dp + 6 * k + q);
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    v[b] += __ldg(Wk + b * plane + (size_t)q * L) * d;
            }
        }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) part[warp][b][lane] = v[b];
    __syncthreads();
    if (warp != 0 || l >= L) return;
    float a[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        float s = part[0][b][lane];
#pragma unroll
        for (int y = 1; y < WY; ++y) s += part[y][b][lane];
        a[b] = __ldg(b_l + 3 * l + b) + s;
    }
    const float* H = Hll_inv + 9 * (size_t)l;
#pragma unroll
    for (int i = 0; i < 3; ++i)
        X_new[3 * (size_t)l + i] =
            __ldg(X + 3 * l + i) -
            (__ldg(H + 3 * i) * a[0] + __ldg(H + 3 * i + 1) * a[1] + __ldg(H + 3 * i + 2) * a[2]);
}

}  // namespace

extern "C" int svi_observed_chi2(const void* T, const void* X, const void* obs,
                                 const void* obs_w, void* part, void* out, int K, int L,
                                 float fx, float fy, float cx, float cy, float bq,
                                 float kernel_px2, void* stream) {
    if (K < 1 || L < 1 || ((size_t)obs & 15u) != 0 || ((size_t)part & 7u) != 0)
        return (int)cudaErrorInvalidValue;
    const Camera cam = {fx, fy, cx, cy, bq, kernel_px2};
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (L + WL - 1) / WL;
    observed_chi2_kernel<<<blocks, WT, 0, st>>>(
        (const float*)T, (const float*)X, (const float4*)obs, (const float*)obs_w,
        (double*)part, K, L, cam);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    observed_chi2_sum_kernel<<<1, SUM_THREADS, 0, st>>>((const double*)part, blocks,
                                                        (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int svi_observed_update(const void* W, const void* dp, const void* Hll_inv,
                                   const void* b_l, const void* X, const void* obs_w,
                                   void* X_new, int K, int L, void* stream) {
    if (K < 1 || L < 1) return (int)cudaErrorInvalidValue;
    observed_update_kernel<<<(L + WL - 1) / WL, WT, 0, (cudaStream_t)stream>>>(
        (const float*)W, (const float*)dp, (const float*)Hll_inv, (const float*)b_l,
        (const float*)X, (const float*)obs_w, (float*)X_new, K, L);
    return (int)cudaGetLastError();
}
