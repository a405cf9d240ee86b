// K2: stereo scanline Hamming profiles.
//
// One warp per left keypoint. The keypoint's descriptor sits in registers;
// lanes stride over the De candidate columns of row v of the RIGHT dense
// field, each candidate being two 16-byte loads, and write the profile in
// reversed column order: out[k, i] is the distance at column
// x0[k] + (De-1) - i, so disparity ascends with i. The caller rounds the
// keypoint and clamps the span origin (v, x0 are given).
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32) stereo_profiles_kernel(
    const uint4* __restrict__ field,   // [H, W, 2] uint4 (8 words/pixel)
    const int* __restrict__ v, const int* __restrict__ x0,
    const uint4* __restrict__ desc,    // [K, 2] uint4
    int* __restrict__ out,             // [K, De]
    int K, int De, int W) {
    const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (k >= K) return;
    const int lane = threadIdx.x & 31;
    const uint4 d0 = desc[2 * k], d1 = desc[2 * k + 1];
    const uint4* row = field + ((size_t)v[k] * W + x0[k]) * 2;
    int* o = out + (size_t)k * De;
    for (int i = lane; i < De; i += 32) {
        const uint4* px = row + (size_t)(De - 1 - i) * 2;
        const uint4 w0 = __ldg(px);
        const uint4 w1 = __ldg(px + 1);
        o[i] = __popc(w0.x ^ d0.x) + __popc(w0.y ^ d0.y) +
               __popc(w0.z ^ d0.z) + __popc(w0.w ^ d0.w) +
               __popc(w1.x ^ d1.x) + __popc(w1.y ^ d1.y) +
               __popc(w1.z ^ d1.z) + __popc(w1.w ^ d1.w);
    }
}

}  // namespace

extern "C" int svi_stereo_profiles(const void* field, const void* v,
                                   const void* x0, const void* desc,
                                   void* out, int K, int De, int W,
                                   void* stream) {
    const int blocks = (K + WARPS - 1) / WARPS;
    stereo_profiles_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint4*)field, (const int*)v, (const int*)x0,
        (const uint4*)desc, (int*)out, K, De, W);
    return (int)cudaGetLastError();
}
