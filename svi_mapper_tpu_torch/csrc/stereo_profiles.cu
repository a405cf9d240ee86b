// K2: stereo scanline Hamming profiles, and the fused scanline match.
//
// Replaces the TPU kernel svi_mapper_tpu/ops/stereo_kernel.py
// stereo_profiles (_kernel). For each left keypoint k the De candidate
// pixels of row v of the RIGHT dense field, from column x0 on, are scored
// against the keypoint's descriptor; index i of the profile is column
// x0 + (De-1) - i, so disparity ascends with i. Each thread rounds the
// keypoint itself (round_pixel.cuh: NaN map, round half to even, float
// clamp, cast) and clamps the span origin, the rule of
// ops/stereo_kernel.py:span_origin.
//
// What bounds it on the card: the 4 KB span of each keypoint (De = 128
// pixels of 32 bytes) is read once; at K = 1024 that is 4.2 MB, against
// ~24 integer operations per candidate. Bytes bound it, and the span is
// one dependent load away from the keypoint, so latency is what a design
// has to hide. One warp scores one keypoint: the span is 2 De contiguous
// 16-byte words, and word q goes to lane q % 32, so every load instruction
// of the warp reads 512 contiguous bytes. A lane starts all of its loads
// (eight at De = 128, the span length being a template parameter) before
// its first popcount; the two lanes of a pixel each XOR-popcount one half
// of the descriptor and add the halves by a shuffle.
//
// Two entries share that scoring core:
//   * svi_stereo_profiles writes the [K, De] profile, u_r and x0 (the TPU
//     kernel's function);
//   * svi_stereo_match applies frontend/stereo.py:match_stereo's candidate
//     masks in the kernel, on float32 values as PyTorch computes them (the
//     disparity base + i, >= min_disparity, <= the keypoint's float u,
//     <= De - 1 and, when a centre is given, |d - centre| <= range), keeps
//     the masked profile in shared memory, reduces the span to its first
//     masked minimum by a warp shuffle over the key (min(dist, 257) << 16 | i)
//     (a tie goes to the lower i, as torch.min and jnp.argmin break it) and
//     writes per keypoint only the integers [6, K]: best, best_dist, the
//     neighbours' masked distances dm and dp (clamped to the span, 1 << 20
//     where masked), u_r and x0. The profile never leaves the SM.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "round_pixel.cuh"

namespace {

constexpr int WARPS = 4;                // keypoints per block
constexpr int BATCH = 8;                // loads a lane starts before scoring
constexpr int BIG = 1 << 20;            // frontend/stereo.py _BIG
constexpr int KEY_BIG = 257;            // a masked candidate in the key
constexpr unsigned FULL = 0xffffffffu;

struct Span {
    int u_r, x0;
    const uint4* row;                   // the span's first 16-byte word
};

__device__ __forceinline__ Span span_of(const uint4* field, float2 p, int H,
                                        int W, int De) {
    Span s;
    s.u_r = pixel_index(p.x, W - 1);
    const int v = pixel_index(p.y, H - 1);
    s.x0 = min(max(s.u_r - (De - 1), 0), W - De);
    s.row = field + ((size_t)v * W + s.x0) * 2;
    return s;
}

// Scores the span: emit(i, dist) for every candidate i, on both lanes of
// the candidate's pixel. DE > 0 fixes the span length at compile time; 0
// reads it from De.
template <int DE, typename Emit>
__device__ __forceinline__ void score_span(const uint4* row, uint4 dh, int De,
                                           int lane, Emit emit) {
    const int words = 2 * (DE > 0 ? DE : De);
    const int loads = (words + 31) / 32;
    for (int t0 = 0; t0 < loads; t0 += BATCH) {
        uint4 w[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int q = (t0 + b) * 32 + lane;
            w[b] = q < words ? __ldg(row + q) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int half = __popc(w[b].x ^ dh.x) + __popc(w[b].y ^ dh.y) +
                             __popc(w[b].z ^ dh.z) + __popc(w[b].w ^ dh.w);
            const int dist = half + __shfl_xor_sync(FULL, half, 1);
            const int q = (t0 + b) * 32 + lane;
            if (q < words) emit(words / 2 - 1 - q / 2, dist);
        }
    }
}

template <int DE>
__global__ void __launch_bounds__(WARPS * 32) stereo_profiles_kernel(
    const uint4* __restrict__ field,   // [H, W, 2] uint4 (8 words/pixel)
    const float2* __restrict__ uv,     // [K] left keypoints
    const uint4* __restrict__ desc,    // [K, 2] uint4
    int* __restrict__ profile,         // [K, De]
    int* __restrict__ u_r_out, int* __restrict__ x0_out,   // [K]
    int K, int De, int H, int W) {
    const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (k >= K) return;
    const int lane = threadIdx.x & 31;
    const Span s = span_of(field, uv[k], H, W, De);
    int* o = profile + (size_t)k * De;
    score_span<DE>(s.row, desc[2 * k + (lane & 1)], De, lane,
                   [&](int i, int dist) { if (!(lane & 1)) o[i] = dist; });
    if (lane == 0) {
        u_r_out[k] = s.u_r;
        x0_out[k] = s.x0;
    }
}

template <int DE>
__global__ void __launch_bounds__(WARPS * 32) stereo_match_kernel(
    const uint4* __restrict__ field, const float2* __restrict__ uv,
    const uint4* __restrict__ desc,
    const float* __restrict__ center,  // [K] or null: no range mask
    const float* __restrict__ range,   // [K] or null: 60 px (with a centre)
    int* __restrict__ out,             // [6, K]: best, best_dist, dm, dp, u_r, x0
    int K, int De, int H, int W, float min_disparity) {
    extern __shared__ int masked[];    // [WARPS, De]
    const int warp = threadIdx.x >> 5;
    const int k = blockIdx.x * WARPS + warp;
    if (k >= K) return;
    const int lane = threadIdx.x & 31;
    const float2 p = uv[k];
    const Span s = span_of(field, p, H, W, De);
    const float base = (float)(s.u_r - s.x0 - (De - 1));
    const float top = (float)(De - 1);
    const bool ranged = center != nullptr;
    const float c = ranged ? center[k] : 0.0f;
    const float r = ranged ? (range != nullptr ? range[k] : 60.0f) : 0.0f;
    int* m = masked + warp * De;
    unsigned best_key = 0xffffffffu;
    score_span<DE>(s.row, desc[2 * k + (lane & 1)], De, lane, [&](int i, int dist) {
        const float d = base + (float)i;
        const bool ok = d >= min_disparity && d <= p.x && d <= top &&
                        (!ranged || fabsf(d - c) <= r);
        const int v = ok ? dist : BIG;
        if (!(lane & 1)) m[i] = v;
        best_key = min(best_key, ((unsigned)min(v, KEY_BIG) << 16) | (unsigned)i);
    });
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        best_key = min(best_key, __shfl_xor_sync(FULL, best_key, o));
    __syncwarp();
    if (lane == 0) {
        const int best = (int)(best_key & 0xffffu);
        const int kd = (int)(best_key >> 16);
        out[k] = best;
        out[K + k] = kd == KEY_BIG ? BIG : kd;
        out[2 * K + k] = m[max(best - 1, 0)];
        out[3 * K + k] = m[min(best + 1, De - 1)];
        out[4 * K + k] = s.u_r;
        out[5 * K + k] = s.x0;
    }
}

}  // namespace

extern "C" int svi_stereo_profiles(const void* field, const void* uv,
                                   const void* desc, void* profile, void* u_r,
                                   void* x0, int K, int De, int H, int W,
                                   void* stream) {
    const int blocks = (K + WARPS - 1) / WARPS;
    auto kernel = De == 128 ? stereo_profiles_kernel<128> : stereo_profiles_kernel<0>;
    kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint4*)field, (const float2*)uv, (const uint4*)desc, (int*)profile,
        (int*)u_r, (int*)x0, K, De, H, W);
    return (int)cudaGetLastError();
}

extern "C" int svi_stereo_match(const void* field, const void* uv, const void* desc,
                                const void* center, const void* range, void* out,
                                int K, int De, int H, int W, float min_disparity,
                                void* stream) {
    const int blocks = (K + WARPS - 1) / WARPS;
    auto kernel = De == 128 ? stereo_match_kernel<128> : stereo_match_kernel<0>;
    kernel<<<blocks, WARPS * 32, WARPS * De * sizeof(int), (cudaStream_t)stream>>>(
        (const uint4*)field, (const float2*)uv, (const uint4*)desc,
        (const float*)center, (const float*)range, (int*)out, K, De, H, W,
        min_disparity);
    return (int)cudaGetLastError();
}
