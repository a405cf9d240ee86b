// K1: dense window scoring for temporal tracking.
//
// One block per landmark. Threads stride over the 41x57 window around the
// landmark's rounded prediction; each pixel's 8 descriptor words are two
// 16-byte loads, XOR-popcounted against the landmark's last and anchor
// descriptors held in registers. The three-tier acceptance of
// ops/track_kernel.py:tier_scores is restated in integers, the per-pixel
// key is score * 4096 + window-local row-major position, and the block
// reduces the key by min, so equal scores resolve to the first pixel in
// row-major order. Rounding of the prediction and clamping of the window
// origin are done by the caller (u, v, x0, y0 are given).
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN_W = 57;
constexpr int WIN_H = 41;
constexpr int WIN_N = WIN_W * WIN_H;
constexpr int BAND_HALF_WIDTH_Q = 640;
constexpr int BIG_K = 4096;
constexpr int BIG = 1 << 20;
constexpr int THREADS = 128;

__device__ __forceinline__ int hamming8(const uint4& p0, const uint4& p1,
                                        const uint4& d0, const uint4& d1) {
    return __popc(p0.x ^ d0.x) + __popc(p0.y ^ d0.y) + __popc(p0.z ^ d0.z) +
           __popc(p0.w ^ d0.w) + __popc(p1.x ^ d1.x) + __popc(p1.y ^ d1.y) +
           __popc(p1.z ^ d1.z) + __popc(p1.w ^ d1.w);
}

__global__ void __launch_bounds__(THREADS) track_scores_kernel(
    const uint4* __restrict__ field,      // [H, W, 2] uint4 (8 words/pixel)
    const int* __restrict__ u, const int* __restrict__ v,
    const int* __restrict__ x0, const int* __restrict__ y0,
    const int* __restrict__ nxq, const int* __restrict__ nyq,
    const int* __restrict__ c0q, const int* __restrict__ ru,
    const int* __restrict__ rv,
    const uint4* __restrict__ desc_last,  // [L, 2] uint4
    const uint4* __restrict__ desc_ref,   // [L, 2] uint4
    int* __restrict__ out_score, int* __restrict__ out_x,
    int* __restrict__ out_y, int* __restrict__ out_dist,
    int W, int cutoff_s1, int cutoff_s2, int cutoff_ref) {
    const int l = blockIdx.x;
    const int ul = u[l], vl = v[l], x0l = x0[l], y0l = y0[l];
    const int nx = nxq[l], ny = nyq[l], c0 = c0q[l];
    const int rul = ru[l], rvl = rv[l];
    const uint4 a0 = desc_last[2 * l], a1 = desc_last[2 * l + 1];
    const uint4 b0 = desc_ref[2 * l], b1 = desc_ref[2 * l + 1];
    const size_t pitch = (size_t)W * 2;   // uint4 per field row

    int best = 0x7fffffff;
    for (int p = threadIdx.x; p < WIN_N; p += THREADS) {
        const int r = p / WIN_W;
        const int c = p - r * WIN_W;
        const int y = y0l + r;
        const int x = x0l + c;
        const uint4* px = field + (size_t)y * pitch + (size_t)x * 2;
        const uint4 w0 = __ldg(px);
        const uint4 w1 = __ldg(px + 1);
        const int d1 = hamming8(w0, w1, a0, a1);
        const int d2 = hamming8(w0, w1, b0, b1);
        const int dx = x - ul;
        const int dy = y - vl;
        const int adx = abs(dx);
        const int ady = abs(dy);
        int score = BIG_K;
        if (d2 <= cutoff_ref) {
            const bool ok2 = d1 <= cutoff_s2;
            const bool on_band = abs(c0 + nx * dx + ny * dy) <= BAND_HALF_WIDTH_Q;
            if (on_band && adx <= rul && ady <= rvl && ok2) score = d1 + 2000;
            if (adx <= 8 && ady <= 8 && ok2) score = min(score, d1 + 1000);
            if (adx <= 1 && ady <= 1 && d1 <= cutoff_s1) score = min(score, d1);
        }
        best = min(best, score * BIG_K + p);
    }

    for (int o = 16; o > 0; o >>= 1)
        best = min(best, __shfl_down_sync(0xffffffffu, best, o));
    __shared__ int warp_best[THREADS / 32];
    if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        int key = warp_best[0];
        for (int i = 1; i < THREADS / 32; ++i) key = min(key, warp_best[i]);
        int s = key / BIG_K;
        const int rel = key % BIG_K;
        if (s >= BIG_K) s = BIG;
        out_score[l] = s;
        out_x[l] = x0l + rel % WIN_W;
        out_y[l] = y0l + rel / WIN_W;
        out_dist[l] = s % 1000;
    }
}

}  // namespace

extern "C" int svi_track_scores(
    const void* field, const void* u, const void* v, const void* x0,
    const void* y0, const void* nxq, const void* nyq, const void* c0q,
    const void* ru, const void* rv, const void* desc_last,
    const void* desc_ref, void* out_score, void* out_x, void* out_y,
    void* out_dist, int L, int H, int W, int cutoff_s1, int cutoff_s2,
    int cutoff_ref, void* stream) {
    (void)H;
    track_scores_kernel<<<L, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)field, (const int*)u, (const int*)v, (const int*)x0,
        (const int*)y0, (const int*)nxq, (const int*)nyq, (const int*)c0q,
        (const int*)ru, (const int*)rv, (const uint4*)desc_last,
        (const uint4*)desc_ref, (int*)out_score, (int*)out_x, (int*)out_y,
        (int*)out_dist, W, cutoff_s1, cutoff_s2, cutoff_ref);
    return (int)cudaGetLastError();
}
