// K1: window scoring for temporal tracking.
//
// Replaces the TPU kernel svi_mapper_tpu/ops/track_kernel.py track_scores
// (_kernel / _score_window). Loading and popcounting every pixel of every
// landmark's 41x57 window (two 16-byte loads and 16 popcounts each) is what
// costs; this design loads and scores only the pixels a tier can accept.
//
// One block of four warps per landmark. Each thread rounds the landmark's
// prediction (nan_to_num, round half to even, clamp in float, then the
// cast: round_pixel.cuh, the rule of ops/track_kernel.py:window_origin)
// and clamps the 41x57 window's origin. Only the tier-1 box (|dx|,
// |dy| <= 8) and the tier-2 band (|c0q + nxq*dx + nyq*dy| <= 640 within
// the (ru, rv) reach) accept a pixel; everywhere else the score is 4096
// whatever the descriptor. So in the first warp each lane takes a window
// row (two passes for 41 rows),
// works out the row's column interval of the box and of the band
// (ops/track_kernel.py:tier_row_intervals restates this in Python), merges
// them where they touch, and a warp scan of the interval lengths lists the
// window's candidate pixels in shared memory. All threads then stride over
// that list, four pixels at a time: a binary search over the rows' start
// offsets maps a list index back to (row, column), each pixel's 8
// descriptor words are two 16-byte loads, XOR-popcounted against the
// landmark's last and anchor descriptors held in registers. The three-tier
// acceptance of ops/track_kernel.py:tier_scores is restated in integers,
// the key is score * 4096 + window-local row-major position, and the block
// reduces the key by min, so equal scores resolve to the first pixel in
// row-major order. (One warp per landmark leaves too few warps on the card
// to hide the loads' latency.)
//
// Every pixel that is not listed has the key 4096 * 4096 + its position,
// so the min over the whole window is the min over the listed pixels and
// 4096 * 4096 + 0 (position 0 is the smallest such key): the reduction
// starts from that. A landmark that accepts nothing thus returns position 0,
// as the plain version does.
//
// The band arithmetic is exact for the parameters epipolar_band_params
// makes (|nxq|, |nyq| <= 256, |c0q| <= 2^20): no int32 sum here or in the
// plain version wraps.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "round_pixel.cuh"

namespace {

constexpr int WIN_W = 57;
constexpr int WIN_H = 41;
constexpr int REACH_X = 28;
constexpr int REACH_Y = 20;
constexpr int BOX = 8;                  // tier-1 half width
constexpr int BAND_HALF_WIDTH_Q = 640;
constexpr int BIG_K = 4096;
constexpr int BIG = 1 << 20;
constexpr int THREADS = 128;            // one block per landmark
constexpr int UNROLL = 4;               // pixels a thread loads at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int hamming8(const uint4& p0, const uint4& p1,
                                        const uint4& d0, const uint4& d1) {
    return __popc(p0.x ^ d0.x) + __popc(p0.y ^ d0.y) + __popc(p0.z ^ d0.z) +
           __popc(p0.w ^ d0.w) + __popc(p1.x ^ d1.x) + __popc(p1.y ^ d1.y) +
           __popc(p1.z ^ d1.z) + __popc(p1.w ^ d1.w);
}

// a / b rounded toward -inf and toward +inf (b != 0); C++ `/` truncates
__device__ __forceinline__ int floor_div(int a, int b) {
    const int q = a / b;
    return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

__global__ void __launch_bounds__(THREADS) track_scores_kernel(
    const uint4* __restrict__ field,      // [H, W, 2] uint4 (8 words/pixel)
    const float2* __restrict__ uv,        // [L] predictions
    const int* __restrict__ band,         // [5, L]: nxq, nyq, c0q, ru, rv
    const uint4* __restrict__ desc_last,  // [L, 2] uint4
    const uint4* __restrict__ desc_ref,   // [L, 2] uint4
    int* __restrict__ out,                // [4, L]: score, x, y, dist
    int L, int H, int W, int cutoff_s1, int cutoff_s2, int cutoff_ref) {
    // where each row's pixels start in the list (rows past the window hold
    // INT_MAX), the row's one or two column intervals, the list's length
    __shared__ int row_start[64];
    __shared__ int lo0_s[WIN_H];
    __shared__ int len0_s[WIN_H];
    __shared__ int lo1_s[WIN_H];
    __shared__ int total_s;
    __shared__ int warp_best[THREADS / 32];

    const int l = blockIdx.x;
    const int tid = threadIdx.x;
    const float2 p = uv[l];
    const int ul = pixel_index(p.x, W - 1);
    const int vl = pixel_index(p.y, H - 1);
    const int x0 = min(max(ul - REACH_X, 0), W - WIN_W);
    const int y0 = min(max(vl - REACH_Y, 0), H - WIN_H);
    const int nx = band[l], ny = band[L + l], c0 = band[2 * L + l];
    const int rul = band[3 * L + l], rvl = band[4 * L + l];

    if (tid < 32) {                       // the first warp lists the pixels
        const int lane = tid;
        const int off = ul - x0;          // window column of dx = 0
        int total = 0;
        for (int half = 0; half < 2; ++half) {
            const int r = lane + 32 * half;
            int lo0 = 1, hi0 = 0, lo1 = 1, hi1 = 0;   // empty
            if (r < WIN_H) {
                const int dy = y0 + r - vl;
                if (abs(dy) <= BOX) { lo0 = -BOX; hi0 = BOX; }
                if (abs(dy) <= rvl) {
                    const int s = c0 + ny * dy;
                    if (nx > 0) {
                        lo1 = ceil_div(-BAND_HALF_WIDTH_Q - s, nx);
                        hi1 = floor_div(BAND_HALF_WIDTH_Q - s, nx);
                    } else if (nx < 0) {
                        lo1 = ceil_div(BAND_HALF_WIDTH_Q - s, nx);
                        hi1 = floor_div(-BAND_HALF_WIDTH_Q - s, nx);
                    } else if (abs(s) <= BAND_HALF_WIDTH_Q) {
                        lo1 = -rul;
                        hi1 = rul;
                    }
                    lo1 = max(lo1, -rul);
                    hi1 = min(hi1, rul);
                }
                // dx -> window column, clipped to the window
                lo0 = max(lo0 + off, 0);
                hi0 = min(hi0 + off, WIN_W - 1);
                lo1 = max(lo1 + off, 0);
                hi1 = min(hi1 + off, WIN_W - 1);
                if (hi0 < lo0) { lo0 = lo1; hi0 = hi1; lo1 = 1; hi1 = 0; }
                if (hi1 >= lo1 && lo1 <= hi0 + 1 && lo0 <= hi1 + 1) {   // they touch
                    lo0 = min(lo0, lo1);
                    hi0 = max(hi0, hi1);
                    lo1 = 1;
                    hi1 = 0;
                }
            }
            const int len0 = max(hi0 - lo0 + 1, 0);
            const int n = len0 + max(hi1 - lo1 + 1, 0);
            int inc = n;                  // inclusive scan over the lanes
            for (int o = 1; o < 32; o <<= 1) {
                const int t = __shfl_up_sync(FULL, inc, o);
                if (lane >= o) inc += t;
            }
            row_start[r] = r < WIN_H ? total + inc - n : 0x7fffffff;
            if (r < WIN_H) {
                lo0_s[r] = lo0;
                len0_s[r] = len0;
                lo1_s[r] = lo1;
            }
            total += __shfl_sync(FULL, inc, 31);
        }
        if (lane == 0) total_s = total;
    }
    __syncthreads();

    const int total = total_s;
    const uint4 a0 = desc_last[2 * l], a1 = desc_last[2 * l + 1];
    const uint4 b0 = desc_ref[2 * l], b1 = desc_ref[2 * l + 1];
    const size_t pitch = (size_t)W * 2;   // uint4 per field row

    int best = BIG_K * BIG_K;             // position 0, not accepted
    for (int base = 0; base < total; base += THREADS * UNROLL) {
        uint4 w0[UNROLL], w1[UNROLL];
        int pos[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            const int i = min(base + THREADS * k + tid, total - 1);
            int r = 0;                    // the last row starting at or before i
#pragma unroll
            for (int step = 32; step > 0; step >>= 1)
                if (row_start[r + step] <= i) r += step;
            const int t = i - row_start[r];
            const int len0 = len0_s[r];
            const int c = t < len0 ? lo0_s[r] + t : lo1_s[r] + (t - len0);
            pos[k] = r * WIN_W + c;
            const uint4* px = field + (size_t)(y0 + r) * pitch + (size_t)(x0 + c) * 2;
            w0[k] = __ldg(px);
            w1[k] = __ldg(px + 1);
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            if (base + THREADS * k + tid >= total) break;
            const int r = pos[k] / WIN_W;
            const int dx = x0 + (pos[k] - r * WIN_W) - ul;
            const int dy = y0 + r - vl;
            const int adx = abs(dx);
            const int ady = abs(dy);
            const int d1 = hamming8(w0[k], w1[k], a0, a1);
            const int d2 = hamming8(w0[k], w1[k], b0, b1);
            int score = BIG_K;
            if (d2 <= cutoff_ref) {
                const bool ok2 = d1 <= cutoff_s2;
                const bool on_band = abs(c0 + nx * dx + ny * dy) <= BAND_HALF_WIDTH_Q;
                if (on_band && adx <= rul && ady <= rvl && ok2) score = d1 + 2000;
                if (adx <= BOX && ady <= BOX && ok2) score = min(score, d1 + 1000);
                if (adx <= 1 && ady <= 1 && d1 <= cutoff_s1) score = min(score, d1);
            }
            best = min(best, score * BIG_K + pos[k]);
        }
    }

    for (int o = 16; o > 0; o >>= 1)
        best = min(best, __shfl_down_sync(FULL, best, o));
    if ((tid & 31) == 0) warp_best[tid >> 5] = best;
    __syncthreads();
    if (tid == 0) {
        int key = warp_best[0];
        for (int i = 1; i < THREADS / 32; ++i) key = min(key, warp_best[i]);
        int s = key / BIG_K;
        const int rel = key % BIG_K;
        if (s >= BIG_K) s = BIG;
        out[l] = s;
        out[L + l] = x0 + rel % WIN_W;
        out[2 * L + l] = y0 + rel / WIN_W;
        out[3 * L + l] = s % 1000;
    }
}

}  // namespace

extern "C" int svi_track_scores(
    const void* field, const void* uv, const void* band, const void* desc_last,
    const void* desc_ref, void* out, int L, int H, int W, int cutoff_s1,
    int cutoff_s2, int cutoff_ref, void* stream) {
    track_scores_kernel<<<L, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)field, (const float2*)uv, (const int*)band,
        (const uint4*)desc_last, (const uint4*)desc_ref, (int*)out, L, H, W,
        cutoff_s1, cutoff_s2, cutoff_ref);
    return (int)cudaGetLastError();
}
