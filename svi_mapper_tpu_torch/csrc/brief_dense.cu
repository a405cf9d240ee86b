// K3: fused 5x5 box blur + dense BRIEF field.
//
// One block per TH x TW output tile. The raw tile plus a 17 px halo
// (15 px pattern reach + 2 px blur reach) is staged edge-clamped in shared
// memory; the separable blur runs there (rows axis first, then columns;
// taps in ascending order starting from 0, multiply and add rounded
// separately with __fmul_rn/__fadd_rn so the compiler cannot contract them
// into an FMA); then each thread compares its pixels' 256 sample pairs and
// writes 8 packed words with two 16-byte stores.
//
// Border semantics equal blur-then-describe on the whole image: a blurred
// value at a coordinate outside the image is the blurred value at the
// clamped coordinate, and the blur at a border pixel reads the raw image
// edge-clamped. The centre of each blur window is therefore clamped first,
// and its taps are then read from the edge-clamped raw tile.
//
// The pattern (256 x (ay, ax, by, bx) offsets in [-15, 15]) is handed in by
// the caller, who generates it from the same seed as the reference.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;
constexpr int TW = 64;
constexpr int REACH = 15;             // pattern reach
constexpr int HALO = REACH + 2;       // + blur radius
constexpr int RAW_H = TH + 2 * HALO;  // 50
constexpr int RAW_W = TW + 2 * HALO;  // 98
constexpr int BL_H = TH + 2 * REACH;  // 46
constexpr int BL_W = TW + 2 * REACH;  // 94
constexpr int THREADS = 256;
constexpr int BITS = 256;

__global__ void __launch_bounds__(THREADS) brief_dense_kernel(
    const float* __restrict__ img,     // [H, W]
    const int* __restrict__ pattern,   // [256, 4] (ay, ax, by, bx)
    uint4* __restrict__ out,           // [H, W, 2] uint4
    int H, int W) {
    __shared__ float raw[RAW_H * RAW_W];   // later reused for the blur
    __shared__ float tmp[BL_H * RAW_W];
    __shared__ int off_a[BITS];
    __shared__ int off_b[BITS];

    const int tx0 = blockIdx.x * TW;
    const int ty0 = blockIdx.y * TH;
    const int tid = threadIdx.x;

    for (int i = tid; i < BITS; i += THREADS) {
        off_a[i] = pattern[4 * i + 0] * BL_W + pattern[4 * i + 1];
        off_b[i] = pattern[4 * i + 2] * BL_W + pattern[4 * i + 3];
    }
    // raw tile, edge-clamped: raw[i][j] = img[clamp(ty0-17+i)][clamp(tx0-17+j)]
    for (int idx = tid; idx < RAW_H * RAW_W; idx += THREADS) {
        const int i = idx / RAW_W;
        const int j = idx - i * RAW_W;
        const int gy = min(max(ty0 - HALO + i, 0), H - 1);
        const int gx = min(max(tx0 - HALO + j, 0), W - 1);
        raw[idx] = __ldg(img + (size_t)gy * W + gx);
    }
    __syncthreads();

    const float k = 0.2f;   // float32(1/5), each tap of the 5-wide box
    // pass 1 (rows axis): tmp[r][j] = blur over rows at (clamp(gy), column j)
    for (int idx = tid; idx < BL_H * RAW_W; idx += THREADS) {
        const int r = idx / RAW_W;
        const int j = idx - r * RAW_W;
        const int gyc = min(max(ty0 - REACH + r, 0), H - 1);
        const int ic = gyc - (ty0 - HALO);
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < 5; ++t)
            acc = __fadd_rn(acc, __fmul_rn(raw[(ic - 2 + t) * RAW_W + j], k));
        tmp[idx] = acc;
    }
    __syncthreads();

    // pass 2 (columns axis): blur[r][c] at (., clamp(gx)); written over raw
    float* blur = raw;
    for (int idx = tid; idx < BL_H * BL_W; idx += THREADS) {
        const int r = idx / BL_W;
        const int c = idx - r * BL_W;
        const int gxc = min(max(tx0 - REACH + c, 0), W - 1);
        const int jc = gxc - (tx0 - HALO);
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < 5; ++t)
            acc = __fadd_rn(acc, __fmul_rn(tmp[r * RAW_W + jc - 2 + t], k));
        blur[idx] = acc;
    }
    __syncthreads();

    for (int pid = tid; pid < TH * TW; pid += THREADS) {
        const int py = pid / TW;
        const int px = pid - py * TW;
        const int gy = ty0 + py;
        const int gx = tx0 + px;
        if (gy >= H || gx >= W) continue;
        const float* base = blur + (py + REACH) * BL_W + (px + REACH);
        uint32_t words[8];
#pragma unroll
        for (int wi = 0; wi < 8; ++wi) {
            uint32_t word = 0;
#pragma unroll 8
            for (int bi = 0; bi < 32; ++bi) {
                const int i = wi * 32 + bi;
                word |= (uint32_t)(base[off_a[i]] < base[off_b[i]]) << bi;
            }
            words[wi] = word;
        }
        uint4* o = out + ((size_t)gy * W + gx) * 2;
        o[0] = make_uint4(words[0], words[1], words[2], words[3]);
        o[1] = make_uint4(words[4], words[5], words[6], words[7]);
    }
}

}  // namespace

extern "C" int svi_brief_dense_fused(const void* img, const void* pattern,
                                     void* out, int H, int W, void* stream) {
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    brief_dense_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const int*)pattern, (uint4*)out, H, W);
    return (int)cudaGetLastError();
}
