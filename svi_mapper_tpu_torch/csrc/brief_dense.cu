// K3: fused 5x5 box blur + dense BRIEF field.
//
// Replaces the TPU kernel svi_mapper_tpu/ops/descriptors.py
// brief_dense_fused (_brief_dense_kernel). What limits it on the card is the
// issue of shared-memory loads (one warp-wide load per clock and SM), not
// the 17 MB it must move; the design cuts the loads per pixel.
//
// One block per TILE_H x TILE_W output tile. The raw tile plus a 17 px halo
// (15 px pattern reach + 2 px blur reach) is staged edge-clamped in shared
// memory; the separable blur runs there (rows axis first, then columns;
// taps in ascending order starting from 0, multiply and add rounded
// separately with __fmul_rn/__fadd_rn so the compiler cannot contract them
// into an FMA). Then each thread owns ROWS pixels stacked in one column (a
// warp: 32 neighbouring columns, so every sample load is conflict-free).
// The pattern is a compile-time table (brief_pattern.cuh): all ROWS * 256
// comparisons are unrolled, each sample is a load at an immediate offset
// from one base address, and a sample that several bits or several of the
// thread's pixels need is loaded once (172.75 loads per pixel at ROWS = 4,
// against 512 samples and 512 offset loads of a pattern held in memory).
// The comparisons run in the table's ORDER, which keeps few samples held
// between their first and last use. Each pixel's 8 words go out in two
// 16-byte stores.
//
// Border semantics equal blur-then-describe on the whole image: a blurred
// value at a coordinate outside the image is the blurred value at the
// clamped coordinate, and the blur at a border pixel reads the raw image
// edge-clamped. The centre of each blur window is therefore clamped first,
// and its taps are then read from the edge-clamped raw tile.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "brief_pattern.cuh"

namespace {

constexpr int TH = brief::TILE_H;
constexpr int TW = brief::TILE_W;
constexpr int ROWS = brief::ROWS;
constexpr int REACH = 15;             // pattern reach
constexpr int HALO = REACH + 2;       // + blur radius
constexpr int RAW_H = TH + 2 * HALO;
constexpr int RAW_W = TW + 2 * HALO;
constexpr int BL_H = TH + 2 * REACH;
constexpr int BL_W = TW + 2 * REACH;
constexpr int THREADS = 256;
constexpr int STACKS = THREADS / TW;  // column stacks of ROWS pixels at once
constexpr int PASSES = TH / (STACKS * ROWS);
constexpr int BITS = 256;
// raw tile, then the rows-axis pass; the blur is written over the raw tile
constexpr int SMEM_BYTES = (RAW_H * RAW_W + BL_H * RAW_W) * (int)sizeof(float);

static_assert(THREADS % TW == 0 && TW % 32 == 0, "a warp spans one row of a stack");
static_assert(TH % (STACKS * ROWS) == 0, "stacks tile the block's rows");

// comparison K of the order: bit `bit` of the thread's pixel `j`
template <int K>
__device__ __forceinline__ void compare(const float* p, uint32_t (&w)[ROWS][8]) {
    constexpr int e = brief::order(K);
    constexpr int bit = e / ROWS;
    constexpr int j = e % ROWS;
    constexpr int oa = (brief::pattern(bit, 0) + j) * BL_W + brief::pattern(bit, 1);
    constexpr int ob = (brief::pattern(bit, 2) + j) * BL_W + brief::pattern(bit, 3);
    if (p[oa] < p[ob]) w[j][bit >> 5] |= 1u << (bit & 31);
}

template <int... K>
__device__ __forceinline__ void compare_all(const float* p, uint32_t (&w)[ROWS][8],
                                            std::integer_sequence<int, K...>) {
    (compare<K>(p, w), ...);
}

__global__ void __launch_bounds__(THREADS) brief_dense_kernel(
    const float* __restrict__ img,     // [H, W]
    uint4* __restrict__ out,           // [H, W, 2] uint4
    int H, int W) {
    extern __shared__ float smem[];
    float* raw = smem;                     // RAW_H x RAW_W, later the blur
    float* tmp = smem + RAW_H * RAW_W;     // BL_H x RAW_W

    const int tx0 = blockIdx.x * TW;
    const int ty0 = blockIdx.y * TH;
    const int tid = threadIdx.x;

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

    const int px = tid % TW;
    const int gx = tx0 + px;
    for (int pass = 0; pass < PASSES; ++pass) {
        const int py = (pass * STACKS + tid / TW) * ROWS;
        uint32_t w[ROWS][8] = {};
        compare_all(blur + (py + REACH) * BL_W + (px + REACH), w,
                    std::make_integer_sequence<int, ROWS * BITS>{});
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            const int gy = ty0 + py + j;
            if (gy >= H || gx >= W) continue;
            uint4* o = out + ((size_t)gy * W + gx) * 2;
            o[0] = make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
            o[1] = make_uint4(w[j][4], w[j][5], w[j][6], w[j][7]);
        }
    }
}

}  // namespace

extern "C" int svi_brief_dense_fused(const void* img, void* out, int H, int W,
                                     void* stream) {
    // the tile takes more than the 48 KB of shared memory a block gets
    // without asking
    cudaError_t err = cudaFuncSetAttribute(
        brief_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    brief_dense_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const float*)img, (uint4*)out, H, W);
    return (int)cudaGetLastError();
}
