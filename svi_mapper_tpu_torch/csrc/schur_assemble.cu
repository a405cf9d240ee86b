// K4 and K5: fused Schur-complement assembly for bundle adjustment.
//
// Replaces the TPU kernels schur_assemble (K4, K <= 32 keyframes) and
// schur_assemble_tiled (K5, tiles of 32 keyframes) of
// svi_mapper_tpu/ops/ba_kernel.py; the contract and the plain PyTorch
// versions are in ops/ba_kernel.py of this package.
//
// Both kernels share one device function, accumulate_block: a block owns 32
// landmarks (one per lane) and up to 32 keyframes (warp w takes keyframes
// w, w + 8, ...). Per (keyframe, landmark) the camera-frame point, the four
// stereo residuals, the robust weight and the sqrt-weighted Jacobian rows
// live in registers and are never written out. What leaves the function:
//   * the 18 entries of the W planes, to global memory (and, for K4, to a
//     shared-memory tile);
//   * the keyframe's 21 + 6 numbers of H_pp and b_p, summed over the warp's
//     32 landmarks by shuffles and written as this block's partial;
//   * the landmark's partial H_ll upper triangle and b_l, summed over the
//     block's keyframes through shared memory in warp order.
//
// K4 then inverts the damped 3x3 block per landmark, forms the planes
// C = W Hll^-1 in shared memory and multiplies C W^T over its 32 landmarks
// with a 16 x 16 thread grid, each thread holding up to 12 x 12 float32 sums
// in registers (shared-memory operands, FFMA). A second kernel adds the
// per-block partials in block order: no atomics, so the result is the same
// from run to run. K5 stops after the per-tile outputs; the product over the
// whole window is left to the caller, as in the TPU kernel.
//
// What bounds them on an H100: K4 at K = 32, L = 4096 needs 0.55 GFLOP (0.47
// of it the upper block triangle of the symmetric product; the kernel forms
// all of it, 0.99 GFLOP) against 12.4 MB of traffic: operations, 8 us. K5
// at K = 128 moves ~49 MB (the W planes) for ~0.3 GFLOP: bytes, 15 us.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TL = 32;                 // landmarks per block, one per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KT = 32;                 // keyframes per block
constexpr int K6MAX = 6 * KT;          // 192 rows of a W plane per block
constexpr int PITCH = K6MAX + 1;       // shared row pitch: lanes hit 32 banks
constexpr int NPP = 27;                // 21 of H_pp's upper triangle + 6 of b_p
constexpr int PLANE = TL * PITCH;      // floats of one shared W plane
constexpr unsigned FULL = 0xffffffffu;

struct Camera {
    float fx, fy, cx, cy, bq, kernel_px2;
};

// Keyframes k0 .. k0 + kt of this block's 32 landmarks (l0 + lane). `red`
// is [WARPS][9][TL] shared floats; after the caller's __syncthreads() it
// holds each warp's partial H_ll (00 01 02 11 12 22) and b_l per landmark.
template <bool TO_SHARED>
__device__ __forceinline__ void accumulate_block(
    const float* __restrict__ T, const float* __restrict__ X,
    const float* __restrict__ obs, const float* __restrict__ obs_w,
    float* __restrict__ W, float* __restrict__ pp_part, float* Ws, float* red,
    int K, int L, int k0, int kt, int l0, const Camera cam) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int l = l0 + lane;
    const bool live = l < L;
    const size_t plane = (size_t)6 * K * L;   // floats of one global W plane

    float px = 0.f, py = 0.f, pz = 0.f;
    if (live) {
        px = __ldg(X + 3 * l);
        py = __ldg(X + 3 * l + 1);
        pz = __ldg(X + 3 * l + 2);
    }
    float h[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) h[i] = 0.f;

    for (int kk = warp; kk < kt; kk += WARPS) {
        const int k = k0 + kk;
        const float* Tk = T + 16 * k;
        float R[3][3], t[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
            for (int c = 0; c < 3; ++c) R[r][c] = __ldg(Tk + 4 * r + c);
            t[r] = __ldg(Tk + 4 * r + 3);
        }
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        float ow = 0.f;
        if (live) {
            o = __ldg(reinterpret_cast<const float4*>(obs) + (size_t)k * L + l);
            ow = __ldg(obs_w + (size_t)k * L + l);
        }

        const float xc = R[0][0] * px + R[0][1] * py + R[0][2] * pz + t[0];
        const float yc = R[1][0] * px + R[1][1] * py + R[1][2] * pz + t[1];
        const float zc = R[2][0] * px + R[2][1] * py + R[2][2] * pz + t[2];
        const float safe = fabsf(zc) < 1e-6f ? 1e-6f : zc;
        const float iz = 1.0f / safe;
        const float iz2 = iz * iz;

        const float u_l = cam.fx * xc * iz + cam.cx;
        const float v_l = cam.fy * yc * iz + cam.cy;
        const float u_r = (cam.fx * xc + cam.bq) * iz + cam.cx;
        float rs[4] = {u_l - o.x, v_l - o.y, u_r - o.z, v_l - o.w};
        const float err2 = rs[0] * rs[0] + rs[1] * rs[1] + rs[2] * rs[2] + rs[3] * rs[3];
        float w = err2 > cam.kernel_px2 ? cam.kernel_px2 / fmaxf(err2, 1e-12f) : 1.0f;
        w = w * ow * (zc > 0.05f ? 1.0f : 0.0f);
        const float sw = sqrtf(w);

        // sqrt-weighted image Jacobian rows w.r.t. the camera-frame point
        const float ju0 = sw * cam.fx * iz;
        const float jv1 = sw * cam.fy * iz;
        const float Juv[4][3] = {
            {ju0, 0.f, sw * -cam.fx * xc * iz2},
            {0.f, jv1, sw * -cam.fy * yc * iz2},
            {ju0, 0.f, sw * -(cam.fx * xc + cam.bq) * iz2},
            {0.f, jv1, sw * -cam.fy * yc * iz2}};
        float rss[4], jp[4][6], jl[4][3];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            rss[r] = sw * rs[r];
            // pose rows: [I | -hat(pc)] under the left-multiplied update
            jp[r][0] = Juv[r][0];
            jp[r][1] = Juv[r][1];
            jp[r][2] = Juv[r][2];
            jp[r][3] = Juv[r][2] * yc - Juv[r][1] * zc;
            jp[r][4] = Juv[r][0] * zc - Juv[r][2] * xc;
            jp[r][5] = Juv[r][1] * xc - Juv[r][0] * yc;
            // point rows: J_uv R
#pragma unroll
            for (int b = 0; b < 3; ++b)
                jl[r][b] = Juv[r][0] * R[0][b] + Juv[r][1] * R[1][b] + Juv[r][2] * R[2][b];
        }

        // H_ll upper triangle and b_l of this landmark
        {
            int i = 0;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = a; b < 3; ++b, ++i)
                    h[i] += jl[0][a] * jl[0][b] + jl[1][a] * jl[1][b] +
                            jl[2][a] * jl[2][b] + jl[3][a] * jl[3][b];
#pragma unroll
            for (int a = 0; a < 3; ++a)
                h[6 + a] += jl[0][a] * rss[0] + jl[1][a] * rss[1] +
                            jl[2][a] * rss[2] + jl[3][a] * rss[3];
        }

        // W planes, row 6k + a
#pragma unroll
        for (int b = 0; b < 3; ++b)
#pragma unroll
            for (int a = 0; a < 6; ++a) {
                const float wv = jl[0][b] * jp[0][a] + jl[1][b] * jp[1][a] +
                                 jl[2][b] * jp[2][a] + jl[3][b] * jp[3][a];
                if (live) W[b * plane + (size_t)(6 * k + a) * L + l] = wv;
                if (TO_SHARED) Ws[b * PLANE + lane * PITCH + 6 * kk + a] = wv;
            }

        // this keyframe's H_pp upper triangle and b_p over the warp's landmarks
        float pp[NPP];
        {
            int i = 0;
#pragma unroll
            for (int a = 0; a < 6; ++a)
#pragma unroll
                for (int b = a; b < 6; ++b, ++i)
                    pp[i] = jp[0][a] * jp[0][b] + jp[1][a] * jp[1][b] +
                            jp[2][a] * jp[2][b] + jp[3][a] * jp[3][b];
#pragma unroll
            for (int a = 0; a < 6; ++a)
                pp[21 + a] = jp[0][a] * rss[0] + jp[1][a] * rss[1] +
                             jp[2][a] * rss[2] + jp[3][a] * rss[3];
        }
#pragma unroll
        for (int i = 0; i < NPP; ++i) {
#pragma unroll
            for (int s = 16; s > 0; s >>= 1) pp[i] += __shfl_xor_sync(FULL, pp[i], s);
        }
        if (lane == 0) {
#pragma unroll
            for (int i = 0; i < NPP; ++i) pp_part[(size_t)k * NPP + i] = pp[i];
        }
    }

#pragma unroll
    for (int i = 0; i < 9; ++i) red[(warp * 9 + i) * TL + lane] = h[i];
}

// Sum of the warps' partials in warp order: value i of landmark `lane`.
__device__ __forceinline__ float sum_warps(const float* red, int i, int lane) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * 9 + i) * TL + lane];
    return s;
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

// NI = ceil(6K / 16): how many of the 12 row (and column) strips of the
// thread grid hold rows of this window. Three instances (3, 6, 12 strips):
// through the 12-strip one a window of 8 keyframes x 4096 landmarks takes
// 36 us on an H100 instead of 8, one of 16 keyframes 39 us instead of 16
// (mutation_check.py --instances).
template <int NI>
__global__ void __launch_bounds__(THREADS) schur_assemble_kernel(
    const float* __restrict__ T, const float* __restrict__ X,
    const float* __restrict__ obs, const float* __restrict__ obs_w,
    float* __restrict__ Hll_inv, float* __restrict__ b_l, float* __restrict__ W,
    float* __restrict__ ww_part, float* __restrict__ pp_part,
    int K, int L, const Camera cam, float damping) {
    extern __shared__ float smem[];
    float* Ws = smem;                       // [3][TL][PITCH]
    float* Cs = Ws + 3 * PLANE;             // [3][TL][PITCH]
    float* red = Cs + 3 * PLANE;            // [WARPS][9][TL]
    float* Hi = red + WARPS * 9 * TL;       // [9][TL]

    const int tid = threadIdx.x;
    const int l0 = blockIdx.x * TL;
    const int K6 = 6 * K;

    for (int i = tid; i < 3 * PLANE; i += THREADS) Ws[i] = 0.f;
    __syncthreads();

    accumulate_block<true>(T, X, obs, obs_w, W,
                           pp_part + (size_t)blockIdx.x * K * NPP, Ws, red,
                           K, L, 0, K, l0, cam);
    __syncthreads();

    // damped closed-form 3x3 inverse per landmark
    if (tid < TL) {
        const int l = l0 + tid;
        const float a00 = sum_warps(red, 0, tid) + damping;
        const float a01 = sum_warps(red, 1, tid);
        const float a02 = sum_warps(red, 2, tid);
        const float a11 = sum_warps(red, 3, tid) + damping;
        const float a12 = sum_warps(red, 4, tid);
        const float a22 = sum_warps(red, 5, tid) + damping;
        const float c00 = a11 * a22 - a12 * a12;
        const float c01 = a02 * a12 - a01 * a22;
        const float c02 = a01 * a12 - a02 * a11;
        const float c11 = a00 * a22 - a02 * a02;
        const float c12 = a01 * a02 - a00 * a12;
        const float c22 = a00 * a11 - a01 * a01;
        const float det = a00 * c00 + a01 * c01 + a02 * c02;
        const float idet = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
        const float hi[9] = {c00 * idet, c01 * idet, c02 * idet,
                             c01 * idet, c11 * idet, c12 * idet,
                             c02 * idet, c12 * idet, c22 * idet};
#pragma unroll
        for (int i = 0; i < 9; ++i) Hi[i * TL + tid] = hi[i];
        if (l < L) {
#pragma unroll
            for (int i = 0; i < 9; ++i) Hll_inv[(size_t)l * 9 + i] = hi[i];
#pragma unroll
            for (int a = 0; a < 3; ++a) b_l[(size_t)l * 3 + a] = sum_warps(red, 6 + a, tid);
        }
    }
    __syncthreads();

    // C = W Hll^-1, plane c: C_c = W_0 Hi[0][c] + W_1 Hi[1][c] + W_2 Hi[2][c]
    constexpr int ROWS = 16 * NI;
    for (int idx = tid; idx < 3 * TL * ROWS; idx += THREADS) {
        const int q = idx % ROWS;
        const int ln = (idx / ROWS) % TL;
        const int c = idx / (ROWS * TL);
        const int at = ln * PITCH + q;
        Cs[c * PLANE + at] = Ws[at] * Hi[c * TL + ln] +
                             Ws[PLANE + at] * Hi[(3 + c) * TL + ln] +
                             Ws[2 * PLANE + at] * Hi[(6 + c) * TL + ln];
    }
    __syncthreads();

    // this block's part of C W^T: rows ty + 16 i, columns tx + 16 j
    const int tx = tid & 15;
    const int ty = tid >> 4;
    float acc[NI][NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) acc[i][j] = 0.f;

    for (int cl = 0; cl < 3 * TL; ++cl) {
        const float* crow = Cs + cl * PITCH + ty;
        const float* wrow = Ws + cl * PITCH + tx;
        float a[NI], b[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            a[i] = crow[16 * i];
            b[i] = wrow[16 * i];
        }
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j) acc[i][j] += a[i] * b[j];
    }

    float* out = ww_part + (size_t)blockIdx.x * K6 * K6;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        const int q = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
            const int p = tx + 16 * j;
            if (q < K6 && p < K6) out[(size_t)q * K6 + p] = acc[i][j];
        }
    }
}

// Index of (a, b), a <= b, in the upper triangle of a 6 x 6 block.
__device__ __forceinline__ int upper6(int a, int b) {
    return a * 6 - (a * (a - 1)) / 2 + (b - a);
}

// Entry `item` of a keyframe's 27 numbers, summed over the landmark blocks
// in block order.
__device__ __forceinline__ float sum_pp(const float* __restrict__ pp_part,
                                        int nb, int K, int k, int item) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += pp_part[((size_t)b * K + k) * NPP + item];
    return s;
}

// S = diag(H_pp) - sum of the blocks' C W^T, and b_p.
__global__ void schur_reduce_kernel(const float* __restrict__ ww_part,
                                    const float* __restrict__ pp_part,
                                    float* __restrict__ S, float* __restrict__ b_p,
                                    int nb, int K) {
    const int K6 = 6 * K;
    const int n = K6 * K6;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx < n) {
        const int q = idx / K6;
        const int p = idx - q * K6;
        float s = 0.f;
        for (int b = 0; b < nb; ++b) s += ww_part[(size_t)b * n + idx];
        float val = -s;
        if (q / 6 == p / 6) {
            const int a = q % 6, c = p % 6;
            val += sum_pp(pp_part, nb, K, q / 6, upper6(min(a, c), max(a, c)));
        }
        S[idx] = val;
    } else if (idx < n + K6) {
        const int j = idx - n;
        b_p[j] = sum_pp(pp_part, nb, K, j / 6, 21 + j % 6);
    }
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) schur_tile_kernel(
    const float* __restrict__ T, const float* __restrict__ X,
    const float* __restrict__ obs, const float* __restrict__ obs_w,
    float* __restrict__ hl_part, float* __restrict__ W,
    float* __restrict__ pp_part, int K, int L, const Camera cam) {
    __shared__ float red[WARPS * 9 * TL];
    const int tid = threadIdx.x;
    const int l0 = blockIdx.x * TL;
    const int tile = blockIdx.y;

    accumulate_block<false>(T, X, obs, obs_w, W,
                            pp_part + (size_t)blockIdx.x * K * NPP, nullptr, red,
                            K, L, tile * KT, KT, l0, cam);
    __syncthreads();

    // the tile's partial H_ll upper triangle (rows 0-5) and b_l (rows 6-8)
    for (int idx = tid; idx < 9 * TL; idx += THREADS) {
        const int i = idx / TL;
        const int ln = idx - i * TL;
        if (l0 + ln < L)
            hl_part[((size_t)tile * 9 + i) * L + l0 + ln] = sum_warps(red, i, ln);
    }
}

// H_pp [K,6,6] and b_p [K,6] from the landmark blocks' partials.
__global__ void tile_reduce_kernel(const float* __restrict__ pp_part,
                                   float* __restrict__ H_pp, float* __restrict__ b_p,
                                   int nb, int K) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx < 36 * K) {
        const int k = idx / 36;
        const int a = (idx % 36) / 6, c = idx % 6;
        H_pp[idx] = sum_pp(pp_part, nb, K, k, upper6(min(a, c), max(a, c)));
    } else if (idx < 42 * K) {
        const int j = idx - 36 * K;
        b_p[j] = sum_pp(pp_part, nb, K, j / 6, 21 + j % 6);
    }
}

constexpr size_t K4_SHARED_BYTES =
    sizeof(float) * (2 * 3 * PLANE + WARPS * 9 * TL + 9 * TL);

template <int NI>
cudaError_t launch_k4(const float* T, const float* X, const float* obs,
                      const float* obs_w, float* Hll_inv, float* b_l, float* W,
                      float* ww_part, float* pp_part, int K, int L, Camera cam,
                      float damping, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        schur_assemble_kernel<NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)K4_SHARED_BYTES);
    if (err != cudaSuccess) return err;
    const int nb = (L + TL - 1) / TL;
    schur_assemble_kernel<NI><<<nb, THREADS, K4_SHARED_BYTES, stream>>>(
        T, X, obs, obs_w, Hll_inv, b_l, W, ww_part, pp_part, K, L, cam, damping);
    return cudaGetLastError();
}

}  // namespace

extern "C" int svi_schur_assemble(
    const void* T, const void* X, const void* obs, const void* obs_w, void* S,
    void* b_p, void* Hll_inv, void* b_l, void* W, void* ww_part, void* pp_part,
    int K, int L, float fx, float fy, float cx, float cy, float bq,
    float kernel_px2, float point_damping, float lam, void* stream) {
    if (K < 1 || K > KT || L < 1) return (int)cudaErrorInvalidValue;
    const Camera cam = {fx, fy, cx, cy, bq, kernel_px2};
    const float damping = lam + point_damping;
    cudaStream_t st = (cudaStream_t)stream;
    const float* Tf = (const float*)T;
    const float* Xf = (const float*)X;
    const float* of = (const float*)obs;
    const float* wf = (const float*)obs_w;
    cudaError_t err;
    if (K <= 8)
        err = launch_k4<3>(Tf, Xf, of, wf, (float*)Hll_inv, (float*)b_l, (float*)W,
                           (float*)ww_part, (float*)pp_part, K, L, cam, damping, st);
    else if (K <= 16)
        err = launch_k4<6>(Tf, Xf, of, wf, (float*)Hll_inv, (float*)b_l, (float*)W,
                           (float*)ww_part, (float*)pp_part, K, L, cam, damping, st);
    else
        err = launch_k4<12>(Tf, Xf, of, wf, (float*)Hll_inv, (float*)b_l, (float*)W,
                            (float*)ww_part, (float*)pp_part, K, L, cam, damping, st);
    if (err != cudaSuccess) return (int)err;
    const int nb = (L + TL - 1) / TL;
    const int n = 36 * K * K + 6 * K;
    schur_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        (const float*)ww_part, (const float*)pp_part, (float*)S, (float*)b_p, nb, K);
    return (int)cudaGetLastError();
}

extern "C" int svi_schur_assemble_tiled(
    const void* T, const void* X, const void* obs, const void* obs_w, void* H_pp,
    void* b_p, void* hl_part, void* W, void* pp_part, int K, int L, float fx,
    float fy, float cx, float cy, float bq, float kernel_px2, void* stream) {
    if (K < KT || K % KT != 0 || L < 1) return (int)cudaErrorInvalidValue;
    const Camera cam = {fx, fy, cx, cy, bq, kernel_px2};
    cudaStream_t st = (cudaStream_t)stream;
    const int nb = (L + TL - 1) / TL;
    const dim3 grid(nb, K / KT);
    schur_tile_kernel<<<grid, THREADS, 0, st>>>(
        (const float*)T, (const float*)X, (const float*)obs, (const float*)obs_w,
        (float*)hl_part, (float*)W, (float*)pp_part, K, L, cam);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = 42 * K;
    tile_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        (const float*)pp_part, (float*)H_pp, (float*)b_p, nb, K);
    return (int)cudaGetLastError();
}
