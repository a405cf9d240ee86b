// K4 and K5: the Schur-complement system of one LM iteration of bundle
// adjustment, computed whole on the card.
//
// Replaces the TPU kernels schur_assemble (K4, K <= 32 keyframes) and
// schur_assemble_tiled (K5, K % 32 == 0 up to 128) of
// svi_mapper_tpu/ops/ba_kernel.py. Both entry points of ops/ba_kernel.py
// launch the same three kernels; the contract, the tiling (schur_tiling,
// which sizes the grids and the scratch) and the plain PyTorch versions are
// there.
//
// 1. schur_assembly_kernel, grid (landmark tile of 32, keyframe split): per
//    (keyframe, landmark) the camera-frame point, the four stereo residuals,
//    the robust weight and the sqrt-weighted Jacobian rows live in registers
//    (one landmark per lane, one keyframe per warp at a time). It writes the
//    W planes, each keyframe's 21 + 6 numbers of H_pp / b_p summed over the
//    tile's landmarks (a warp reduce-scatter), the split's partial H_ll / b_l
//    per landmark, and a flag per (landmark tile, keyframe): does any
//    observation weight of the tile differ from 0. Where none does, every W
//    entry of the pair is exactly +-0. The tile's last split to finish
//    (elected by a completion counter) adds the splits' H_ll / b_l in split
//    order, inverts the damped blocks and writes Hll_inv, b_l and a 48-byte
//    record [Hll^-1 | b_l] per landmark.
// 2. schur_product_kernel<G>, grid (tile of the upper block triangle,
//    landmark chunk): keyframe groups I <= J of G keyframes; thread (i, j)
//    of the tile holds the 6x6 block S_ij = sum_l W_il Hll_l^-1 W_jl^T in
//    36 float32 registers (FFMA, no tensor cores: TF32 would stall LM at
//    three digits). Pairs with i > j are not formed; the reduction mirrors
//    the upper triangle. On diagonal tiles some of the threads below the
//    diagonal form the rhs column, sum_l W_il Hll_l^-1 b_l: b_l rides in the
//    C operand's padding. Per slab of 16 landmarks the W rows of I and J
//    and the landmarks' records are staged with cp.async (16-byte copies
//    when L % 4 == 0) while the previous slab is multiplied out; C =
//    W Hll^-1 is formed in shared memory, never in device memory. Landmark
//    tiles whose flags are all 0 for I (or J) are skipped: their terms are
//    exact zeros.
// 3. schur_reduce_kernel: adds the chunks' partials and the landmark tiles'
//    H_pp / b_p partials in a fixed order, writes S (mirrored) and rhs.
//
// No atomics in any sum: the same inputs give the same bits run to run.
//
// What bounds them on an H100: at K = 128, L = 4096 the upper block
// triangle of the product is 7.3 GFLOP of the function's 7.6: 0.11 ms at
// 67 TFLOP/s; the W planes (37.7 MB) are 11 us of memory time. The
// product is operations-bound; its register tile reads 12 floats of shared
// memory (two 16-byte and two 8-byte loads per operand) per 36 FFMA. At
// K = 8, L = 1024 the function moves 0.8 MB and does 8 MFLOP: launch
// latency and the chain load -> transform -> multiply -> reduce bound it.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TL = 32;                 // landmarks per assembly tile / flag
constexpr int AWARPS = 4;              // warps of an assembly block
constexpr int ATHREADS = AWARPS * 32;
constexpr int NPP = 27;                // 21 of H_pp's upper triangle + 6 of b_p
constexpr int LS = 16;                 // landmarks per product slab
constexpr int SLOT = 24;               // floats per (keyframe, landmark): [c][8]
constexpr int KPITCH = LS * SLOT + 4;  // floats per keyframe row of a slab
constexpr int HI = 12;                 // Hll^-1 (9) and b_l (3) per landmark
constexpr int MAX_SC = 512;            // slabs per product chunk
constexpr unsigned FULL = 0xffffffffu;

struct Camera {
    float fx, fy, cx, cy, bq, kernel_px2;
};

// ---------------------------------------------------------------------------
// 1. assembly
// ---------------------------------------------------------------------------

// One step of a warp's reduce-scatter: lanes whose bit S is set keep the
// upper half of v[0 .. 2S), the others the lower half, each adding its
// partner's copy of the half it keeps.
template <int S>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
    const bool upper = lane & S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
        const float keep = upper ? v[i + S] : v[i];
        const float send = upper ? v[i] : v[i + S];
        v[i] = keep + __shfl_xor_sync(FULL, send, S);
    }
}

// Keyframes k0 .. k0 + kt of this block's 32 landmarks (l0 + lane). `red` is
// [AWARPS][9][TL] shared floats; after the caller's __syncthreads() it holds
// each warp's partial H_ll (00 01 02 11 12 22) and b_l per landmark.
__device__ __forceinline__ void accumulate_block(
    const float* __restrict__ T, const float* __restrict__ X,
    const float* __restrict__ obs, const float* __restrict__ obs_w,
    float* __restrict__ W, float* __restrict__ pp_part, int* __restrict__ flags,
    float* red, int K, int L, int k0, int kt, int l0, const Camera cam) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int l = l0 + lane;
    const bool live = l < L;
    const size_t plane = (size_t)6 * K * L;   // floats of one W plane

    float px = 0.f, py = 0.f, pz = 0.f;
    if (live) {
        px = __ldg(X + 3 * l);
        py = __ldg(X + 3 * l + 1);
        pz = __ldg(X + 3 * l + 2);
    }
    float h[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) h[i] = 0.f;

    for (int kk = warp; kk < kt; kk += AWARPS) {
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
        const unsigned seen = __ballot_sync(FULL, ow != 0.0f);
        if (lane == 0) flags[(size_t)(l0 / TL) * K + k] = seen != 0u;

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
        // summed over the warp's 32 landmarks by a butterfly that halves
        // what each lane carries at every step (31 shuffles, not 27 x 5):
        // lane i ends with number i, the sum of the same pairs in the same
        // order as a full exchange would give
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = i < NPP ? pp[i] : 0.f;
        reduce_scatter<16>(v, lane);
        reduce_scatter<8>(v, lane);
        reduce_scatter<4>(v, lane);
        reduce_scatter<2>(v, lane);
        reduce_scatter<1>(v, lane);
        if (lane < NPP) pp_part[(size_t)k * NPP + lane] = v[0];
    }

#pragma unroll
    for (int i = 0; i < 9; ++i) red[(warp * 9 + i) * TL + lane] = h[i];
}

// Landmark l's H_ll and b_l summed over the assembly's splits in split
// order, the damped closed-form inverse: out[0..8] = Hll^-1 (row-major),
// out[9..11] = b_l. The partials were written by other blocks of the same
// grid: read through L2 (__ldcg), not the read-only path.
__device__ __forceinline__ void landmark_inverse(const float* hl_part, int nks, int L,
                                                 int l, float damping, float* out) {
    float h[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) h[i] = 0.f;
    for (int s = 0; s < nks; ++s) {
#pragma unroll
        for (int i = 0; i < 9; ++i) h[i] += __ldcg(hl_part + ((size_t)s * 9 + i) * L + l);
    }
    const float a00 = h[0] + damping;
    const float a01 = h[1];
    const float a02 = h[2];
    const float a11 = h[3] + damping;
    const float a12 = h[4];
    const float a22 = h[5] + damping;
    const float c00 = a11 * a22 - a12 * a12;
    const float c01 = a02 * a12 - a01 * a22;
    const float c02 = a01 * a12 - a02 * a11;
    const float c11 = a00 * a22 - a02 * a02;
    const float c12 = a01 * a02 - a00 * a12;
    const float c22 = a00 * a11 - a01 * a01;
    const float det = a00 * c00 + a01 * c01 + a02 * c02;
    const float idet = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
    out[0] = c00 * idet; out[1] = c01 * idet; out[2] = c02 * idet;
    out[3] = c01 * idet; out[4] = c11 * idet; out[5] = c12 * idet;
    out[6] = c02 * idet; out[7] = c12 * idet; out[8] = c22 * idet;
    out[9] = h[6]; out[10] = h[7]; out[11] = h[8];
}

__global__ void __launch_bounds__(ATHREADS) schur_assembly_kernel(
    const float* __restrict__ T, const float* __restrict__ X,
    const float* __restrict__ obs, const float* __restrict__ obs_w,
    float* __restrict__ W, float* __restrict__ pp_part, float* hl_part,
    int* __restrict__ flags, float* __restrict__ hrec, float* __restrict__ Hll_inv,
    float* __restrict__ b_l, unsigned* __restrict__ count, int K, int L, int ks,
    float damping, const Camera cam) {
    __shared__ float red[AWARPS * 9 * TL];
    __shared__ bool last;
    const int tid = threadIdx.x;
    const int l0 = blockIdx.x * TL;
    const int k0 = blockIdx.y * ks;
    const int nks = gridDim.y;
    accumulate_block(T, X, obs, obs_w, W, pp_part + (size_t)blockIdx.x * K * NPP,
                     flags, red, K, L, k0, min(ks, K - k0), l0, cam);
    __syncthreads();
    // the split's partial H_ll upper triangle (rows 0-5) and b_l (rows 6-8),
    // its warps summed in warp order
    for (int idx = tid; idx < 9 * TL; idx += ATHREADS) {
        const int i = idx / TL;
        const int ln = idx - i * TL;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < AWARPS; ++w) s += red[(w * 9 + i) * TL + ln];
        if (l0 + ln < L) hl_part[((size_t)blockIdx.y * 9 + i) * L + l0 + ln] = s;
    }
    // the last split of the tile to finish (a completion counter elects it;
    // it resets the counter) sums the splits in order and writes Hll_inv and
    // b_l, and the record [Hll^-1 | b_l] the product stages
    __threadfence();
    __syncthreads();
    if (nks > 1) {
        if (tid == 0) last = atomicAdd(count + blockIdx.x, 1u) == (unsigned)nks - 1u;
        __syncthreads();
        if (!last) return;
        __threadfence();
    }
    if (tid < TL && l0 + tid < L) {
        const int l = l0 + tid;
        float h[HI];
        landmark_inverse(hl_part, nks, L, l, damping, h);
#pragma unroll
        for (int i = 0; i < 9; ++i) Hll_inv[(size_t)l * 9 + i] = h[i];
#pragma unroll
        for (int a = 0; a < 3; ++a) b_l[(size_t)l * 3 + a] = h[9 + a];
#pragma unroll
        for (int i = 0; i < HI; ++i) hrec[(size_t)l * HI + i] = h[i];
    }
    if (nks > 1 && tid == 0) count[blockIdx.x] = 0u;
}

// ---------------------------------------------------------------------------
// 2. product
// ---------------------------------------------------------------------------

// Index of (a, b), a <= b, in the upper triangle of a 6 x 6 block.
__host__ __device__ constexpr int upper6(int a, int b) {
    return a * 6 - (a * (a - 1)) / 2 + (b - a);
}

// Does any keyframe of [k0, k0 + n) observe landmark tile t?
__device__ __forceinline__ bool any_flag(const int* __restrict__ flags, int t, int K,
                                         int k0, int n) {
    const int k1 = min(K, k0 + n);
    int any = 0;
    for (int k = k0; k < k1; ++k) any |= __ldg(flags + (size_t)t * K + k);
    return any != 0;
}

// Index of the 6x6 block (i, j), i <= j, in the upper block triangle.
__host__ __device__ __forceinline__ int pair_index(int i, int j, int K) {
    return i * K - (i * (i - 1)) / 2 + (j - i);
}

// cp.async of 4 or 16 bytes; `ok` false fills the destination with zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int G>
struct ProductShape {
    static constexpr int PT = G * G;           // one thread per pair of the tile
    static constexpr int ROWS = 6 * G;         // W rows of a keyframe group
    static constexpr int RAW_OP = 3 * ROWS * LS;
    static constexpr int FLOATS = 2 * RAW_OP + LS * HI + 2 * G * KPITCH;
    static constexpr size_t BYTES = sizeof(float) * FLOATS + sizeof(int) * MAX_SC;
};

template <int G>
__global__ void __launch_bounds__(ProductShape<G>::PT, G == 16 ? 2 : 4)
schur_product_kernel(const float* __restrict__ W, const float* __restrict__ hrec,
                     const int* __restrict__ flags, const float* __restrict__ pp_part,
                     float* __restrict__ part, float* __restrict__ rhs_part, int K, int L,
                     int sc) {
    using Sh = ProductShape<G>;
    constexpr int ROWS = Sh::ROWS;
    constexpr int RAW_OP = Sh::RAW_OP;
    constexpr int PT = Sh::PT;
    extern __shared__ float4 smem4[];
    float* raw = reinterpret_cast<float*>(smem4);   // [2 operands][3][ROWS][LS]
    float* hi = raw + 2 * RAW_OP;                    // [LS][HI]: Hll^-1, b_l
    float* cs = hi + LS * HI;                        // C of group I: [G][KPITCH]
    float* ws = cs + G * KPITCH;                     // W of group J: [G][KPITCH]
    int* slabs = reinterpret_cast<int*>(ws + G * KPITCH);   // [sc]
    __shared__ int n_slabs;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // tile -> keyframe groups I <= J, row by row of the upper triangle
    const int nG = (K + G - 1) / G;
    int t = blockIdx.x, I = 0;
    while (t >= nG - I) {
        t -= nG - I;
        ++I;
    }
    const int J = I + t;
    const bool diag = I == J;
    const int chunk = blockIdx.y;
    const int s0 = chunk * sc;
    const int s1 = min((L + LS - 1) / LS, s0 + sc);
    const size_t plane = (size_t)6 * K * L;
    const bool vec4 = (L & 3) == 0;

    // the chunk's live slabs: those whose landmark tile group I (and J)
    // observes
    if (warp == 0) {
        int n = 0;
        for (int base = s0; base < s1; base += 32) {
            const int sl = base + lane;
            const int tt = sl * LS / TL;
            bool live = false;
            if (sl < s1)
                live = any_flag(flags, tt, K, I * G, G) &&
                       (diag || any_flag(flags, tt, K, J * G, G));
            const unsigned m = __ballot_sync(FULL, live);
            if (live) slabs[n + __popc(m & ((1u << lane) - 1u))] = sl;
            n += __popc(m);
        }
        if (lane == 0) n_slabs = n;
    }
    __syncthreads();
    const int ns = n_slabs;

    // W rows of groups I (and J) and the records of the slab's landmarks,
    // zeros past K or L: 16-byte copies where rows start 16-byte aligned
    auto stage = [&](int slab) {
        const int l0 = slab * LS;
        const int ops = diag ? 1 : 2;
        if (vec4) {
            for (int e = tid; e < ops * 3 * ROWS * (LS / 4); e += PT) {
                const int q = e % (LS / 4);
                const int rb = e / (LS / 4);             // [op][b][r]
                const int r = rb % ROWS;
                const int b = (rb / ROWS) % 3;
                const int row = (rb < 3 * ROWS ? I : J) * ROWS + r;
                const int l = l0 + 4 * q;
                const bool ok = row < 6 * K && l < L;
                cp_async16(raw + rb * LS + 4 * q,
                           ok ? W + b * plane + (size_t)row * L + l : W, ok);
            }
        } else {
            for (int e = tid; e < ops * RAW_OP; e += PT) {
                const int l = e % LS;
                const int rb = e / LS;
                const int r = rb % ROWS;
                const int b = (rb / ROWS) % 3;
                const int row = (rb < 3 * ROWS ? I : J) * ROWS + r;
                const bool ok = row < 6 * K && l0 + l < L;
                cp_async4(raw + e, ok ? W + b * plane + (size_t)row * L + l0 + l : W, ok);
            }
        }
        for (int e = tid; e < LS * (HI / 4); e += PT) {
            const int l = l0 + e / (HI / 4);
            const bool ok = l < L;
            cp_async16(hi + 4 * e, ok ? hrec + (size_t)l * HI + 4 * (e % (HI / 4)) : hrec, ok);
        }
        cp_async_commit();
    };

    // pair thread: li, lj within the tile (4 x 8 per warp)
    const int li = 4 * (warp / (G / 8)) + (lane >> 3);
    const int lj = 8 * (warp % (G / 8)) + (lane & 7);
    const int i = I * G + li;
    const int j = J * G + lj;
    const bool pair_on = i < K && j < K && (!diag || li <= lj);
    // rhs thread of a diagonal tile, one of the pairs below the diagonal:
    // (li, 0) forms row li, (G - 1, G - 2) row 0
    const int rl = li == G - 1 && lj == G - 2 ? 0 : li;
    const bool rhs_on = diag && li > lj && (lj == 0 || rl == 0) && I * G + rl < K;

    float acc[6][6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 6; ++b) acc[a][b] = 0.f;

    if (ns > 0) stage(slabs[0]);
    for (int s = 0; s < ns; ++s) {
        cp_async_wait_all();
        __syncthreads();          // raw, hi: slab s; cs, ws free
        // C = W Hll^-1 of group I and W of group J in the product's layout,
        // one (keyframe, landmark) per thread
        const float* rj = raw + (diag ? 0 : RAW_OP);
        for (int e = tid; e < G * LS; e += PT) {
            const int l = e % LS;
            const int k = e / LS;
            const float4 h0 = *reinterpret_cast<const float4*>(hi + l * HI);
            const float4 h1 = *reinterpret_cast<const float4*>(hi + l * HI + 4);
            const float4 h2 = *reinterpret_cast<const float4*>(hi + l * HI + 8);
            const float h[12] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w,
                                 h2.x, h2.y, h2.z, h2.w};
            float cv[3][6], wv[3][6];
#pragma unroll
            for (int a = 0; a < 6; ++a) {
                const int r = 6 * k + a;
                const float w0 = raw[r * LS + l];
                const float w1 = raw[(ROWS + r) * LS + l];
                const float w2 = raw[(2 * ROWS + r) * LS + l];
                // C_c = W_0 Hi[0][c] + W_1 Hi[1][c] + W_2 Hi[2][c]
#pragma unroll
                for (int c = 0; c < 3; ++c) cv[c][a] = w0 * h[c] + w1 * h[3 + c] + w2 * h[6 + c];
#pragma unroll
                for (int c = 0; c < 3; ++c) wv[c][a] = rj[(c * ROWS + r) * LS + l];
            }
            // slot [c][8] of C: rows 0-5 of column c, then b_l[c] (the rhs
            // column's other operand) and a zero
            float* cd = cs + k * KPITCH + l * SLOT;
            float* wd = ws + k * KPITCH + l * SLOT;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                *reinterpret_cast<float4*>(cd + 8 * c) =
                    make_float4(cv[c][0], cv[c][1], cv[c][2], cv[c][3]);
                *reinterpret_cast<float4*>(cd + 8 * c + 4) =
                    make_float4(cv[c][4], cv[c][5], h[9 + c], 0.f);
                *reinterpret_cast<float4*>(wd + 8 * c) =
                    make_float4(wv[c][0], wv[c][1], wv[c][2], wv[c][3]);
                *reinterpret_cast<float2*>(wd + 8 * c + 4) = make_float2(wv[c][4], wv[c][5]);
            }
        }
        __syncthreads();          // cs, ws ready; raw, hi free
        if (s + 1 < ns) stage(slabs[s + 1]);
        if (pair_on) {
            const float* cp = cs + li * KPITCH;
            const float* wp = ws + lj * KPITCH;
#pragma unroll 2
            for (int l = 0; l < LS; ++l) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float4 ca = *reinterpret_cast<const float4*>(cp + l * SLOT + 8 * c);
                    const float2 cb = *reinterpret_cast<const float2*>(cp + l * SLOT + 8 * c + 4);
                    const float4 wa = *reinterpret_cast<const float4*>(wp + l * SLOT + 8 * c);
                    const float2 wb = *reinterpret_cast<const float2*>(wp + l * SLOT + 8 * c + 4);
                    const float cv[6] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y};
                    const float wv[6] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y};
#pragma unroll
                    for (int a = 0; a < 6; ++a)
#pragma unroll
                        for (int b = 0; b < 6; ++b) acc[a][b] = fmaf(cv[a], wv[b], acc[a][b]);
                }
            }
        } else if (rhs_on) {
            const float* cp = cs + rl * KPITCH;
            for (int l = 0; l < LS; ++l) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float bl = cp[l * SLOT + 8 * c + 6];
#pragma unroll
                    for (int a = 0; a < 6; ++a)
                        acc[0][a] = fmaf(cp[l * SLOT + 8 * c + a], bl, acc[0][a]);
                }
            }
        }
    }

    // the diagonal tile's H_pp blocks and b_p enter with the minus sign of
    // the partial, summed over the landmark tiles whose first slab is in
    // this chunk, in tile order
    if (diag && ((pair_on && li == lj) || rhs_on)) {
        const int k = pair_on ? i : I * G + rl;
        const int nlt = (L + TL - 1) / TL;
        float hp[NPP];
#pragma unroll
        for (int n = 0; n < NPP; ++n) hp[n] = 0.f;
        for (int tt = (s0 + 1) / 2; tt < min(nlt, (s1 + 1) / 2); ++tt) {
            const float* src = pp_part + ((size_t)tt * K + k) * NPP;
#pragma unroll
            for (int n = 0; n < NPP; ++n) hp[n] += __ldg(src + n);
        }
        if (pair_on) {
#pragma unroll
            for (int a = 0; a < 6; ++a)
#pragma unroll
                for (int b = 0; b < 6; ++b)
                    acc[a][b] -= hp[a <= b ? upper6(a, b) : upper6(b, a)];
        } else {
#pragma unroll
            for (int a = 0; a < 6; ++a) acc[0][a] -= hp[21 + a];
        }
    }

    if (pair_on) {
        const int P = K * (K + 1) / 2;
        float4* out = reinterpret_cast<float4*>(
            part + ((size_t)chunk * P + pair_index(i, j, K)) * 36);
#pragma unroll
        for (int q = 0; q < 9; ++q) {
            const int e = 4 * q;
            out[q] = make_float4(acc[e / 6][e % 6], acc[(e + 1) / 6][(e + 1) % 6],
                                 acc[(e + 2) / 6][(e + 2) % 6], acc[(e + 3) / 6][(e + 3) % 6]);
        }
    } else if (rhs_on) {
#pragma unroll
        for (int a = 0; a < 6; ++a)
            rhs_part[((size_t)chunk * K + I * G + rl) * 6 + a] = acc[0][a];
    }
}

// ---------------------------------------------------------------------------
// 3. reduction
// ---------------------------------------------------------------------------

constexpr int RPAIRS = 7;              // 6x6 blocks per reduction block

// S = diag(H_pp) - W Hll^-1 W^T and rhs = b_p - W Hll^-1 b_l: the chunks'
// partials (which carry -H_pp and -b_p already) added in chunk order and
// negated. A block takes RPAIRS blocks of the upper triangle, one thread
// per entry, and writes each block at (i, a, j, b) and its mirror at
// (j, b, i, a) through shared memory, both in rows of six; the blocks past
// the upper triangle's take rhs.
__global__ void __launch_bounds__(RPAIRS * 36) schur_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ rhs_part,
    float* __restrict__ S, float* __restrict__ rhs, int K, int nc) {
    __shared__ float v[RPAIRS * 36];
    const int u = threadIdx.x;
    const int P = K * (K + 1) / 2;
    const int n_s = (P + RPAIRS - 1) / RPAIRS;
    if ((int)blockIdx.x >= n_s) {
        const int e = (blockIdx.x - n_s) * RPAIRS * 36 + u;
        if (e < 6 * K) {
            float s = 0.f;
#pragma unroll 8
            for (int c = 0; c < nc; ++c) s += rhs_part[(size_t)c * 6 * K + e];
            rhs[e] = -s;
        }
        return;
    }
    const int p = blockIdx.x * RPAIRS + u / 36;
    const int q = u % 36;
    float s = 0.f;
    if (p < P) {
#pragma unroll 8
        for (int c = 0; c < nc; ++c) s += part[((size_t)c * P + p) * 36 + q];
    }
    v[u] = -s;
    __syncthreads();
    if (p >= P) return;
    // row i of the upper triangle that holds pair p
    int i = (int)((2.0 * K + 1.0 - sqrt((2.0 * K + 1.0) * (2.0 * K + 1.0) - 8.0 * p)) / 2.0);
    i = max(0, min(K - 1, i));
    while (i > 0 && pair_index(i, i, K) > p) --i;
    while (i + 1 < K && pair_index(i + 1, i + 1, K) <= p) ++i;
    const int j = i + (p - pair_index(i, i, K));
    const int K6 = 6 * K;
    S[(size_t)(6 * i + q / 6) * K6 + 6 * j + q % 6] = v[u];
    // the mirror: entry (a, b) = (q % 6, q / 6) of the block at (j, b, i, a)
    if (i != j) S[(size_t)(6 * j + q / 6) * K6 + 6 * i + q % 6] = v[u - q + (q % 6) * 6 + q / 6];
}

template <int G>
cudaError_t launch_product(const float* W, const float* hrec, const int* flags,
                           const float* pp_part, float* part, float* rhs_part, int K,
                           int L, int sc, int nc, cudaStream_t stream) {
    using Sh = ProductShape<G>;
    // once per device and process: the attribute belongs to the kernel
    static bool set[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !set[dev]) {
        err = cudaFuncSetAttribute(schur_product_kernel<G>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)Sh::BYTES);
        if (err != cudaSuccess) return err;
        if (dev < 64) set[dev] = true;
    }
    const int nG = (K + G - 1) / G;
    const dim3 grid(nG * (nG + 1) / 2, nc);
    schur_product_kernel<G><<<grid, Sh::PT, Sh::BYTES, stream>>>(
        W, hrec, flags, pp_part, part, rhs_part, K, L, sc);
    return cudaGetLastError();
}

}  // namespace

// The whole Schur system of one LM iteration. The tiling (ks keyframes per
// assembly split, sc slabs of 16 landmarks per product chunk, group size g)
// and the scratch regions come from ops/ba_kernel.py's schur_tiling:
//   pp_part [nlt][K][27], hl_part [nks][9][L], flags [nlt][K] (int32),
//   hrec [L][12], part [nc][K (K + 1) / 2][36], rhs_part [nc][K][6], hrec
//   and part 16-byte aligned; count [nlt] unsigned, zero on entry and left
//   zero (the election's counters).
extern "C" int svi_schur_system(
    const void* T, const void* X, const void* obs, const void* obs_w, void* S,
    void* rhs, void* Hll_inv, void* b_l, void* W, void* pp_part, void* hl_part,
    void* flags, void* hrec, void* part, void* rhs_part, void* count, int K, int L,
    int ks, int sc, int g, float fx, float fy, float cx, float cy, float bq,
    float kernel_px2, float damping, void* stream) {
    if (K < 1 || L < 1 || ks < 1 || sc < 1 || sc > MAX_SC || (g != 8 && g != 16) ||
        ((size_t)part & 15u) != 0 || ((size_t)hrec & 15u) != 0 || ((size_t)W & 15u) != 0)
        return (int)cudaErrorInvalidValue;
    const Camera cam = {fx, fy, cx, cy, bq, kernel_px2};
    cudaStream_t st = (cudaStream_t)stream;
    const int nlt = (L + TL - 1) / TL;
    const int nks = (K + ks - 1) / ks;
    const int nc = ((L + LS - 1) / LS + sc - 1) / sc;

    schur_assembly_kernel<<<dim3(nlt, nks), ATHREADS, 0, st>>>(
        (const float*)T, (const float*)X, (const float*)obs, (const float*)obs_w,
        (float*)W, (float*)pp_part, (float*)hl_part, (int*)flags, (float*)hrec,
        (float*)Hll_inv, (float*)b_l, (unsigned*)count, K, L, ks, damping, cam);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    err = g == 8
        ? launch_product<8>((const float*)W, (const float*)hrec, (const int*)flags,
                            (const float*)pp_part, (float*)part, (float*)rhs_part, K, L,
                            sc, nc, st)
        : launch_product<16>((const float*)W, (const float*)hrec, (const int*)flags,
                             (const float*)pp_part, (float*)part, (float*)rhs_part, K, L,
                             sc, nc, st);
    if (err != cudaSuccess) return (int)err;

    const int P = K * (K + 1) / 2;
    const int blocks = (P + RPAIRS - 1) / RPAIRS + (6 * K + RPAIRS * 36 - 1) / (RPAIRS * 36);
    schur_reduce_kernel<<<blocks, RPAIRS * 36, 0, st>>>(
        (const float*)part, (const float*)rhs_part, (float*)S, (float*)rhs, K, nc);
    return (int)cudaGetLastError();
}
