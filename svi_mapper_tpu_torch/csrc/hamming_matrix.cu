// K6: Hamming distances of packed 256-bit descriptors on the tensor cores:
// the all-pairs matrix, and the fused nearest-neighbour count of the
// closure's pool scoring.
//
// Replaces the TPU kernel svi_mapper_tpu/ops/hamming.py hamming_pallas
// (_hamming_kernel), and the XOR-popcount-min-count block that the JAX
// package computes inline in mapping/closure.py _pool_nn_counts.
//
// The tile core is the bit-matmul identity of ops/hamming.py hamming_mxu,
//   d(a, b) = |a| + |b| - 2 a.b,
// with a.b on the tensor cores: the binary MMA (mma.sync m16n8k256, b1
// operands, AND then popcount, s32 sums) reads the packed words as they
// are, one MMA per 16 x 8 tile of 256-bit descriptors, lane t of a quad
// holding words t and t + 4 of its row and column. Every sum is an integer
// <= 256, so the result is exact; the norms come from __popc, once per
// descriptor and load. A warp computes four 16 x 8 tiles at once on four
// independent accumulators. The popcount pipe (16 per clock per SM) does
// not touch the pairs.
//
// What bounds it on the card: the matrix entry writes 4 bytes per pair, so
// at N = 256, M = 4096 bytes bound it (4.3 MB); the pool entry writes only
// [B, C] counts, and at [8, 256, 16 x 256] its operations bound it (4.3 G
// on the binary MMA, whose rate no data sheet gives: chip_smoke.py measures
// it), against 67 M popcounts on the popcount pipe.
//
// Two entries share the tile core:
//   * svi_hamming_matrix: out[z, n, m] for a [B, N, 8], b [B, M, 8] ->
//     [B, N, M] int32, ragged N and M (rows and columns past the edge read
//     as zeros and are never written); a block of four warps computes
//     64 x 32 distances from operands read through the read-only cache,
//     and each lane writes two neighbouring columns of a row together;
//   * svi_pool_nn_counts: counts[z, c] = #{p : valid_q[z, p] and
//     min over valid r of d(q[z, p], ref[z, c, r]) <= cutoff}; one block
//     of 16 warps per (z, c) stages the pool (up to 256 references) in
//     shared memory with its norms and valid flags, each warp takes 16
//     queries; the minimum is taken in registers (an invalid reference is
//     1 << 20)
//     and across the quad by shuffles, the count in shared memory (integer
//     sums: any order gives the same bits). The [B, P, C Pr] matrix is
//     never written.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int BIG = 1 << 20;               // closure.py _BIG
constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 4;                      // 16 x 8 tiles a warp computes together
constexpr int MATRIX_WARPS = 4;            // 64 x 32 distances per matrix block
constexpr int POOL_WARPS = 16;             // 256 query rows per pool pass
// staged words per reference (a lane's two words at 2 t: the 8-byte loads
// of a half-warp fall on distinct banks), references staged per pool pass
constexpr int REF_PITCH = WORDS;
constexpr int POOL_TILE = 256;

__device__ __forceinline__ void mma(int (&acc)[4], const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragment words one lane holds of one descriptor (a row of A or a
// column of B): words t and t + 4 (k = 32 t .. and 128 + 32 t ..), and the
// descriptor's norm summed over the quad.
struct Frag {
    uint32_t w[2];
    int norm;
};

// descriptor `row` of a [rows, 8] array (zeros past the edge) as lane t of
// a quad holds it; every lane of the warp takes part
__device__ __forceinline__ Frag load_frag(const uint4* d, int row, int rows, int t) {
    Frag f;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(d + 2 * row);
    f.w[0] = row < rows ? __ldg(p + t) : 0u;
    f.w[1] = row < rows ? __ldg(p + t + 4) : 0u;
    int n = __popc(f.w[0]) + __popc(f.w[1]);
    n += __shfl_xor_sync(FULL, n, 1);
    f.norm = n + __shfl_xor_sync(FULL, n, 2);
    return f;
}

// A fragments of a warp's 16 query rows (row0 + g, row0 + g + 8) and
// their norms
struct Queries {
    uint32_t a[4];
    int norm0, norm1;
};

__device__ __forceinline__ void load_queries(Queries& q, const uint4* d, int row0,
                                             int rows, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const Frag f0 = load_frag(d, row0 + g, rows, t);
    const Frag f1 = load_frag(d, row0 + g + 8, rows, t);
    q.a[0] = f0.w[0];
    q.a[1] = f1.w[0];
    q.a[2] = f0.w[1];
    q.a[3] = f1.w[1];
    q.norm0 = f0.norm;
    q.norm1 = f1.norm;
}

// The distances of a warp's 16 queries to the NT tiles of 8 references
// whose fragment words this lane holds in b[j], given the norms of columns
// 2t and 2t + 1 of each tile: d[j] = (row g, col 2t), (row g, col 2t + 1),
// (row g + 8, col 2t), (row g + 8, col 2t + 1) of tile j. The NT
// accumulators are independent, so their MMAs interleave.
__device__ __forceinline__ void tile_distances(int (&d)[NT][4], const Queries& q,
                                               const uint32_t (&b)[NT][2],
                                               const int (&nb)[NT][2]) {
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[j], q.a, b[j][0], b[j][1]);
    // |a| + |b| - 2 a.b
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        d[j][0] = q.norm0 + nb[j][0] - 2 * acc[j][0];
        d[j][1] = q.norm0 + nb[j][1] - 2 * acc[j][1];
        d[j][2] = q.norm1 + nb[j][0] - 2 * acc[j][2];
        d[j][3] = q.norm1 + nb[j][1] - 2 * acc[j][3];
    }
}

// The matrix: each warp reads its references straight from the read-only
// cache (the four warps of a block share them there), and takes the norms
// of its columns from the lanes that loaded them.
__global__ void __launch_bounds__(MATRIX_WARPS * 32) hamming_matrix_kernel(
    const uint4* __restrict__ a, const uint4* __restrict__ b,
    int* __restrict__ out, int N, int M) {
    const int z = blockIdx.z;
    const int m0 = blockIdx.x * 8 * NT;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.y * (16 * MATRIX_WARPS) + 16 * warp;
    a += (size_t)z * N * 2;
    b += (size_t)z * M * 2;
    out += (size_t)z * N * M;

    Queries q;
    load_queries(q, a, row0, N, lane);
    uint32_t bw[NT][2];
    int nb[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const Frag f = load_frag(b, m0 + 8 * j + g, M, t);
        bw[j][0] = f.w[0];
        bw[j][1] = f.w[1];
        nb[j][0] = __shfl_sync(FULL, f.norm, 8 * t);
        nb[j][1] = __shfl_sync(FULL, f.norm, 8 * t + 4);
    }
    int d[NT][4];
    tile_distances(d, q, bw, nb);

    const int r0 = row0 + g, r1 = r0 + 8;
    const bool pairs = (M & 1) == 0;       // two neighbouring columns as one int2
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int c0 = m0 + 8 * j + 2 * t;
        if (c0 >= M) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = h ? r1 : r0;
            if (r >= N) continue;
            int* o = out + (size_t)r * M + c0;
            if (pairs) {
                *reinterpret_cast<int2*>(o) = make_int2(d[j][2 * h], d[j][2 * h + 1]);
            } else {
                o[0] = d[j][2 * h];
                if (c0 + 1 < M) o[1] = d[j][2 * h + 1];
            }
        }
    }
}

// The pool count: the block stages the pool's references in shared memory
// once per pass, with their norms and valid flags (0 past the edge), and
// every warp reads them from there.
struct alignas(16) Staged {
    uint32_t frag[POOL_TILE * REF_PITCH];  // lane t's two words at 2 t
    int norm[POOL_TILE];
    int valid[POOL_TILE];
};

__global__ void __launch_bounds__(POOL_WARPS * 32) pool_nn_counts_kernel(
    const uint4* __restrict__ q_desc, const uint8_t* __restrict__ q_valid,
    const uint4* __restrict__ r_desc, const uint8_t* __restrict__ r_valid,
    int* __restrict__ counts, int P, int C, int Pr, int cutoff) {
    __shared__ Staged st;
    __shared__ int count;
    const int c = blockIdx.x, z = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t pool = (size_t)z * C + c;
    q_desc += (size_t)z * P * 2;
    q_valid += (size_t)z * P;
    r_desc += pool * Pr * 2;
    r_valid += pool * Pr;
    if (threadIdx.x == 0) count = 0;

    for (int qbase = 0; qbase < P; qbase += 16 * POOL_WARPS) {
        const int row0 = qbase + 16 * warp;
        Queries q;
        load_queries(q, q_desc, row0, P, lane);
        int min0 = BIG, min1 = BIG;            // rows g and g + 8 over this lane's columns
        for (int r0 = 0; r0 < Pr; r0 += POOL_TILE) {
            __syncthreads();                   // the previous pass is read
            static_assert(4 * POOL_TILE % (POOL_WARPS * 32) == 0, "slots per thread");
#pragma unroll
            for (int i = 0; i < 4 * POOL_TILE / (POOL_WARPS * 32); ++i) {
                const int r = (threadIdx.x + i * POOL_WARPS * 32) >> 2;   // quad lane t
                const Frag f = load_frag(r_desc, r0 + r, Pr, t);
                *reinterpret_cast<uint2*>(st.frag + r * REF_PITCH + 2 * t) =
                    make_uint2(f.w[0], f.w[1]);
                if (t == 0) {
                    st.norm[r] = f.norm;
                    st.valid[r] = r0 + r < Pr && r_valid[r0 + r] != 0;
                }
            }
            __syncthreads();
            if (row0 >= P) continue;           // no query rows for this warp
            const int width = min(POOL_TILE, Pr - r0);
            for (int n0 = 0; n0 < width; n0 += 8 * NT) {
                uint32_t bw[NT][2];
                int nb[NT][2];
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const uint2 v = *reinterpret_cast<const uint2*>(
                        st.frag + (n0 + 8 * j + g) * REF_PITCH + 2 * t);
                    bw[j][0] = v.x;
                    bw[j][1] = v.y;
                    nb[j][0] = st.norm[n0 + 8 * j + 2 * t];
                    nb[j][1] = st.norm[n0 + 8 * j + 2 * t + 1];
                }
                int d[NT][4];
                tile_distances(d, q, bw, nb);
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const int c0 = n0 + 8 * j + 2 * t;
                    const bool v0 = st.valid[c0], v1 = st.valid[c0 + 1];
                    min0 = min(min0, min(v0 ? d[j][0] : BIG, v1 ? d[j][1] : BIG));
                    min1 = min(min1, min(v0 ? d[j][2] : BIG, v1 ? d[j][3] : BIG));
                }
            }
        }
        if (row0 < P) {
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                min0 = min(min0, __shfl_xor_sync(FULL, min0, o));
                min1 = min(min1, __shfl_xor_sync(FULL, min1, o));
            }
            const int p0 = row0 + g, p1 = p0 + 8;
            const bool quad_lead = t == 0;
            const bool hit0 = quad_lead && p0 < P && q_valid[p0] && min0 <= cutoff;
            const bool hit1 = quad_lead && p1 < P && q_valid[p1] && min1 <= cutoff;
            const int n = __popc(__ballot_sync(FULL, hit0)) + __popc(__ballot_sync(FULL, hit1));
            if (lane == 0 && n) atomicAdd(&count, n);
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) counts[pool] = count;
}

}  // namespace

extern "C" int svi_hamming_matrix(const void* a, const void* b, void* out,
                                  int B, int N, int M, void* stream) {
    const dim3 grid((M + 8 * NT - 1) / (8 * NT),
                    (N + 16 * MATRIX_WARPS - 1) / (16 * MATRIX_WARPS), B);
    hamming_matrix_kernel<<<grid, MATRIX_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, (int*)out, N, M);
    return (int)cudaGetLastError();
}

extern "C" int svi_pool_nn_counts(const void* q_desc, const void* q_valid,
                                  const void* r_desc, const void* r_valid, void* counts,
                                  int B, int P, int C, int Pr, int cutoff, void* stream) {
    const dim3 grid(C, B);
    pool_nn_counts_kernel<<<grid, POOL_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint4*)q_desc, (const uint8_t*)q_valid, (const uint4*)r_desc,
        (const uint8_t*)r_valid, (int*)counts, P, C, Pr, cutoff);
    return (int)cudaGetLastError();
}
