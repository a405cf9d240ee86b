// K6: all-pairs Hamming distance matrix of packed 256-bit descriptors.
//
// out[z, n, m] = sum over the 8 words of popcount(a[z, n, w] ^ b[z, m, w]),
// for a [B, N, 8], b [B, M, 8] int32 bit patterns -> out [B, N, M] int32.
//
// A block computes a TILE_N x TILE_M tile of one batch entry. The tile's
// b-rows are staged in shared memory word-major (one padded row of TILE_M
// words per descriptor word), so a warp's lanes read neighbouring columns
// without bank conflicts; the tile's a-rows are staged row-major and read
// as broadcasts. A warp owns ROWS_PER_WARP a-rows; a lane owns the columns
// lane, lane + 32, ... of the tile and keeps their 8 words in registers, so
// every store of a warp is 32 neighbouring ints. N and M are ragged: rows
// and columns past the edge are staged as zeros and never written.
//
// Plain C interface: launches on the given stream, allocates nothing, does
// not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int TILE_N = 32;                  // a-rows per block
constexpr int TILE_M = 128;                 // b-rows (output columns) per block
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = TILE_N / WARPS;
constexpr int COLS_PER_LANE = TILE_M / 32;
constexpr int PITCH = TILE_M + 1;           // shared pitch of one word plane

__global__ void __launch_bounds__(WARPS * 32) hamming_matrix_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    int* __restrict__ out, int N, int M) {
    __shared__ int sa[TILE_N * WORDS];
    __shared__ int sb[WORDS * PITCH];

    const int z = blockIdx.z;
    const int n0 = blockIdx.y * TILE_N;
    const int m0 = blockIdx.x * TILE_M;
    a += (size_t)z * N * WORDS;
    b += (size_t)z * M * WORDS;
    out += (size_t)z * N * M;

    // stage the tile: consecutive threads read consecutive words
    for (int i = threadIdx.x; i < TILE_M * WORDS; i += WARPS * 32) {
        const int col = i / WORDS, w = i % WORDS;
        sb[w * PITCH + col] = (m0 + col < M) ? b[(size_t)(m0 + col) * WORDS + w] : 0;
    }
    for (int i = threadIdx.x; i < TILE_N * WORDS; i += WARPS * 32) {
        const int row = i / WORDS;
        sa[i] = (n0 + row < N) ? a[(size_t)(n0 + row) * WORDS + (i % WORDS)] : 0;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int rb[COLS_PER_LANE][WORDS];
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j)
#pragma unroll
        for (int w = 0; w < WORDS; ++w)
            rb[j][w] = sb[w * PITCH + lane + 32 * j];

#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int row = warp * ROWS_PER_WARP + r;
        const int n = n0 + row;
        if (n >= N) break;
        int ra[WORDS];
#pragma unroll
        for (int w = 0; w < WORDS; ++w) ra[w] = sa[row * WORDS + w];
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) {
            int d = 0;
#pragma unroll
            for (int w = 0; w < WORDS; ++w)
                d += __popc((unsigned)(ra[w] ^ rb[j][w]));
            const int m = m0 + lane + 32 * j;
            if (m < M) out[(size_t)n * M + m] = d;
        }
    }
}

}  // namespace

extern "C" int svi_hamming_matrix(const void* a, const void* b, void* out,
                                  int B, int N, int M, void* stream) {
    const dim3 grid((M + TILE_M - 1) / TILE_M, (N + TILE_N - 1) / TILE_N, B);
    hamming_matrix_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, (int*)out, N, M);
    return (int)cudaGetLastError();
}
