// K3: the dense Hamming-distance block.
//
// Replaces the TPU kernel `_hamming_kernel` of
// monoorbslam3_tpu/ops/pallas_kernels.py (reached through
// `hamming_matrix_pallas`): [N, 8] x [M, 8] 32-bit descriptor words ->
// [N, M] int32 distances, XOR + popcount summed over the 8 words. The TPU
// version tiles 256 x 256 through VMEM and materialises the [256, 256, 8]
// XOR there. In the mapper it feeds `masked_nn_match` in the triangulation
// and fuse searches (N, M = 1024).
//
// What bounds it on the H100: the output. Each distance is 8 XOR + 8
// popcount + 7 adds on 64 input bytes that are reused across a whole tile,
// and 4 output bytes that are not; at 1024 x 1024 it writes 4 MB. The
// design keeps the input traffic off the critical path and the writes
// coalesced: a block of 256 threads owns a 64 x 64 output tile, stages the
// tile's 64 row and 64 column descriptors in shared memory (2 KB each),
// and each thread keeps one column's 8 words in registers and walks 16
// rows, whose words every lane of the warp reads at the same address (a
// broadcast). Consecutive lanes write consecutive columns of a row. The
// column stage is padded to 9 words a row so the register load is free of
// bank conflicts.
//
// Integer arithmetic only: the result is bit-exact to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 16

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const unsigned* __restrict__ a, int n,
               const unsigned* __restrict__ b, int m,
               int* __restrict__ out) {
  __shared__ unsigned sa[kTile][kWords];
  __shared__ unsigned sb[kTile][kWords + 1];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  for (int e = tid; e < kTile * kWords; e += kThreads) {
    const int r = e / kWords;
    const int w = e - r * kWords;
    sa[r][w] = (row0 + r < n) ? a[static_cast<long long>(row0 + r) * kWords + w] : 0u;
    sb[r][w] = (col0 + r < m) ? b[static_cast<long long>(col0 + r) * kWords + w] : 0u;
  }
  __syncthreads();

  const int tx = tid % kTile;
  const int ty = tid / kTile;
  const int j = col0 + tx;
  unsigned bw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) bw[w] = sb[tx][w];
#pragma unroll 4
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = ty * kRowsPerThread + q;
    const int i = row0 + r;
    int d = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) d += __popc(sa[r][w] ^ bw[w]);
    if (i < n && j < m) out[static_cast<long long>(i) * m + j] = d;
  }
}

}  // namespace

extern "C" int hamming_i32(const void* desc_a, int n, const void* desc_b, int m,
                           int* out, void* stream) {
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(desc_a), n, static_cast<const unsigned*>(desc_b), m, out);
  return static_cast<int>(cudaGetLastError());
}
