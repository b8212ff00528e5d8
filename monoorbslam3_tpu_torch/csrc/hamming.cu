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
// What bounds it on the H100: the output. At 1024 x 1024 it reads 64 KB of
// descriptors and writes 4 MB, 1.25 us at 3.35 TB/s; the distances, as a
// depth-256 binary product, are 0.27 us at the int8 tensor peak.
//
// The design keeps the arithmetic off the critical path and the writes
// whole:
//  * the distances run on the tensor cores, exactly, as in K2
//    (`match_rows.cu`): `mma.sync.m16n8k256.b1` with `.and.popc` gives
//    popc(a & b) for 16 rows x 8 columns, and popc(a ^ b) = popc(a) +
//    popc(b) - 2 popc(a & b) with each side's popcount computed once;
//  * a block of 4 warps owns a 64 x 64 output tile (256 blocks at
//    1024 x 1024); warp w computes rows 16w..16w+15 over the tile's 8
//    n-tiles, whose column words it reads from shared memory (stored in the
//    order 0 4 1 5 2 6 3 7, so a lane's B fragment is one 8-byte load);
//  * the fragments go to a shared-memory copy of the tile, and the block
//    then writes it back row by row in 16-byte stores: each output row of
//    the tile is 256 contiguous bytes. A ragged tile, or a row pitch that
//    is not a multiple of 16 bytes, is written one int at a time.
//
// Integer arithmetic only: the result is bit-exact to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kTile = 64;
constexpr int kWarps = kTile / 16;  // one m-tile of 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPitch = kTile + 8;  // shared output tile row, in ints: a half-warp's
                                   // 8-byte fragment stores hit 32 distinct banks

__device__ __forceinline__ void mma_and_popc(unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                             uint2 b, int (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y), "r"(0), "r"(0), "r"(0),
        "r"(0));
}

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const unsigned* __restrict__ a, int n,
               const unsigned* __restrict__ b, int m,
               int* __restrict__ out) {
  __shared__ __align__(16) unsigned s_b[kTile * kWords];  // words 0 4 1 5 2 6 3 7
  __shared__ int s_pop[kTile];
  __shared__ __align__(16) int s_out[kTile * kPitch];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the tile's columns, one thread each
  if (tid < kTile) {
    const int col = col0 + tid;
    unsigned w[kWords];
    int pop = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      w[k] = col < m ? __ldg(b + static_cast<long long>(col) * kWords + k) : 0u;
      pop += __popc(w[k]);
    }
    uint4* s = reinterpret_cast<uint4*>(s_b + tid * kWords);
    s[0] = make_uint4(w[0], w[4], w[1], w[5]);
    s[1] = make_uint4(w[2], w[6], w[3], w[7]);
    s_pop[tid] = pop;
  }

  // this lane's A fragment: words t and t + 4 of rows g and g + 8 of the
  // warp's m-tile, and the two rows' popcounts (summed over the quad)
  unsigned af[4];
  int pa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + 8 * h;
    const unsigned* d = a + static_cast<long long>(row < n ? row : 0) * kWords;
    af[h] = row < n ? __ldg(d + t) : 0u;
    af[2 + h] = row < n ? __ldg(d + t + 4) : 0u;
    int pop = __popc(af[h]) + __popc(af[2 + h]);
    pop += __shfl_xor_sync(0xffffffffu, pop, 1);
    pop += __shfl_xor_sync(0xffffffffu, pop, 2);
    pa[h] = pop;
  }
  __syncthreads();

#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int nb = nt * 8;
    const uint2 bf = *reinterpret_cast<const uint2*>(s_b + (nb + g) * kWords + 2 * t);
    int acc[4];
    mma_and_popc(af[0], af[1], af[2], af[3], bf, acc);
    const int2 pb = *reinterpret_cast<const int2*>(s_pop + nb + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      *reinterpret_cast<int2*>(s_out + r * kPitch + nb + 2 * t) =
          make_int2(pa[h] + pb.x - 2 * acc[2 * h], pa[h] + pb.y - 2 * acc[2 * h + 1]);
    }
  }
  __syncthreads();

  const bool whole = row0 + kTile <= n && col0 + kTile <= m && (m & 3) == 0;
  if (whole) {
    constexpr int kChunks = kTile / 4;  // 16-byte chunks of a tile row
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 4;
      *reinterpret_cast<int4*>(out + static_cast<long long>(row0 + r) * m + col0 + c) =
          *reinterpret_cast<const int4*>(s_out + r * kPitch + c);
    }
  } else {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile;
      const int c = e - r * kTile;
      if (row0 + r < n && col0 + c < m)
        out[static_cast<long long>(row0 + r) * m + col0 + c] = s_out[r * kPitch + c];
    }
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
