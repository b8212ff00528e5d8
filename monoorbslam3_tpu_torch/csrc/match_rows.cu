// K2: gated Hamming top-2 match, one output row per descriptor of side A.
//
// Replaces the TPU kernel `_match_kernel` of
// monoorbslam3_tpu/ops/match_pallas.py (reached through
// `_match_rows_pallas` <- `_projected_match_impl` <- `projected_match`).
// For each row a it computes, over every column b: the Hamming distance,
// the pairwise gate (both sides valid, squared pixel distance below each
// side's r^2, vocab node equal or -1), and the running best, second best
// and first-occurrence argmin.
//
// The TPU version unpacks the bits to +-1 bf16 planes and rides the matrix
// unit, and it carries (best, second, idx) across a sequential grid axis of
// column tiles. Here the distance is XOR + __popc over the 8 words, which
// is exact integer arithmetic, and the column sweep is a loop inside the
// block: blocks run in parallel in no order, so nothing may carry over
// between them.
//
// What bounds it on the H100: integer issue rate, not memory. A
// 4096 x 1024 call reads 160 KB of descriptors and per-side vectors but
// evaluates 4.2 M pairs of ~40 integer and float instructions each. The
// design spreads the pairs over many threads and keeps the column side in
// shared memory: a block of 256 threads owns 16 rows, and the 16 threads of
// a row split every 256-column tile between them with a stride of 16, so
// the threads of a warp read 16 consecutive columns (word-major layout:
// no bank conflicts) while the row descriptor stays in registers. Each
// thread keeps its own (best, second, idx) over the columns it saw, in
// increasing column order; the 16 partials of a row are merged at the end.
//
// Exactness (the plain version is `_match_rows_plain`):
//  * ties: a thread updates on strict `<` while walking its columns in
//    increasing order, so it keeps its first occurrence; the merge takes
//    the smallest index among the partials that reach the minimum.
//  * second best: each thread keeps the two smallest values of the multiset
//    it saw; the merged second is the min of the winner's second and the
//    other partials' bests. A duplicate of the best at another column
//    therefore gives second == best, as in the plain version.
//  * the gate's q = dx*dx + dy*dy uses __fmul_rn/__fadd_rn: nvcc would
//    otherwise contract it into an FMA and round once where the plain
//    version rounds twice, and `q < r2` could decide differently.
//  * sentinels: INF = 1e9 for gated pairs; idx = -1 when best >= INF.
//
// First version: simple and exact. wgmma on +-1 planes, TMA and persistent
// blocks are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kRowsPerBlock = 16;
constexpr int kSlices = 16;  // threads per row
constexpr int kThreads = kRowsPerBlock * kSlices;
constexpr int kTile = 256;   // columns per shared-memory tile
constexpr float kInf = 1e9f;

__global__ void __launch_bounds__(kThreads)
match_rows_kernel(const int* __restrict__ desc_a, const float* __restrict__ ax,
                  const float* __restrict__ ay, const float* __restrict__ r2a,
                  const float* __restrict__ ga, const float* __restrict__ va,
                  int n, const int* __restrict__ desc_b,
                  const float* __restrict__ bx, const float* __restrict__ by,
                  const float* __restrict__ r2b, const float* __restrict__ gb,
                  const float* __restrict__ vb, int m,
                  float* __restrict__ best_out, float* __restrict__ second_out,
                  int* __restrict__ idx_out) {
  __shared__ unsigned int s_desc[kWords][kTile];
  __shared__ float s_bx[kTile], s_by[kTile], s_r2[kTile], s_g[kTile],
      s_v[kTile];
  __shared__ float m_best[kRowsPerBlock][kSlices];
  __shared__ float m_second[kRowsPerBlock][kSlices];
  __shared__ int m_idx[kRowsPerBlock][kSlices];

  const int tid = threadIdx.x;
  const int slice = tid % kSlices;
  const int local_row = tid / kSlices;
  const int row = blockIdx.x * kRowsPerBlock + local_row;
  const bool live = row < n;

  unsigned int a[kWords];
  float rx = 0.f, ry = 0.f, rr2 = 0.f, rg = -1.f;
  bool rvalid = false;
  if (live) {
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      a[w] = static_cast<unsigned int>(desc_a[static_cast<long long>(row) * kWords + w]);
    rx = ax[row];
    ry = ay[row];
    rr2 = r2a[row];
    rg = ga[row];
    rvalid = va[row] > 0.f;
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) a[w] = 0u;
  }

  float best = kInf, second = kInf;
  int idx = 0x7fffffff;  // no column seen yet

  for (int base = 0; base < m; base += kTile) {
    const int cols = min(kTile, m - base);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < cols * kWords; i += kThreads) {
      const int c = i / kWords;
      const int w = i - c * kWords;
      s_desc[w][c] = static_cast<unsigned int>(
          desc_b[static_cast<long long>(base + c) * kWords + w]);
    }
    for (int c = tid; c < cols; c += kThreads) {
      s_bx[c] = bx[base + c];
      s_by[c] = by[base + c];
      s_r2[c] = r2b[base + c];
      s_g[c] = gb[base + c];
      s_v[c] = vb[base + c];
    }
    __syncthreads();
    for (int c = slice; c < cols; c += kSlices) {
      int ham = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) ham += __popc(a[w] ^ s_desc[w][c]);
      const float dx = __fsub_rn(rx, s_bx[c]);
      const float dy = __fsub_rn(ry, s_by[c]);
      const float q = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float g = s_g[c];
      const bool gate = rvalid && (s_v[c] > 0.f) && (q < rr2) && (q < s_r2[c]) &&
                        ((rg == g) || (rg < 0.f) || (g < 0.f));
      const float d = gate ? static_cast<float>(ham) : kInf;
      if (d < best) {
        second = best;
        best = d;
        idx = base + c;
      } else if (d < second) {
        second = d;
      }
    }
  }

  m_best[local_row][slice] = best;
  m_second[local_row][slice] = second;
  m_idx[local_row][slice] = idx;
  __syncthreads();

  if (slice == 0 && live) {
    // winner: the smallest value, and among equal values the lowest column
    float b = m_best[local_row][0];
    int bi = m_idx[local_row][0];
    int ws = 0;
    for (int s = 1; s < kSlices; ++s) {
      const float v = m_best[local_row][s];
      const int vi = m_idx[local_row][s];
      if (v < b || (v == b && vi < bi)) {
        b = v;
        bi = vi;
        ws = s;
      }
    }
    float sec = m_second[local_row][ws];
    for (int s = 0; s < kSlices; ++s)
      if (s != ws) sec = fminf(sec, m_best[local_row][s]);
    // an all-gated row keeps best = second = INF and reports idx = -1, as
    // the plain version does
    best_out[row] = b;
    second_out[row] = sec;
    idx_out[row] = b < kInf ? bi : -1;
  }
}

}  // namespace

extern "C" int match_rows_f32(const int* desc_a, const float* ax,
                              const float* ay, const float* r2a,
                              const float* ga, const float* va, int n,
                              const int* desc_b, const float* bx,
                              const float* by, const float* r2b,
                              const float* gb, const float* vb, int m,
                              float* best, float* second, int* idx,
                              void* stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  match_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      desc_a, ax, ay, r2a, ga, va, n, desc_b, bx, by, r2b, gb, vb, m, best,
      second, idx);
  return static_cast<int>(cudaGetLastError());
}
