// K4: dense SPD Cholesky factor + forward/back substitution, one launch.
//
// Replaces the TPU kernel `_chol_solve_kernel` of
// monoorbslam3_tpu/ops/chol_pallas.py (reached through
// `chol_solve_pallas`). Its site in the port is the reduced-camera solve of
// `schur_ba` (backend/solver.py): G Jacobi-scaled, damped SPD systems of
// D = 15 K (480 on the bench window), G = 1 or 2.
//
// What bounds it on the H100: dependence, not bytes or FLOPs. A 480 x 480
// factor is 18 MFLOP and 0.92 MB, more than one SM's 227 KB of shared
// memory, and every column depends on the one before. The TPU kernel's
// 8-row one-hot panels exist only for Mosaic's 8-row dynamic indexing and
// are not carried over. The design here is one block of 512 threads per
// system and a blocked right-looking Cholesky on a global-memory working
// copy (it stays in the 50 MB L2):
//   - per panel of NB = 16 columns, the panel's rows are staged in shared
//     memory, transposed (pt[c * ld + r], ld = D rounded up to 32, plus 1,
//     so column reads by consecutive lanes hit distinct banks), and
//     factored there column by column with two block barriers a column;
//   - the factored panel is written to the lower triangle and mirrored
//     into the upper one (row k of the upper triangle is then column k of
//     L, so both substitutions read rows, coalesced);
//   - the trailing lower triangle takes the rank-NB update in one pass:
//     each warp owns 4 rows at a time (their 16 panel values in
//     registers), lanes walk the columns and read the panel column from
//     shared memory, and each element is read and written once per panel.
// The substitutions go panel by panel too: one warp solves the 16 x 16
// diagonal block with shuffles, then the block applies its 16 solved
// values to the rest of the right-hand side.
// Pivots are clamped at 1e-30 before rsqrt, as in the TPU kernel.
//
// Accuracy: an f32 Cholesky solve of the BA's reduced systems (condition
// ~1.6e3 after the Jacobi scaling) lands up to 8e-4 (relative) from the
// f64 solution, whichever library computes it. One refinement step, with
// the residual b - S x accumulated in f64 and the same factor reused,
// brings it below 1e-6. The plain version (ops/chol_pallas.py) takes the
// same step, so kernel and plain version compute the same function.
//
// Later work: spread one system over a cluster (DSMEM) or several blocks,
// so more than one SM per system works on the trailing update.

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 16;       // panel width
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 4;        // rows per warp in the trailing update

// Forward (L y = v) then back (L^T x = y) substitution in place on the
// shared vector v, panel by panel. A holds L in its lower triangle and L^T
// in its upper one, so both passes stage whole rows. All threads call it.
__device__ void tri_solve(const float* __restrict__ A, int D, int ld, float* pt,
                          float* v) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // forward: column k of L is row k of the upper triangle
  for (int k0 = 0; k0 < D; k0 += kNB) {
    const int nb = min(kNB, D - k0);
    const int m = D - k0;
    for (int e = tid; e < m * nb; e += kThreads) {
      const int c = e / m;
      const int jj = e - c * m;
      pt[c * ld + jj] = A[static_cast<long long>(k0 + c) * D + k0 + jj];
    }
    __syncthreads();
    if (warp == 0) {
      float y = (lane < nb) ? v[k0 + lane] : 0.0f;
      for (int c = 0; c < nb; ++c) {
        const float yc = __shfl_sync(0xffffffffu, y, c) / pt[c * ld + c];
        if (lane == c) {
          y = yc;
        } else if (lane > c && lane < nb) {
          y -= pt[c * ld + lane] * yc;
        }
      }
      if (lane < nb) v[k0 + lane] = y;
    }
    __syncthreads();
    for (int jj = nb + tid; jj < m; jj += kThreads) {
      float s = v[k0 + jj];
      for (int c = 0; c < nb; ++c) s -= pt[c * ld + jj] * v[k0 + c];
      v[k0 + jj] = s;
    }
    __syncthreads();
  }
  // back: row k of L is row k of the lower triangle
  for (int k0 = ((D - 1) / kNB) * kNB; k0 >= 0; k0 -= kNB) {
    const int nb = min(kNB, D - k0);
    const int w = k0 + nb;  // columns 0 .. w-1 of rows k0 .. k0+nb-1
    for (int e = tid; e < nb * w; e += kThreads) {
      const int c = e / w;
      const int j = e - c * w;
      pt[c * ld + j] = A[static_cast<long long>(k0 + c) * D + j];
    }
    __syncthreads();
    if (warp == 0) {
      float y = (lane < nb) ? v[k0 + lane] : 0.0f;
      for (int c = nb - 1; c >= 0; --c) {
        const float xc = __shfl_sync(0xffffffffu, y, c) / pt[c * ld + k0 + c];
        if (lane == c) {
          y = xc;
        } else if (lane < c) {
          y -= pt[c * ld + k0 + lane] * xc;
        }
      }
      if (lane < nb) v[k0 + lane] = y;
    }
    __syncthreads();
    for (int i = tid; i < k0; i += kThreads) {
      float s = v[i];
      for (int c = 0; c < nb; ++c) s -= pt[c * ld + i] * v[k0 + c];
      v[i] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ b,
                  int D, int ld, float* __restrict__ work,
                  float* __restrict__ x) {
  extern __shared__ float smem[];
  float* pt = smem;             // [kNB][ld] staged panel, transposed
  float* v = smem + kNB * ld;   // [D] right-hand side -> solution
  float* rv = v + D;            // [D] refinement residual -> correction
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long off = static_cast<long long>(blockIdx.x) * D * D;
  const float* Sg = S + off;
  float* A = work + off;

  for (int i = tid; i < D * D; i += kThreads) A[i] = Sg[i];
  for (int i = tid; i < D; i += kThreads) v[i] = b[static_cast<long long>(blockIdx.x) * D + i];
  __syncthreads();

  // ---- factorization -----------------------------------------------------
  for (int k0 = 0; k0 < D; k0 += kNB) {
    const int nb = min(kNB, D - k0);
    const int m = D - k0;
    // stage rows k0.. of the panel's columns (lower triangle is current)
    for (int e = tid; e < m * nb; e += kThreads) {
      const int r = e / nb;
      const int c = e - r * nb;
      pt[c * ld + r] = A[static_cast<long long>(k0 + r) * D + k0 + c];
    }
    __syncthreads();
    for (int c = 0; c < nb; ++c) {
      // the pivot is read here and only rewritten after the panel loop
      const float inv = rsqrtf(fmaxf(pt[c * ld + c], 1e-30f));
      for (int r = c + 1 + tid; r < m; r += kThreads) pt[c * ld + r] *= inv;
      __syncthreads();
      const int span = m;
      for (int e = tid; e < (nb - c - 1) * span; e += kThreads) {
        const int cc = c + 1 + e / span;
        const int r = e - (cc - c - 1) * span;
        if (r >= cc) pt[cc * ld + r] -= pt[c * ld + r] * pt[c * ld + cc];
      }
      __syncthreads();
    }
    for (int c = tid; c < nb; c += kThreads) {
      const float d = pt[c * ld + c];
      pt[c * ld + c] = d * rsqrtf(fmaxf(d, 1e-30f));
    }
    __syncthreads();
    // write back: lower triangle (row-wise) and its mirror (row k0 + c of
    // the upper triangle = column k0 + c of L)
    for (int e = tid; e < m * nb; e += kThreads) {
      const int r = e / nb;
      const int c = e - r * nb;
      if (r >= c) A[static_cast<long long>(k0 + r) * D + k0 + c] = pt[c * ld + r];
    }
    for (int e = tid; e < m * nb; e += kThreads) {
      const int c = e / m;
      const int r = e - c * m;
      if (r >= c) A[static_cast<long long>(k0 + c) * D + k0 + r] = pt[c * ld + r];
    }
    // trailing update of the lower triangle: rows/cols k0+nb .. D-1
    for (int r0 = nb + warp * kRB; r0 < m; r0 += kWarps * kRB) {
      float a[kRB][kNB];
#pragma unroll
      for (int q = 0; q < kRB; ++q) {
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          a[q][c] = (c < nb && r0 + q < m) ? pt[c * ld + r0 + q] : 0.0f;
      }
      const int jmax = min(r0 + kRB - 1, m - 1);
      for (int jj = nb + lane; jj <= jmax; jj += 32) {
        // start the L2 reads of the 4 targets before the FMAs, so their
        // latency hides behind the arithmetic
        float old[kRB], acc[kRB];
#pragma unroll
        for (int q = 0; q < kRB; ++q) {
          const int r = r0 + q;
          old[q] = (r < m && jj <= r) ? A[static_cast<long long>(k0 + r) * D + k0 + jj] : 0.0f;
          acc[q] = 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kNB; ++c) {
          const float bj = (c < nb) ? pt[c * ld + jj] : 0.0f;
#pragma unroll
          for (int q = 0; q < kRB; ++q) acc[q] = fmaf(a[q][c], bj, acc[q]);
        }
#pragma unroll
        for (int q = 0; q < kRB; ++q) {
          const int r = r0 + q;
          if (r < m && jj <= r) A[static_cast<long long>(k0 + r) * D + k0 + jj] = old[q] - acc[q];
        }
      }
    }
    __syncthreads();
  }

  // ---- solve, then one refinement step with an f64 residual ------------
  tri_solve(A, D, ld, pt, v);
  const float* bg = b + static_cast<long long>(blockIdx.x) * D;
  for (int i = warp; i < D; i += kWarps) {
    const float* row = Sg + static_cast<long long>(i) * D;
    double s = 0.0;
    for (int j = lane; j < D; j += 32) s += static_cast<double>(row[j]) * v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) rv[i] = static_cast<float>(static_cast<double>(bg[i]) - s);
  }
  __syncthreads();
  tri_solve(A, D, ld, pt, rv);
  for (int i = tid; i < D; i += kThreads)
    x[static_cast<long long>(blockIdx.x) * D + i] = v[i] + rv[i];
}

}  // namespace

extern "C" int chol_solve_f32(const float* S, const float* b, int g, int d,
                              float* work, float* x, void* stream) {
  const int ld = ((d + 31) & ~31) + 1;
  const size_t smem = (static_cast<size_t>(kNB) * ld + 2 * d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chol_solve_kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      S, b, d, ld, work, x);
  return static_cast<int>(cudaGetLastError());
}
