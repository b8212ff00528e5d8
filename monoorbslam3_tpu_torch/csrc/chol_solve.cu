// K4: dense SPD Cholesky factor + forward/back substitution + one
// refinement step, one launch for G systems.
//
// Replaces the TPU kernel `_chol_solve_kernel` of
// monoorbslam3_tpu/ops/chol_pallas.py:40 (reached through
// `chol_solve_pallas`). Its site in the port is the reduced-camera solve of
// `schur_ba` (backend/solver.py): G Jacobi-scaled, damped SPD systems of
// D = 15 K (480 on the bench window; 1440 for the full polish's K = 96),
// G = 1 or 2.
//
// What bounds it on the H100: dependence, not bytes or FLOPs. A 480 x 480
// factor is 18 M FMAs and every panel waits for the one before. The
// one-block kernel that came first (kept below as the large-D route) spent
// 1.38 ms at D = 480 (clock64 phases, NVIDIA H100 80GB HBM3, 700 W): 408 us
// in the column-by-column panel factor (two block barriers a column), 519
// us in the trailing update (one SM, through L2), 400 us in the four
// triangular passes, 35 us in the f64 residual, 22 us loading.
//
// The cluster route (D <= 768): one thread-block cluster of C = 8 blocks of
// 512 threads per system; the padded lower triangle lives in the blocks'
// shared memory and never goes back to global memory.
//   - Ownership: 16 x 16 tiles; row block i (its 16 rows, tiles j <= i)
//     and its right-hand side block live on rank i mod C, so the shrinking
//     trailing matrix stays spread over all ranks. D is padded to a
//     multiple of 16 with identity.
//   - One cluster barrier per panel k (a cluster barrier costs ~1,350
//     cycles at 512 threads, a block barrier ~45). Before it: each rank
//     solves its own tiles of column k (L_ik = A_ik L_kk^-T, a 16 x 16
//     product with the inverse) and stores them transposed; the owner of k
//     turns its right-hand side block into y_k (the first solve's forward
//     pass rides along); the owner of k + 1 applies column k to its
//     diagonal tile (look-ahead). After it: warp 0 of every rank factors
//     the diagonal tile k + 1, final since the barrier, with shuffles in
//     registers (no block barrier per column), keeping L^-1; warps 1-15
//     copy column k from the peers (DSMEM); then the warps on the three SM
//     sub-partitions warp 0 does not use update the rank's trailing tiles
//     from shared memory in 4 x 4 FP32 micro-tiles, and warps 4, 8, 12 take
//     y_k out of the rank's right-hand side blocks.
//   - Pivots: a pivot that is not > 0 (NaN included) raises the system's
//     flag. Every rank factors every diagonal tile with the same
//     arithmetic, so every rank holds the same flag, and the rank that
//     writes x writes NaN for the whole system, as the plain version does
//     on `cholesky_ex`'s info != 0. Pivots are not clamped.
//   - Substitutions: rank 0 runs the back pass of the first solve and
//     both passes of the refinement's solve with block barriers only,
//     reading the other ranks' tiles through DSMEM; diagonal blocks are
//     applied as L_kk^-1 products, so no step has a serial chain longer
//     than a 16-term dot.
//   - Refinement: the residual b - S x is accumulated in f64 from S in
//     global memory by all ranks (each its own rows), written into rank 0,
//     and solved with the same factor. The plain version
//     (ops/chol_pallas.py) takes the same step, so kernel and plain
//     version compute the same function.
//   - No tensor cores: the work is latency-bound and the port keeps its
//     solves in full FP32 (TF32 made the BA cost worse in the JAX
//     package's history); FP32 FMAs throughout.
//   - Every block ends on a cluster barrier, so no block exits while a peer
//     may still read its shared memory.
// Where its ~0.22 ms at D = 480 goes (clock64 phases of rank 0, same card):
// ~82 us of diagonal-tile factors on the panel chain (warp 0, ~2.7 us
// each), 36 us of cluster barriers, 15 us of column solves and look-ahead,
// 70 us of substitutions (~0.8 us a step: DSMEM latency and two block
// barriers), 10 us loading, 6 us of residual.
// Capacity: the largest rank's row strips, the gathered column, two
// diagonal buffers and two vectors fit one block's 232,448 bytes of shared
// memory up to D = 768 at C = 8 (`chol_cluster_max_d`; the passes also
// keep at most 3 tiles per warp in registers, T <= 48). Above that the
// wrapper takes the large-D route.
//
// The large-D route (`chol_solve_f32`): one block of 512 threads per
// system, a blocked right-looking factor with 16-column panels staged in
// shared memory over a working copy in global memory (it stays in the 50 MB
// L2), L mirrored into the upper triangle so both substitutions read rows.
// It is bound by one SM's FMA rate and its barriers (1440^3 / 6 FMAs on
// one SM); the D = 1440 system (4.1 MB as a packed triangle) does not fit
// even a 16-block cluster's shared memory.
//
// Accuracy: an f32 Cholesky solve of the BA's reduced systems (condition
// ~1.6e3 after the Jacobi scaling) lands up to 8e-4 (relative) from the
// f64 solution, whichever library computes it. One refinement step, with
// the residual accumulated in f64 and the same factor reused, brings it
// below 1e-6.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // blocks per cluster (the portable size) of the cluster route
constexpr int kNB = 16;       // panel width and tile size
constexpr int kTile = kNB * kNB;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 4;        // rows per warp in the trailing update (large-D route)
constexpr int kSolveTiles = 3;  // tiles per warp and step in the cluster route's passes
constexpr int kClusterMaxT = kWarps * kSolveTiles;  // so the cluster route takes T <= 48
constexpr int kUpdateThreads = kThreads * 3 / 4;  // warps 1-3, 5-7, 9-11, 13-15
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// cluster route
// ---------------------------------------------------------------------------

// Row block i lives on rank i % C; its tiles (i, 0..i) are contiguous, and
// the owner's row blocks follow each other: row block o + q C starts after
// sum_{p<q} (o + p C + 1) tiles.
__device__ __forceinline__ int strip_base(int i, int C) {
  const int o = i % C;
  const int q = i / C;
  return (q * (o + 1) + C * q * (q - 1) / 2) * kTile;
}

__host__ __device__ __forceinline__ int owned_blocks(int rank, int T, int C) {
  return rank < T ? (T - 1 - rank) / C + 1 : 0;
}

__host__ __device__ __forceinline__ int owned_tiles(int rank, int T, int C) {
  const int n = owned_blocks(rank, T, C);
  return n * (rank + 1) + C * n * (n - 1) / 2;
}

// All threads of every block of the cluster call it: the block's writes
// before it are visible to every block of the cluster after it.
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cl) { cl.sync(); }

// One warp factors the 16 x 16 SPD tile at `src` (row-major, any rank's
// shared memory) and writes Li^T (Li = L^-1, DB[m * 16 + r] = Li[r][m]) to
// DB. Lane r (and r + 16) holds row r in registers. Returns false when a
// pivot is not > 0 (NaN included); the value is the same on every lane.
__device__ bool factor_diag(const float* src, float* DB) {
  const int lane = threadIdx.x & 31;
  const int r = lane & 15;
  float a[kNB];
  const float4* s4 = reinterpret_cast<const float4*>(src + r * kNB);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t = s4[q];
    a[4 * q] = t.x;
    a[4 * q + 1] = t.y;
    a[4 * q + 2] = t.z;
    a[4 * q + 3] = t.w;
  }
  // Li = L^-1 is built in the same sweep, one column behind: row c of Li
  // is final once divided by L[c][c], then the rows below take it out. Its
  // instructions fill the latency of the next pivot's shuffle and rsqrt. A
  // warp issues in order, so each group of shuffles is issued before the
  // FMAs that wait for it.
  float xr[kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) xr[j] = (j == r) ? 1.0f : 0.0f;
  auto inverse_step = [&](int c, float lc, float inv) {
    if (r == c) {
#pragma unroll
      for (int j = 0; j <= c; ++j) xr[j] *= inv;
    }
    float xc[kNB];
#pragma unroll
    for (int j = 0; j <= c; ++j) xc[j] = __shfl_sync(kFull, xr[j], c);
    if (r > c) {
#pragma unroll
      for (int j = 0; j <= c; ++j) xr[j] = fmaf(-lc, xc[j], xr[j]);
    }
  };
  bool ok = true;
  float lc_prev = 0.0f;
  float inv_prev = 0.0f;
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    const float d = __shfl_sync(kFull, a[c], c);
    if (c > 0) inverse_step(c - 1, lc_prev, inv_prev);
    ok = ok && (d > 0.0f);
    const float inv = rsqrtf(d);
    const float lc = (r > c) ? a[c] * inv : ((r == c) ? d * inv : 0.0f);
    a[c] = lc;
    float col[kNB];
#pragma unroll
    for (int j = c + 1; j < kNB; ++j) col[j] = __shfl_sync(kFull, lc, j);
#pragma unroll
    for (int j = c + 1; j < kNB; ++j) a[j] = fmaf(-lc, col[j], a[j]);
    lc_prev = lc;
    inv_prev = inv;
  }
  inverse_step(kNB - 1, lc_prev, inv_prev);
  if (lane < kNB) {
#pragma unroll
    for (int m = 0; m < kNB; ++m) DB[m * kNB + r] = xr[m];
  }
  return ok;
}

// Rank 0's forward (L y = v, when `forward`) then back (L^T x = y)
// substitution in place on its vector v, reading the tiles of every rank. Off-diagonal tiles hold
// L_ij^T, diagonal tiles Li^T. Step k of a pass: each warp sums its tiles'
// products (at most kSolveTiles), warp 0 reduces the 16 partial sums in a
// fixed order and applies the diagonal block. The remote loads of step k +
// 1 do not depend on step k's result, so they are issued before its
// barriers and their latency hides behind them. All threads of rank 0
// call it.
__device__ __forceinline__ void cluster_tri_solve(cg::cluster_group& cl, const float* tiles,
                                                  float* v, float* red, int T, int C,
                                                  bool forward) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float pre[kSolveTiles][8];
  float li[kNB];
  if (forward) {  // lane (r, h) takes rows m = 2 mm + h of each tile, column r
    const int r = lane & 15;
    const int h = lane >> 4;
    auto load_pre = [&](int k) {
      if (k >= T) return;
      const float* strip = cl.map_shared_rank(tiles, k % C) + strip_base(k, C);
#pragma unroll
      for (int t = 0; t < kSolveTiles; ++t) {
        const int j = warp + kWarps * t;
        if (j < k) {
#pragma unroll
          for (int mm = 0; mm < 8; ++mm) pre[t][mm] = strip[j * kTile + (2 * mm + h) * kNB + r];
        }
      }
    };
    auto load_li = [&](int k) {
      if (k >= T) return;
      const float* LiT = cl.map_shared_rank(tiles, k % C) + strip_base(k, C) + k * kTile;
#pragma unroll
      for (int m = 0; m < kNB; ++m) li[m] = LiT[m * kNB + r];
    };
    load_pre(0);
    if (warp == 0) load_li(0);
    for (int k = 0; k < T; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kSolveTiles; ++t) {
        const int j = warp + kWarps * t;
        if (j < k) {
#pragma unroll
          for (int mm = 0; mm < 8; ++mm) acc = fmaf(pre[t][mm], v[j * kNB + 2 * mm + h], acc);
        }
      }
      load_pre(k + 1);
      acc += __shfl_xor_sync(kFull, acc, 16);
      if (lane < kNB) red[warp * kNB + lane] = acc;
      __syncthreads();
      if (warp == 0) {
        float s = v[k * kNB + r];
        for (int w = 0; w < kWarps; ++w) s -= red[w * kNB + r];
        float sv[kNB];
#pragma unroll
        for (int m = 0; m < kNB; ++m) sv[m] = __shfl_sync(kFull, s, m);
        float y = 0.0f;
#pragma unroll
        for (int m = 0; m < kNB; ++m) y = fmaf(li[m], sv[m], y);
        if (lane < kNB) v[k * kNB + r] = y;
        load_li(k + 1);
      }
      __syncthreads();
    }
  }
  {  // back: lane (m, h) takes row m of each tile, columns 8 h .. 8 h + 7
    const int m = lane >> 1;
    const int h = lane & 1;
    const int mm = lane & 15;
    auto load_pre = [&](int k) {
      if (k < 0) return;
#pragma unroll
      for (int t = 0; t < kSolveTiles; ++t) {
        const int i = k + 1 + warp + kWarps * t;
        if (i < T) {
          const float4* p = reinterpret_cast<const float4*>(
              cl.map_shared_rank(tiles, i % C) + strip_base(i, C) + k * kTile + m * kNB + 8 * h);
          const float4 u0 = p[0];
          const float4 u1 = p[1];
          pre[t][0] = u0.x;
          pre[t][1] = u0.y;
          pre[t][2] = u0.z;
          pre[t][3] = u0.w;
          pre[t][4] = u1.x;
          pre[t][5] = u1.y;
          pre[t][6] = u1.z;
          pre[t][7] = u1.w;
        }
      }
    };
    auto load_li = [&](int k) {
      if (k < 0) return;
      const float4* p = reinterpret_cast<const float4*>(
          cl.map_shared_rank(tiles, k % C) + strip_base(k, C) + k * kTile + mm * kNB);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 u = p[q];
        li[4 * q] = u.x;
        li[4 * q + 1] = u.y;
        li[4 * q + 2] = u.z;
        li[4 * q + 3] = u.w;
      }
    };
    load_pre(T - 1);
    if (warp == 0) load_li(T - 1);
    for (int k = T - 1; k >= 0; --k) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kSolveTiles; ++t) {
        const int i = k + 1 + warp + kWarps * t;
        if (i < T) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc = fmaf(pre[t][c], v[i * kNB + 8 * h + c], acc);
        }
      }
      load_pre(k - 1);
      acc += __shfl_xor_sync(kFull, acc, 1);
      if (h == 0) red[warp * kNB + m] = acc;
      __syncthreads();
      if (warp == 0) {
        float t = v[k * kNB + mm];
        for (int w = 0; w < kWarps; ++w) t -= red[w * kNB + mm];
        float tv[kNB];
#pragma unroll
        for (int c = 0; c < kNB; ++c) tv[c] = __shfl_sync(kFull, t, c);
        float x = 0.0f;
#pragma unroll
        for (int c = 0; c < kNB; ++c) x = fmaf(li[c], tv[c], x);
        if (lane < kNB) v[k * kNB + mm] = x;
        load_li(k - 1);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
chol_cluster_kernel(const float* __restrict__ S, const float* __restrict__ b, int D, int T,
                    float* __restrict__ x) {
  // a compile-time cluster size makes every i / C and i % C of the tile
  // bookkeeping a shift
  constexpr int C = kCluster;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float4 csmem[];
  const int rank = static_cast<int>(cl.block_rank());
  const int sys = blockIdx.x / C;
  const int Dp = T * kNB;
  int most = 0;  // the largest rank's tile count sizes every block's layout
  for (int r = 0; r < C && r < T; ++r) most = max(most, owned_tiles(r, T, C));
  float* tiles = reinterpret_cast<float*>(csmem);         // own row strips
  float* P = tiles + most * kTile;                        // column k, tiles 1..T-1
  float* red = P;                                         // [16][16] solves' scratch (P is free)
  float* DB = P + max(T - 1, 1) * kTile;                  // [2] Li^T of diagonal tiles k, k+1
  float* v = DB + 2 * kTile;                              // [Dp] rank 0: rhs -> solution
  float* rv = v + Dp;                                     // [Dp] rank 0: residual -> correction
  int* bad = reinterpret_cast<int*>(rv + Dp);             // the system's flag
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long soff = static_cast<long long>(sys) * D * D;
  const float* Sg = S + soff;
  const float* bg = b + static_cast<long long>(sys) * D;
  const int nq = owned_blocks(rank, T, C);

  // ---- load the own row strips (padded with identity) ---------------------
  for (int q = 0; q < nq; ++q) {
    const int i = rank + q * C;
    const int W = (i + 1) * kNB;
    float* strip = tiles + strip_base(i, C);
    for (int e = tid; e < kNB * W; e += kThreads) {
      const int rr = e / W;
      const int col = e - rr * W;
      const int gi = i * kNB + rr;
      const float val = (gi < D && col < D) ? Sg[static_cast<long long>(gi) * D + col]
                                            : (gi == col ? 1.0f : 0.0f);
      strip[(col >> 4) * kTile + rr * kNB + (col & 15)] = val;
    }
  }
  for (int e = tid; e < nq * kNB; e += kThreads) {  // b of the own row blocks
    const int gi = (rank + (e >> 4) * C) * kNB + (e & 15);
    v[gi] = gi < D ? bg[gi] : 0.0f;
  }
  if (tid == 0) *bad = 0;
  cluster_barrier(cl);
  if (warp == 0) {
    const bool ok = factor_diag(cl.map_shared_rank(tiles, 0), DB);
    if (!ok && lane == 0) *bad = 1;
  }
  __syncthreads();

  // ---- factorization: one cluster barrier per panel -----------------------
  for (int k = 0; k < T; ++k) {
    const int q0 = k >= rank ? (k - rank) / C + 1 : 0;  // first own row block > k
    const int nb = nq - q0;
    // (b) L_ik = A_ik Li^T for the own tiles of column k, stored transposed
    const float* Dk = DB + (k & 1) * kTile;
    for (int round = 0; 2 * round < nb; ++round) {
      const int t = 2 * round + (tid >> 8);
      const int e = tid & 255;
      const int r = e >> 4;
      const int c = e & 15;
      float* tp = nullptr;
      float val = 0.0f;
      if (t < nb) {
        tp = tiles + strip_base(rank + (q0 + t) * C, C) + k * kTile;
#pragma unroll
        for (int m = 0; m < kNB; ++m) val = fmaf(tp[r * kNB + m], Dk[m * kNB + c], val);
      }
      __syncthreads();
      if (tp != nullptr) tp[c * kNB + r] = val;
    }
    __syncthreads();
    // the forward pass of the first solve rides along: the owner of k
    // turns its right-hand side block into y_k = Li_kk b_k (b_k has taken
    // out every earlier column), read by the peers after the barrier
    if (k % C == rank && warp == 1) {
      const int r = lane & 15;
      float bk[kNB];
#pragma unroll
      for (int m = 0; m < kNB; ++m) bk[m] = v[k * kNB + m];
      float y = 0.0f;
#pragma unroll
      for (int m = 0; m < kNB; ++m) y = fmaf(Dk[m * kNB + r], bk[m], y);
      __syncwarp();
      if (lane < kNB) v[k * kNB + r] = y;
    }
    // (c) look-ahead: the owner of row block k + 1 applies column k to its
    // diagonal tile, so that tile is final at the barrier
    if (k + 1 < T && (k + 1) % C == rank && tid < kTile) {
      const int r = tid >> 4;
      const int c = tid & 15;
      const float* LT = tiles + strip_base(k + 1, C) + k * kTile;
      float* A = tiles + strip_base(k + 1, C) + (k + 1) * kTile;
      float s = A[r * kNB + c];
#pragma unroll
      for (int m = 0; m < kNB; ++m) s = fmaf(-LT[m * kNB + r], LT[m * kNB + c], s);
      A[r * kNB + c] = s;
    }
    cluster_barrier(cl);
    // (e) warps 1-15 copy column k (tiles k+1 .. last own row block) from
    // the peers, and the owner of k keeps Li_kk^T in the diagonal slot for
    // the solves; meanwhile warp 0 factors the next diagonal tile, final
    // since the barrier, into the other DB buffer
    if (warp == 0) {
      if (k + 1 < T) {
        const bool ok = factor_diag(
            cl.map_shared_rank(tiles, (k + 1) % C) + strip_base(k + 1, C) + (k + 1) * kTile,
            DB + ((k + 1) & 1) * kTile);
        if (!ok && lane == 0) *bad = 1;
      }
    } else {
      const int top = nq > 0 ? rank + (nq - 1) * C : -1;
      const int n4 = top > k ? (top - k) * (kTile / 4) : 0;
      for (int e = tid - 32; e < n4; e += kThreads - 32) {
        const int j = k + 1 + (e >> 6);
        const float4* src = reinterpret_cast<const float4*>(
            cl.map_shared_rank(tiles, j % C) + strip_base(j, C) + k * kTile);
        reinterpret_cast<float4*>(P + (j - 1) * kTile)[e & 63] = src[e & 63];
      }
      if (k % C == rank && tid - 32 < kTile)
        tiles[strip_base(k, C) + k * kTile + tid - 32] = Dk[tid - 32];
      asm volatile("bar.sync 1, %0;" ::"n"(kThreads - 32) : "memory");
      // (f) update the own trailing tiles (i, j), k < j <= i, but (k+1, k+1)
      int npairs = 0;
      for (int q = q0; q < nq; ++q) {
        const int i = rank + q * C;
        npairs += (i - k) - (i == k + 1 ? 1 : 0);
      }
      // on the warps of the three SM sub-partitions warp 0 does not use, so
      // warp 0's factor has its scheduler to itself
      if ((warp & 3) == 0) {
        // warps 4, 8, 12 take y_k out of the own right-hand side blocks
        const float* yk = cl.map_shared_rank(v, k % C) + k * kNB;
        for (int idx = (warp / 4 - 1) * 32 + lane; idx < nb * kNB; idx += 96) {
          const int i = rank + (q0 + (idx >> 4)) * C;
          const int r = idx & 15;
          const float* LT = tiles + strip_base(i, C) + k * kTile;
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < kNB; ++m) s = fmaf(LT[m * kNB + r], yk[m], s);
          v[i * kNB + r] -= s;
        }
      }
      const int ut = (warp & 3) ? (warp - (warp >> 2) - 1) * 32 + lane : 16 * npairs;
      for (int w = ut; w < 16 * npairs; w += kUpdateThreads) {
        int p = w >> 4;
        int i = 0;
        int j = 0;
        for (int q = q0; q < nq; ++q) {
          i = rank + q * C;
          const int cnt = (i - k) - (i == k + 1 ? 1 : 0);
          if (p < cnt) {
            j = k + 1 + p;
            break;
          }
          p -= cnt;
        }
        const int t = w & 15;
        const int r0 = (t >> 2) * 4;
        const int c0 = (t & 3) * 4;
        const float* Pi = P + (i - 1) * kTile;
        const float* Pj = P + (j - 1) * kTile;
        float acc[4][4] = {};
#pragma unroll
        for (int m = 0; m < kNB; ++m) {
          const float4 u = *reinterpret_cast<const float4*>(Pi + m * kNB + r0);
          const float4 w4 = *reinterpret_cast<const float4*>(Pj + m * kNB + c0);
          const float ua[4] = {u.x, u.y, u.z, u.w};
          const float wa[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int xx = 0; xx < 4; ++xx) {
#pragma unroll
            for (int yy = 0; yy < 4; ++yy) acc[xx][yy] = fmaf(ua[xx], wa[yy], acc[xx][yy]);
          }
        }
        float* A = tiles + strip_base(i, C) + j * kTile;
#pragma unroll
        for (int xx = 0; xx < 4; ++xx) {
          float4* dst = reinterpret_cast<float4*>(A + (r0 + xx) * kNB + c0);
          float4 o = *dst;
          o.x -= acc[xx][0];
          o.y -= acc[xx][1];
          o.z -= acc[xx][2];
          o.w -= acc[xx][3];
          *dst = o;
        }
      }
    }
    __syncthreads();
  }
  cluster_barrier(cl);

  // ---- solve, then one refinement step with an f64 residual --------------
  if (rank == 0) {  // y from the owners, then the back pass
    for (int e = tid; e < Dp; e += kThreads) {
      const int o = (e >> 4) % C;
      if (o != 0) v[e] = cl.map_shared_rank(v, o)[e];
    }
    __syncthreads();
    cluster_tri_solve(cl, tiles, v, red, T, C, false);
  }
  cluster_barrier(cl);
  if (rank != 0) {  // the other ranks take x into their own v
    const float4* src = reinterpret_cast<const float4*>(cl.map_shared_rank(v, 0));
    for (int e = tid; e < Dp / 4; e += kThreads) reinterpret_cast<float4*>(v)[e] = src[e];
  }
  __syncthreads();
  float* rv0 = cl.map_shared_rank(rv, 0);
  for (int idx = warp; idx < nq * kNB; idx += kWarps) {
    const int gi = (rank + (idx >> 4) * C) * kNB + (idx & 15);
    double s = 0.0;
    if (gi < D) {
      const float* row = Sg + static_cast<long long>(gi) * D;
      for (int j = lane; j < D; j += 32) s += static_cast<double>(row[j]) * v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    if (lane == 0) rv0[gi] = gi < D ? static_cast<float>(static_cast<double>(bg[gi]) - s) : 0.0f;
  }
  cluster_barrier(cl);
  if (rank == 0) {
    cluster_tri_solve(cl, tiles, rv, red, T, C, true);
    const bool nan = *bad != 0;
    for (int i = tid; i < D; i += kThreads)
      x[static_cast<long long>(sys) * D + i] = nan ? __int_as_float(0x7fffffff) : v[i] + rv[i];
  }
  cluster_barrier(cl);  // no block leaves while rank 0 may read its tiles
}

size_t cluster_smem_bytes(int T, int C) {
  int most = 0;
  for (int r = 0; r < C && r < T; ++r) most = max(most, owned_tiles(r, T, C));
  return sizeof(float) * (static_cast<size_t>(kTile) * (most + max(T - 1, 1) + 2) +
                          2 * static_cast<size_t>(kNB) * T) + 16;
}

int max_smem_optin() {
  int dev = 0;
  int v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// ---------------------------------------------------------------------------
// large-D route: one block per system, working copy in L2
// ---------------------------------------------------------------------------

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
        const float yc = __shfl_sync(kFull, y, c) / pt[c * ld + c];
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
        const float xc = __shfl_sync(kFull, y, c) / pt[c * ld + k0 + c];
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
  // every thread reads every pivot, so every thread holds the same flag
  bool ok = true;

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
      const float d = pt[c * ld + c];
      ok = ok && (d > 0.0f);
      const float inv = rsqrtf(d);
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
      pt[c * ld + c] = d * rsqrtf(d);
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
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    if (lane == 0) rv[i] = static_cast<float>(static_cast<double>(bg[i]) - s);
  }
  __syncthreads();
  tri_solve(A, D, ld, pt, rv);
  for (int i = tid; i < D; i += kThreads)
    x[static_cast<long long>(blockIdx.x) * D + i] =
        ok ? v[i] + rv[i] : __int_as_float(0x7fffffff);
}

}  // namespace

// The cluster route's blocks per cluster.
extern "C" int chol_cluster_size() { return kCluster; }

// The largest D the cluster route takes on the current device (0 if none).
extern "C" int chol_cluster_max_d() {
  const int limit = max_smem_optin();
  int best = 0;
  for (int T = 1;
       T <= kClusterMaxT && cluster_smem_bytes(T, kCluster) <= static_cast<size_t>(limit); ++T)
    best = T * kNB;
  return best;
}

// Cluster route: G systems, one cluster of kCluster blocks each. Returns a
// cudaError_t; cudaErrorInvalidValue when D is above the route's capacity,
// cudaErrorInvalidConfiguration when the card cannot place the cluster.
extern "C" int chol_solve_cluster_f32(const float* S, const float* b, int g, int d, float* x,
                                      void* stream) {
  const int T = (d + kNB - 1) / kNB;
  const size_t smem = cluster_smem_bytes(T, kCluster);
  if (T > kClusterMaxT || smem > static_cast<size_t>(max_smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(chol_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g * kCluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // whether the card can place one such cluster, checked once per shape
  static size_t placed_smem = 0;
  if (placed_smem != smem) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, chol_cluster_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    placed_smem = smem;
  }
  e = cudaLaunchKernelEx(&cfg, chol_cluster_kernel, S, b, d, T, x);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Large-D route: one block per system over a working copy `work` [g, d, d].
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
