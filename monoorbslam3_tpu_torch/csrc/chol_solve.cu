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
// one-block kernel that came first (one SM per system) spent 1.38 ms at
// D = 480 (clock64 phases, NVIDIA H100 80GB HBM3, 700 W): 408 us in the
// column-by-column panel factor (two block barriers a column), 519 us in
// the trailing update (one SM, through L2), 400 us in the four triangular
// passes, 35 us in the f64 residual, 22 us loading; and 15.3 ms at
// D = 1440. Both routes below spread a system over several SMs and keep
// the chain of panels short.
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
//
// The large-D route (`chol_solve_grid_f32`, any D; the wrapper takes it
// above the cluster route's capacity): one cooperative launch of one block
// of 512 threads per SM (`cudaLaunchCooperativeKernel`; the entry point
// checks with the occupancy API that the grid is resident at once and
// returns an error, not a launch, if it is not), grid barriers of
// cooperative groups (1.14 us each, measured with an empty kernel of 90 and
// of 900 barriers: `chol_grid_sync_probe`). The D = 1440 triangle (4.1 MB
// packed) fits no cluster's shared memory, so it lives in a work buffer in
// global memory as 16 x 16 tiles (1 KB each, L transposed), which stays in
// the 50 MB L2; every read of another block's writes goes through L2
// (`__ldcg` / `__stcg`), since an SM's L1 is not coherent with the others'.
//   - Ownership: none. Between two grid barriers no tile is written by one
//     task and touched by another (experiments/port_chol_grid_emulate.py
//     checks the schedule in numpy), so each phase deals its tiles over
//     all warps anew: warps 1-15 of every block take tile tasks round
//     robin, consecutive tasks on different SMs; warp 0 of every block
//     runs the chain.
//   - One grid barrier per panel. Phase k: warp 0 of EVERY block builds
//     diagonal tile k + 1 (its value through panel k - 1, minus panel k's
//     product: look-ahead) and factors it in registers (`factor_diag`,
//     shared with the cluster route), keeping L^-1; so every block holds
//     Li_{k+1} and the same non-SPD flag without a broadcast. Meanwhile
//     the other warps apply panel k to the trailing tiles (i, j),
//     j >= k + 2, and take y_k out of the right-hand side blocks (the
//     first solve's forward pass rides along). After a block barrier the
//     tiles of column k + 1 take panel k's update and are multiplied by
//     Li_{k+1}^T at once, so column k + 1 is final at the grid barrier.
//   - Pivots: as on the cluster route, a pivot that is not > 0 (NaN
//     included) raises the flag; the leader block, which writes x, holds
//     it like every other block, so no flag word crosses the work buffer
//     (which may hold anything at launch: every word is written before it
//     is read).
//   - Substitutions: the leader block (block 0 of the system's share) runs
//     the back pass and the refinement's two passes with block barriers
//     only, streaming L from L2; each warp prefetches the tiles of step
//     k + 1 into registers before step k's barriers, diagonal blocks are
//     applied as Li products. The f64 residual is spread over all blocks
//     between two grid barriers.
//   - G >= 2: the grid is split between two systems at a time (66 SMs
//     each), which share every barrier; more systems run in batches of
//     two inside the one launch. The kernel is bound by its chain of
//     barriers and latencies, not by arithmetic, so two systems side by
//     side cost 1.11x one (0.94 against 0.85 ms at D = 1440), where running
//     them in turn would cost 2x.
//   - Arithmetic: FP32 FMAs, every output element accumulated by one
//     thread in a fixed order, no atomics: two runs give the same bits. A
//     panel's 16 products are summed before they leave an entry
//     (`rank_update`), as the emulation and the cluster route do.
// Where its 0.85 ms at D = 1440, G = 1 goes (block 0's clock64 spans,
// `chol_solve_grid_clocks_f32`, same card): 37 us loading S into tiles,
// 489 us in the 91 factor phases (5.4 us each: a grid barrier, an L2 round
// trip, the 16 x 16 factor, a block barrier, a column tile), 101 us in the
// back pass (1.1 us a step), 6 us of residual, 224 us in the refinement's
// two passes. At D = 769: 12 / 244 / 49 / 3 / 94 us.
//
// Accuracy: an f32 Cholesky solve of the BA's reduced systems (condition
// ~1.6e3 after the Jacobi scaling) lands up to 8e-4 (relative) from the
// f64 solution, whichever library computes it. One refinement step, with
// the residual accumulated in f64 and the same factor reused, brings it
// below 1e-6. The bench polish window's systems (D = 1440, one anchor,
// condition ~4.8e4) are further out: 2e-4 to 6e-4 after the step, for this
// kernel and for the library's Cholesky alike (chip_smoke.py prints both).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // blocks per cluster (the portable size) of the cluster route
constexpr int kNB = 16;       // panel width and tile size
constexpr int kTile = kNB * kNB;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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
// grid route: each system spread over the card, one cooperative launch
// ---------------------------------------------------------------------------

constexpr int kGridSys = 2;  // systems factored side by side, each on its share of the blocks
constexpr int kPre = 6;      // tiles a warp prefetches per substitution step

// Tile (i, j), j <= i, of the packed lower triangle in the work buffer.
__device__ __forceinline__ long long tile_off(int i, int j) {
  return (static_cast<long long>(i) * (i + 1) / 2 + j) * kTile;
}

// Row and column of entry t of a packed lower triangle (t = i (i + 1) / 2 + j).
__device__ __forceinline__ void tri_index(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  j = t - i * (i + 1) / 2;
}

// Everything one block reads that another block wrote goes through L2
// (`__ldcg` / `__stcg`): an SM's L1 is not coherent with the other SMs'.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  __stcg(reinterpret_cast<float4*>(p), v);
}

// One warp: the lane's 8 entries a[] of a tile (row lane / 2, columns
// 8 (lane % 2) ..) minus L_i L_j^T, from the transposed tiles LT_i, LT_j in
// global memory, staged through the warp's scratch `sc` (two tiles). The 16
// products are summed first and leave the entry in one subtraction: taken
// out one by one, a product below half an ulp of the entry (a far panel's,
// |L| < 2.4e-4 against an entry near 1) is rounded away every time, always
// in the same direction, and over 90 panels the lost sum biases the Schur
// complements upward. On the full polish built from a map store (D = 1440,
// condition ~9e4) that left the refined solve 2e-3 from float64 on an H100
// (NVIDIA H100 80GB HBM3, 700 W) where the library's Cholesky lands at
// 8e-6; `experiments/port_chol_grid_emulate.py --store` reproduces both
// orders. The cluster route already summed first.
__device__ __forceinline__ void rank_update(const float* LTi, const float* LTj, float* sc,
                                            float (&a)[8]) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
  float4* s4 = reinterpret_cast<float4*>(sc);
  __syncwarp();
  s4[lane] = ld4(LTi + 4 * lane);
  s4[lane + 32] = ld4(LTi + 4 * (lane + 32));
  s4[lane + 64] = ld4(LTj + 4 * lane);
  s4[lane + 96] = ld4(LTj + 4 * (lane + 32));
  __syncwarp();
  float acc[8] = {};
#pragma unroll
  for (int m = 0; m < kNB; ++m) {
    const float u = sc[m * kNB + r];
    const float4 w0 = *reinterpret_cast<const float4*>(sc + kTile + m * kNB + c0);
    const float4 w1 = *reinterpret_cast<const float4*>(sc + kTile + m * kNB + c0 + 4);
    acc[0] = fmaf(u, w0.x, acc[0]);
    acc[1] = fmaf(u, w0.y, acc[1]);
    acc[2] = fmaf(u, w0.z, acc[2]);
    acc[3] = fmaf(u, w0.w, acc[3]);
    acc[4] = fmaf(u, w1.x, acc[4]);
    acc[5] = fmaf(u, w1.y, acc[5]);
    acc[6] = fmaf(u, w1.z, acc[6]);
    acc[7] = fmaf(u, w1.w, acc[7]);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) a[q] -= acc[q];
  __syncwarp();
}

__device__ __forceinline__ void load_entries(const float* tile, float (&a)[8]) {
  const int lane = threadIdx.x & 31;
  const float4 a0 = ld4(tile + 8 * lane);
  const float4 a1 = ld4(tile + 8 * lane + 4);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
}

__device__ __forceinline__ void store_entries(float* tile, const float (&a)[8], bool global) {
  const int lane = threadIdx.x & 31;
  const float4 a0 = make_float4(a[0], a[1], a[2], a[3]);
  const float4 a1 = make_float4(a[4], a[5], a[6], a[7]);
  if (global) {
    st4(tile + 8 * lane, a0);
    st4(tile + 8 * lane + 4, a1);
  } else {
    *reinterpret_cast<float4*>(tile + 8 * lane) = a0;
    *reinterpret_cast<float4*>(tile + 8 * lane + 4) = a1;
  }
}

// The leader block's forward (L z = v, when `forward`) then back
// (L^T x = z) substitution in place on its shared vector v, streaming the
// transposed tiles L_ij^T and the diagonal blocks' Li^T from L2. A step's
// tiles are spread over the warps; each warp sums its products, warp 0
// reduces the 16 partial sums in a fixed order and applies the diagonal
// block as a product. The loads of step k + 1 do not depend on step k's
// result: the first kPre tiles of each warp are requested before step
// k's barriers. All threads of the block call it.
__device__ __forceinline__ void grid_tri_solve(const float* tiles, const float* dinv, float* v,
                                               float* red, int T, bool forward) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float pre[kPre][8];
  float li[kNB];
  if (forward) {  // lane (r, h) takes rows m = 2 mm + h of each tile, column r
    const int r = lane & 15;
    const int h = lane >> 4;
    auto load_pre = [&](int k) {
      if (k >= T) return;
      const float* row = tiles + tile_off(k, 0);
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const int j = warp + kWarps * t;
        if (j < k) {
#pragma unroll
          for (int mm = 0; mm < 8; ++mm)
            pre[t][mm] = __ldcg(row + j * kTile + (2 * mm + h) * kNB + r);
        }
      }
    };
    auto load_li = [&](int k) {
      if (k >= T) return;
      const float* LiT = dinv + k * kTile;
#pragma unroll
      for (int m = 0; m < kNB; ++m) li[m] = __ldcg(LiT + m * kNB + r);
    };
    load_pre(0);
    if (warp == 0) load_li(0);
    for (int k = 0; k < T; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const int j = warp + kWarps * t;
        if (j < k) {
#pragma unroll
          for (int mm = 0; mm < 8; ++mm) acc = fmaf(pre[t][mm], v[j * kNB + 2 * mm + h], acc);
        }
      }
      for (int j = warp + kWarps * kPre; j < k; j += kWarps) {  // past the prefetch
        const float* tp = tiles + tile_off(k, j);
#pragma unroll
        for (int mm = 0; mm < 8; ++mm)
          acc = fmaf(__ldcg(tp + (2 * mm + h) * kNB + r), v[j * kNB + 2 * mm + h], acc);
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
      for (int t = 0; t < kPre; ++t) {
        const int i = k + 1 + warp + kWarps * t;
        if (i < T) {
          const float* p = tiles + tile_off(i, k) + m * kNB + 8 * h;
          const float4 u0 = ld4(p);
          const float4 u1 = ld4(p + 4);
          pre[t][0] = u0.x; pre[t][1] = u0.y; pre[t][2] = u0.z; pre[t][3] = u0.w;
          pre[t][4] = u1.x; pre[t][5] = u1.y; pre[t][6] = u1.z; pre[t][7] = u1.w;
        }
      }
    };
    auto load_li = [&](int k) {
      if (k < 0) return;
      const float* p = dinv + k * kTile + mm * kNB;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 u = ld4(p + 4 * q);
        li[4 * q] = u.x; li[4 * q + 1] = u.y; li[4 * q + 2] = u.z; li[4 * q + 3] = u.w;
      }
    };
    load_pre(T - 1);
    if (warp == 0) load_li(T - 1);
    for (int k = T - 1; k >= 0; --k) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const int i = k + 1 + warp + kWarps * t;
        if (i < T) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc = fmaf(pre[t][c], v[i * kNB + 8 * h + c], acc);
        }
      }
      for (int i = k + 1 + warp + kWarps * kPre; i < T; i += kWarps) {  // past the prefetch
        const float* p = tiles + tile_off(i, k) + m * kNB + 8 * h;
        const float4 u0 = ld4(p);
        const float4 u1 = ld4(p + 4);
        const float* vi = v + i * kNB + 8 * h;
        acc = fmaf(u0.x, vi[0], acc); acc = fmaf(u0.y, vi[1], acc);
        acc = fmaf(u0.z, vi[2], acc); acc = fmaf(u0.w, vi[3], acc);
        acc = fmaf(u1.x, vi[4], acc); acc = fmaf(u1.y, vi[5], acc);
        acc = fmaf(u1.z, vi[6], acc); acc = fmaf(u1.w, vi[7], acc);
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

// Floats of one system's work area: the packed tiles, Li^T of every
// diagonal tile, and four vectors (working right-hand side, y, x, residual).
__host__ __device__ __forceinline__ long long grid_work_floats(int T) {
  return (static_cast<long long>(T) * (T + 1) / 2 + T) * kTile + 4LL * T * kNB;
}

size_t grid_smem_bytes(int T) {
  return sizeof(float) * (static_cast<size_t>(kWarps) * 2 * kTile + 2 * kTile + kWarps * kNB +
                          2 * static_cast<size_t>(T) * kNB) + 16;
}

__global__ void __launch_bounds__(kThreads, 1)
chol_grid_kernel(const float* __restrict__ S, const float* __restrict__ b, int G, int D, int T,
                 float* work, float* __restrict__ x, long long* clocks) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 gsmem[];
  const int Dp = T * kNB;
  float* scratch = reinterpret_cast<float*>(gsmem);  // [kWarps][2 tiles]
  float* DB = scratch + kWarps * 2 * kTile;          // [2] Li^T of diagonal tiles k, k + 1
  float* red = DB + 2 * kTile;                       // [kWarps][16] the solves' partial sums
  float* v = red + kWarps * kNB;                     // [Dp] leader: y -> solution
  float* rv = v + Dp;                                // [Dp] x for the residual; leader: residual -> correction
  int* bad = reinterpret_cast<int*>(rv + Dp);        // the system's flag
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* sc = scratch + warp * 2 * kTile;
  // the blocks are split evenly between the systems of a batch; warp 0 of
  // every block runs the panel chain, warps 1-15 of a system's blocks
  // share its tiles (consecutive tasks land on different blocks)
  const int per = min(G, kGridSys);
  const int bps = gridDim.x / per;
  const int slot = blockIdx.x / bps;
  const int lb = blockIdx.x - slot * bps;
  const int nw = bps * (kWarps - 1);
  const int gw = (warp - 1) * bps + lb;
  const bool timed = clocks != nullptr && blockIdx.x == 0 && tid == 0;
  long long t_prev = timed ? clock64() : 0;
  auto stamp = [&](int phase) {
    if (timed) {
      const long long now = clock64();
      clocks[phase] += now - t_prev;
      t_prev = now;
    }
  };

  for (int base = 0; base < G; base += per) {
    const int sys = base + slot;
    const bool active = slot < per && sys < G;
    const float* Sg = S + static_cast<long long>(active ? sys : 0) * D * D;
    const float* bg = b + static_cast<long long>(active ? sys : 0) * D;
    float* tiles = work + static_cast<long long>(active ? sys : 0) * grid_work_floats(T);
    float* dinv = tiles + static_cast<long long>(T) * (T + 1) / 2 * kTile;
    float* bw = dinv + static_cast<long long>(T) * kTile;  // right-hand side, panels taken out
    float* yv = bw + Dp;                                   // y = L^-1 b
    float* xg = yv + Dp;                                   // the first solve's x
    float* rg = xg + Dp;                                   // the residual b - S x

    // ---- load: S into 16 x 16 tiles of the lower triangle, padded with identity
    if (active) {
      if (tid == 0) *bad = 0;
      const int ntile = T * (T + 1) / 2;
      const int r = lane >> 1;
      const int c0 = (lane & 1) * 8;
      for (int t = tid >> 5; t < ntile; t += kWarps) {
        if (t % bps != lb) continue;
        int i, j;
        tri_index(t, i, j);
        const int gi = i * kNB + r;
        float a[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int gj = j * kNB + c0 + q;
          a[q] = (gi < D && gj < D) ? Sg[static_cast<long long>(gi) * D + gj]
                                    : (gi == gj ? 1.0f : 0.0f);
        }
        store_entries(tiles + static_cast<long long>(t) * kTile, a, true);
      }
      for (int e = lb * kThreads + tid; e < Dp; e += bps * kThreads)
        __stcg(bw + e, e < D ? bg[e] : 0.0f);
    }
    grid.sync();
    stamp(0);

    // ---- factor: phase k applies panel k to the trailing tiles and solves
    // column k + 1, one grid barrier per phase (phase -1 solves column 0)
    for (int k = -1; k < T; ++k) {
      const int k1 = k + 1;
      float* DBn = DB + (k1 & 1) * kTile;
      const float* DBk = DB + (k & 1) * kTile;
      if (active && warp == 0) {
        // every block factors diagonal tile k + 1 itself (so every block
        // holds the same flag): look-ahead, the tile plus panel k's update
        if (k1 < T) {
          float a[8];
          load_entries(tiles + tile_off(k1, k1), a);
          if (k >= 0) rank_update(tiles + tile_off(k1, k), tiles + tile_off(k1, k), sc, a);
          __syncwarp();
          store_entries(sc, a, false);
          __syncwarp();
          const bool ok = factor_diag(sc, DBn);
          if (!ok && lane == 0) *bad = 1;
          __syncwarp();
          if (lb == 0) {  // the leader keeps Li^T for the solves
            st4(dinv + static_cast<long long>(k1) * kTile + 8 * lane,
                *reinterpret_cast<const float4*>(DBn + 8 * lane));
            st4(dinv + static_cast<long long>(k1) * kTile + 8 * lane + 4,
                *reinterpret_cast<const float4*>(DBn + 8 * lane + 4));
          }
        }
      } else if (active && k >= 0) {
        // trailing tiles (i, j), k + 2 <= j <= i, then the right-hand side
        // blocks k (y_k written) .. T - 1 (panel k taken out)
        const int n = T - k - 2;
        const int nA = n > 0 ? n * (n + 1) / 2 : 0;
        const int nV = T - k;
        for (int t = gw; t < nA + nV; t += nw) {
          if (t < nA) {
            int ii, jj;
            tri_index(t, ii, jj);
            const int i = k + 2 + ii;
            const int j = k + 2 + jj;
            float* A = tiles + tile_off(i, j);
            float a[8];
            load_entries(A, a);
            rank_update(tiles + tile_off(i, k), tiles + tile_off(j, k), sc, a);
            store_entries(A, a, true);
          } else {
            const int i = k + (t - nA);
            const int r = lane & 15;
            // y_k = Li_kk b_k (b_k has taken out every earlier panel)
            const float bk = __ldcg(bw + k * kNB + r);
            float y = 0.0f;
#pragma unroll
            for (int m = 0; m < kNB; ++m) y = fmaf(DBk[m * kNB + r], __shfl_sync(kFull, bk, m), y);
            if (i == k) {
              if (lane < kNB) __stcg(yv + k * kNB + r, y);
            } else {
              const float* LT = tiles + tile_off(i, k);
              float l[kNB];
#pragma unroll
              for (int m = 0; m < kNB; ++m) l[m] = __ldcg(LT + m * kNB + r);
              float s = 0.0f;
#pragma unroll
              for (int m = 0; m < kNB; ++m) s = fmaf(l[m], __shfl_sync(kFull, y, m), s);
              if (lane < kNB) __stcg(bw + i * kNB + r, __ldcg(bw + i * kNB + r) - s);
            }
          }
        }
      }
      __syncthreads();  // Li^T of diagonal tile k + 1 is in DBn
      if (active && warp > 0 && k1 < T) {
        // column k + 1: L_i = (A_i - L_ik L_k1k^T) Li^T, stored transposed
        const int r = lane >> 1;
        const int c0 = (lane & 1) * 8;
        for (int c = gw; c < T - k - 2; c += nw) {
          const int i = k + 2 + c;
          float* A = tiles + tile_off(i, k1);
          float a[8];
          load_entries(A, a);
          if (k >= 0) rank_update(tiles + tile_off(i, k), tiles + tile_off(k1, k), sc, a);
          __syncwarp();
          store_entries(sc, a, false);
          __syncwarp();
          float row[kNB];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 u = *reinterpret_cast<const float4*>(sc + r * kNB + 4 * q);
            row[4 * q] = u.x; row[4 * q + 1] = u.y; row[4 * q + 2] = u.z; row[4 * q + 3] = u.w;
          }
          float o[8] = {};
#pragma unroll
          for (int m = 0; m < kNB; ++m) {
#pragma unroll
            for (int q = 0; q < 8; ++q) o[q] = fmaf(row[m], DBn[m * kNB + c0 + q], o[q]);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) sc[kTile + (c0 + q) * kNB + r] = o[q];
          __syncwarp();
          st4(A + 8 * lane, *reinterpret_cast<const float4*>(sc + kTile + 8 * lane));
          st4(A + 8 * lane + 4, *reinterpret_cast<const float4*>(sc + kTile + 8 * lane + 4));
          __syncwarp();
        }
      }
      grid.sync();
    }
    stamp(1);

    // ---- solve, then one refinement step with an f64 residual ------------
    if (active && lb == 0) {
      for (int e = tid; e < Dp; e += kThreads) v[e] = __ldcg(yv + e);
      __syncthreads();
      grid_tri_solve(tiles, dinv, v, red, T, false);
      for (int e = tid; e < Dp; e += kThreads) __stcg(xg + e, v[e]);
    }
    grid.sync();
    stamp(2);
    if (active) {
      for (int e = tid; e < Dp; e += kThreads) rv[e] = __ldcg(xg + e);
      __syncthreads();
      for (int row = warp * bps + lb; row < D; row += bps * kWarps) {
        const float* Srow = Sg + static_cast<long long>(row) * D;
        double s = 0.0;
        for (int j = lane; j < D; j += 32) s += static_cast<double>(Srow[j]) * rv[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
        if (lane == 0) __stcg(rg + row, static_cast<float>(static_cast<double>(bg[row]) - s));
      }
    }
    grid.sync();
    stamp(3);
    if (active && lb == 0) {
      for (int e = tid; e < Dp; e += kThreads) rv[e] = e < D ? __ldcg(rg + e) : 0.0f;
      __syncthreads();
      grid_tri_solve(tiles, dinv, rv, red, T, true);
      const bool nan = *bad != 0;
      for (int i = tid; i < D; i += kThreads)
        x[static_cast<long long>(sys) * D + i] = nan ? __int_as_float(0x7fffffff) : v[i] + rv[i];
    }
    __syncthreads();  // the next batch reuses the shared vectors and the flag
    stamp(4);
  }
}

// `n` grid barriers and nothing else: what one barrier of the grid route costs.
__global__ void __launch_bounds__(kThreads, 1) grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// Blocks of a cooperative launch of `kernel`: one per SM, or 0 when the
// device cannot hold them all at once (or has no cooperative launch).
template <typename K>
int resident_grid(K kernel, size_t smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm >= 1 ? sms : 0;
}

int launch_grid(const float* S, const float* b, int g, int d, float* work, float* x,
                long long* clocks, cudaStream_t stream) {
  int T = (d + kNB - 1) / kNB;
  const size_t smem = grid_smem_bytes(T);
  if (smem > static_cast<size_t>(max_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
  // residency, checked once per shared-memory size: a grid barrier on
  // blocks that are not all resident would hang the card
  static size_t checked_smem = 0;
  static int blocks = 0;
  if (checked_smem != smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = resident_grid(chol_grid_kernel, smem);
    checked_smem = smem;
  }
  if (blocks < kGridSys) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&S, &b, &g, &d, &T, &work, &x, &clocks};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chol_grid_kernel), dim3(blocks),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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

// Floats of the work buffer the large-D route needs for g systems of size d
// (-1 when that exceeds an int).
extern "C" int chol_grid_work_floats(int g, int d) {
  const long long n = static_cast<long long>(g) * grid_work_floats((d + kNB - 1) / kNB);
  return n <= 0x7fffffffLL ? static_cast<int>(n) : -1;
}

// Blocks of the large-D route's cooperative grid for systems of size d on
// the current device: one per SM, 0 when they cannot all be resident.
extern "C" int chol_grid_blocks(int d) {
  const size_t smem = grid_smem_bytes((d + kNB - 1) / kNB);
  if (smem > static_cast<size_t>(max_smem_optin())) return 0;
  if (cudaFuncSetAttribute(chol_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  return resident_grid(chol_grid_kernel, smem);
}

// Large-D route: one cooperative launch, the blocks split between up to
// kGridSys systems at a time, over `work` (chol_grid_work_floats floats,
// any content). Returns a cudaError_t; cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be resident at once.
extern "C" int chol_solve_grid_f32(const float* S, const float* b, int g, int d, float* work,
                                   float* x, void* stream) {
  return launch_grid(S, b, g, d, work, x, nullptr, static_cast<cudaStream_t>(stream));
}

// The same launch with block 0's clock64 spans added into `clocks` (5
// int64 on the device: load, factor, back pass, residual, refinement
// passes), for the phase split in the header.
extern "C" int chol_solve_grid_clocks_f32(const float* S, const float* b, int g, int d,
                                          float* work, float* x, long long* clocks,
                                          void* stream) {
  return launch_grid(S, b, g, d, work, x, clocks, static_cast<cudaStream_t>(stream));
}

// An empty cooperative kernel of n grid barriers on the large-D route's
// grid: what a barrier costs.
extern "C" int chol_grid_sync_probe(int n, void* stream) {
  const int blocks = resident_grid(grid_sync_probe_kernel, 0);
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&n};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(reinterpret_cast<void*>(grid_sync_probe_kernel), dim3(blocks),
                                  dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
