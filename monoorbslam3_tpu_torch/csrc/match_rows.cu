// K2: gated Hamming top-2 match, one output row per descriptor of side A.
//
// Replaces the TPU kernel `_match_kernel` of
// monoorbslam3_tpu/ops/match_pallas.py (reached through
// `_match_rows_pallas` <- `_projected_match_impl` <- `projected_match`).
// For each row a it computes, over every column b: the Hamming distance,
// the pairwise gate (both sides valid, squared pixel distance below each
// side's r^2, vocab node equal or -1), and the best, second best and
// first-occurrence argmin of the gated distances.
//
// What bounds it on the H100: operations. A 4096 x 1024 call reads 0.27 MB
// but evaluates 4.2 M pairs. As a depth-256 binary product the distances
// are 2.1 G operations, 1.1 us at the int8 tensor peak; the gate and the
// running top-2 are ~11 float operations a pair, 0.7 us at the float32
// peak. The tracking step makes eight calls a frame (1024 x 1024 and
// 4096 x 1024, rows and transposed, at two radii), each too small to fill
// the card if one block owned whole rows. What holds this kernel above its
// bound is the column sweep's issue rate (~22 instructions a pair, about
// half of them the gate) and a fixed cost per launch and per block;
// `experiments/port_match_ablate.py` times the parts.
//
// The design:
//  * The card is filled whatever N is: a block owns 32 rows and one of 8
//    column chunks, and the 8 blocks of a row tile form a thread-block
//    cluster (grid 8 x ceil(N / 32): 256 blocks at N = 1024, 1024 at
//    N = 4096). Each block writes its partial (best, second, idx) per row
//    into rank 0's shared memory over DSMEM; one cluster barrier; rank 0
//    merges the 16 partials of a row. No second launch, no global scratch,
//    no atomics.
//  * The distances run on the tensor cores, exactly: a descriptor is one
//    256-bit k-vector of `mma.sync.m16n8k256.b1` with `.and.popc`, which
//    gives popc(a & b) for 16 rows x 8 columns in one instruction, and
//    popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b), each side's popcount
//    computed once. (The TPU kernel put the same product on its matrix
//    unit as (256 - A.B^T) / 2 on +-1 bf16 planes.) Fragments: lane (g, t)
//    of a warp (g = lane / 4, t = lane % 4) holds words t and t + 4 of
//    rows g and g + 8 (A) and of column g of the n-tile (B), and receives
//    the sums of rows g, g + 8 at columns 2t, 2t + 1. The staged column
//    words are stored in the order 0 4 1 5 2 6 3 7, so B is one 8-byte
//    shared load per lane.
//  * The gate and a running top-2 per fragment entry stay in registers.
//    A warp walks its n-tiles in increasing column order and a lane its two
//    columns in order, updating on strict `<`, so each lane keeps its
//    first occurrence.
//
// Exactness (the plain version is `_match_rows_plain`):
//  * merging partials of disjoint column sets: the winner is the smallest
//    value, and among equal values the lowest column; second is the min of
//    the winner's second and every other partial's best. A duplicate of the
//    best at another column therefore gives second == best, as in the
//    plain version, whichever chunk, warp or lane saw it.
//  * the gate's q = dx*dx + dy*dy uses __fmul_rn/__fadd_rn: nvcc would
//    otherwise contract it into an FMA and round once where the plain
//    version rounds twice, and `q < r2` could decide differently.
//  * validity and NaN are folded into each side's r^2 once (an invalid
//    side, or an r^2 that is NaN, becomes -inf), so `q < min(r2a, r2b)`
//    decides as `(q < r2a) & (q < r2b)` with both sides' validity.
//  * distances are integers 0..256 and the gated sentinel INF = 1e9, all
//    exact in float32; idx = -1 when best >= INF.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kWords = 8;
constexpr int kCluster = 8;     // column chunks of a row tile: blocks per cluster
constexpr int kRows = 32;       // rows per block: two m-tiles of 16
constexpr int kWarps = 4;       // warp w: m-tile w % 2, every other n-tile from w / 2
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 256;      // columns staged in shared memory at a time
constexpr int kParts = kCluster * 2;  // partials of a row: chunks x n-tile parities
constexpr int kInf = 1000000000;
constexpr int kNoCol = 0x7fffffff;

struct Top2 {
  int best, second, idx;
};

__device__ __forceinline__ void push(Top2& p, int d, int col) {
  if (d < p.best) {
    p.second = p.best;
    p.best = d;
    p.idx = col;
  } else if (d < p.second) {
    p.second = d;
  }
}

// p <- the merge of the partials p and o of two disjoint column sets
__device__ __forceinline__ void merge(Top2& p, int ob, int os, int oi) {
  if (ob < p.best || (ob == p.best && oi < p.idx)) {
    p.second = min(os, p.best);
    p.best = ob;
    p.idx = oi;
  } else {
    p.second = min(p.second, ob);
  }
}

__device__ __forceinline__ void merge_xor(Top2& p, int lane_mask) {
  const int ob = __shfl_xor_sync(0xffffffffu, p.best, lane_mask);
  const int os = __shfl_xor_sync(0xffffffffu, p.second, lane_mask);
  const int oi = __shfl_xor_sync(0xffffffffu, p.idx, lane_mask);
  merge(p, ob, os, oi);
}

// r^2 with the side's validity and NaN folded in: -inf gates every pair
__device__ __forceinline__ float gate_r2(float r2, float valid) {
  return (valid > 0.f && !isnan(r2)) ? r2 : -INFINITY;
}

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
match_rows_kernel(const int* __restrict__ desc_a, const float* __restrict__ ax,
                  const float* __restrict__ ay, const float* __restrict__ r2a,
                  const float* __restrict__ ga, const float* __restrict__ va,
                  int n, const int* __restrict__ desc_b,
                  const float* __restrict__ bx, const float* __restrict__ by,
                  const float* __restrict__ r2b, const float* __restrict__ gb,
                  const float* __restrict__ vb, int m, int chunk,
                  float* __restrict__ best_out, float* __restrict__ second_out,
                  int* __restrict__ idx_out) {
  __shared__ __align__(16) unsigned s_desc[kTile * kWords];  // words 0 4 1 5 2 6 3 7
  __shared__ __align__(8) float s_x[kTile], s_y[kTile], s_r2[kTile], s_g[kTile];
  __shared__ __align__(8) int s_pop[kTile];
  // rank 0's copy receives every block's partials: [chunk][parity][row]
  __shared__ int p_best[kParts][kRows], p_second[kParts][kRows], p_idx[kParts][kRows];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // every block of the cluster has started before any DSMEM write (split
  // barrier: the wait comes after the column sweep)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 1, parity = warp >> 1;
  const int row0 = blockIdx.y * kRows + mt * 16;

  // this lane's rows g and g + 8 of its m-tile: A fragment, popcount,
  // position, folded r^2, group
  unsigned af[4];
  int pa[2];
  float rx[2], ry[2], rr2[2], rg[2];
  bool rany[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    const bool live = row < n;
    const int* d = desc_a + static_cast<long long>(live ? row : 0) * kWords;
    const unsigned lo = live ? static_cast<unsigned>(__ldg(d + t)) : 0u;
    const unsigned hi = live ? static_cast<unsigned>(__ldg(d + t + 4)) : 0u;
    af[h] = lo;       // a0 (row g), a1 (row g + 8): word t
    af[2 + h] = hi;   // a2, a3: word t + 4
    int pop = __popc(lo) + __popc(hi);
    pop += __shfl_xor_sync(0xffffffffu, pop, 1);
    pop += __shfl_xor_sync(0xffffffffu, pop, 2);
    pa[h] = pop;
    rx[h] = live ? ax[row] : 0.f;
    ry[h] = live ? ay[row] : 0.f;
    rr2[h] = live ? gate_r2(r2a[row], va[row]) : -INFINITY;
    rg[h] = live ? ga[row] : 0.f;
    rany[h] = rg[h] < 0.f;
  }

  Top2 top[2] = {{kInf, kInf, kNoCol}, {kInf, kInf, kNoCol}};
  const int c0 = rank * chunk;
  const int c1 = min(m, c0 + chunk);
  for (int base = c0; base < c1; base += kTile) {
    const int cols = min(kTile, c1 - base);
    const int cols8 = (cols + 7) & ~7;
    __syncthreads();  // the previous tile has been consumed
    for (int c = tid; c < cols8; c += kThreads) {
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      float x = 0.f, y = 0.f, r2 = -INFINITY, gr = 0.f;
      if (c < cols) {  // columns past the chunk (an n-tile's padding) stay gated
        const long long col = base + c;
        const uint4* d = reinterpret_cast<const uint4*>(desc_b + col * kWords);
        lo = __ldg(d);
        hi = __ldg(d + 1);
        x = bx[col];
        y = by[col];
        r2 = gate_r2(r2b[col], vb[col]);
        gr = gb[col];
      }
      uint4* s = reinterpret_cast<uint4*>(s_desc + c * kWords);
      s[0] = make_uint4(lo.x, hi.x, lo.y, hi.y);
      s[1] = make_uint4(lo.z, hi.z, lo.w, hi.w);
      s_pop[c] = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) + __popc(hi.x) +
                 __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
      s_x[c] = x;
      s_y[c] = y;
      s_r2[c] = r2;
      s_g[c] = gr;
    }
    __syncthreads();
    for (int nt = parity; nt < cols8 / 8; nt += 2) {
      const int nb = nt * 8;
      const uint2 bf = *reinterpret_cast<const uint2*>(s_desc + (nb + g) * kWords + 2 * t);
      int acc[4];
      mma_and_popc(af[0], af[1], af[2], af[3], bf, acc);
      const int j0 = nb + 2 * t;
      const int2 pb = *reinterpret_cast<const int2*>(s_pop + j0);
      const float2 cx = *reinterpret_cast<const float2*>(s_x + j0);
      const float2 cy = *reinterpret_cast<const float2*>(s_y + j0);
      const float2 cr2 = *reinterpret_cast<const float2*>(s_r2 + j0);
      const float2 cg2 = *reinterpret_cast<const float2*>(s_g + j0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = j ? cx.y : cx.x, y = j ? cy.y : cy.x;
          const float r2 = j ? cr2.y : cr2.x, gc = j ? cg2.y : cg2.x;
          const int ham = pa[h] + (j ? pb.y : pb.x) - 2 * acc[2 * h + j];
          const float dx = __fsub_rn(rx[h], x);
          const float dy = __fsub_rn(ry[h], y);
          const float q = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const bool gate = (q < fminf(rr2[h], r2)) && (rany[h] || gc < 0.f || rg[h] == gc);
          push(top[h], gate ? ham : kInf, base + j0 + j);
        }
      }
    }
  }

  // the quad's four lanes hold the same rows over different columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    merge_xor(top[h], 1);
    merge_xor(top[h], 2);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t == 0) {
    int* pb = cluster.map_shared_rank(&p_best[0][0], 0);
    int* ps = cluster.map_shared_rank(&p_second[0][0], 0);
    int* pi = cluster.map_shared_rank(&p_idx[0][0], 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (rank * 2 + parity) * kRows + mt * 16 + g + 8 * h;
      pb[at] = top[h].best;
      ps[at] = top[h].second;
      pi[at] = top[h].idx;
    }
  }
  cluster.sync();  // every partial has landed in rank 0's shared memory
  if (rank != 0 || tid >= kRows) return;
  const int row = blockIdx.y * kRows + tid;
  if (row >= n) return;
  Top2 p = {p_best[0][tid], p_second[0][tid], p_idx[0][tid]};
#pragma unroll
  for (int k = 1; k < kParts; ++k) merge(p, p_best[k][tid], p_second[k][tid], p_idx[k][tid]);
  // an all-gated row keeps best = second = INF and reports idx = -1, as
  // the plain version does
  best_out[row] = static_cast<float>(p.best);
  second_out[row] = static_cast<float>(p.second);
  idx_out[row] = p.best < kInf ? p.idx : -1;
}

// The grid of a launch for n rows (any m): column chunks x row tiles.
dim3 grid_of(int n) { return dim3(kCluster, static_cast<unsigned>((n + kRows - 1) / kRows), 1); }

}  // namespace

// Blocks a launch for n rows puts in flight: the grid `match_rows_f32` launches.
extern "C" int match_rows_blocks(int n) {
  const dim3 g = grid_of(n);
  return static_cast<int>(g.x * g.y * g.z);
}

extern "C" int match_rows_f32(const int* desc_a, const float* ax,
                              const float* ay, const float* r2a,
                              const float* ga, const float* va, int n,
                              const int* desc_b, const float* bx,
                              const float* by, const float* r2b,
                              const float* gb, const float* vb, int m,
                              float* best, float* second, int* idx,
                              void* stream) {
  // columns per chunk: a multiple of the 8-column n-tile
  const int chunk = ((m + 8 * kCluster - 1) / (8 * kCluster)) * 8;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid_of(n);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, match_rows_kernel, desc_a, ax, ay, r2a, ga, va,
                                           n, desc_b, bx, by, r2b, gb, vb, m, chunk, best,
                                           second, idx);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
