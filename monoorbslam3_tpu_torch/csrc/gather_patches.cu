// K1: dynamic 48x48 patch gather from the packed pyramid atlas.
//
// Replaces the TPU kernel `_gather_kernel` of
// monoorbslam3_tpu/ops/pallas_kernels.py (reached through
// `_gather_patches_pallas` <- `gather_patches_dyn` <- OrbExtractor._extract).
// On the TPU it DMAs [56, 256] tile-aligned superblocks into VMEM and rolls
// the residual offset out, because Mosaic needs sublane starts %8 and lane
// slices %128. None of that alignment exists here: a thread reads any
// float.
//
// What bounds it on the H100: memory. It does no arithmetic; at K = 1024
// it writes 1024 * 48 * 48 * 4 B = 9.4 MB and reads about as much (the
// windows of neighbouring keypoints overlap, and the 9.3 MB atlas sits in
// the 50 MB L2). A thread-per-float copy (the first version of this
// kernel: nine rounds of an address division, a 4-byte load and a 4-byte
// store per thread) is held back by its own address arithmetic and small
// accesses, not by the bytes. This version cuts them: one block of 192
// threads per window, thread (r, g) owns the 16 output bytes of group g
// (of 12) in rows r, r + 16 and r + 32. Per row it makes four scalar loads
// (a window's corner is any float, so its rows are not 16-byte aligned in
// the atlas) and one 16-byte store (an output window is 9,216 bytes, so
// its rows are); the one division by 12 happens before the loop. On an
// H100 it moves its bytes in 2.7 us on top of the 2.4 us an empty kernel
// on the same 1024-block grid takes (experiments/port_gather_ablate.py).
//
// A TMA tensor map over the atlas (one `cp.async.bulk.tensor.2d` per
// window into shared memory, one bulk store out) would leave the threads
// almost nothing to do, but `experiments/port_tma_probe.cu` shows the
// tensor load raising an illegal-instruction error on the machine this
// port is measured on, in NVIDIA's own sample too, so that design is not
// built.
//
// Later work: fuse the gather with the IC angle, the blur and the BRIEF
// sampler so that the [K, 48, 48] stack never reaches HBM.
//
// Corners are treated as `lax.dynamic_slice` treats its start indices (a
// negative one counts from the far border, then all are clamped into the
// atlas); the copy is bit-exact.

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 48;
constexpr int kGroups = kPatch / 4;        // 16-byte groups in a window's row
constexpr int kRows = 16;                  // rows a block copies at a time
constexpr int kThreads = kRows * kGroups;  // 192

__global__ void __launch_bounds__(kThreads)
gather_patches_kernel(const float* __restrict__ atlas, int ha, int wa,
                      const int* __restrict__ ys, const int* __restrict__ xs,
                      float* __restrict__ out) {
  const int k = blockIdx.x;
  const int y = ys[k];
  const int x = xs[k];
  const int y0 = min(max(y < 0 ? y + ha : y, 0), ha - kPatch);
  const int x0 = min(max(x < 0 ? x + wa : x, 0), wa - kPatch);
  const int r = threadIdx.x / kGroups;
  const int g = threadIdx.x - r * kGroups;
  const float* src = atlas + static_cast<long long>(y0 + r) * wa + x0 + 4 * g;
  float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(k) * kPatch * kPatch +
                                          r * kPatch + 4 * g);
  const long long step = static_cast<long long>(kRows) * wa;
#pragma unroll
  for (int it = 0; it < kPatch / kRows; ++it) {
    const float* p = src + it * step;
    dst[it * kRows * kGroups] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
}

}  // namespace

extern "C" int gather_patches_f32(const float* atlas, int ha, int wa,
                                  const int* ys, const int* xs, int k,
                                  float* out, void* stream) {
  gather_patches_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas, ha, wa, ys, xs, out);
  return static_cast<int>(cudaGetLastError());
}
