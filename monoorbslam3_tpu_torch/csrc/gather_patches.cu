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
// the 50 MB L2). The design is therefore a plain coalesced copy: one block
// per window, 256 threads stride over its 2304 floats in row-major order,
// so consecutive threads read consecutive atlas addresses within each
// 48-float row and write one contiguous 9 KB output window.
//
// Later work: fuse the gather with the IC angle, the blur and the BRIEF
// sampler so that the [K, 48, 48] stack never reaches HBM.
//
// Corners are clamped into the atlas as `lax.dynamic_slice` clamps its
// start indices; the copy is bit-exact.

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 48;
constexpr int kThreads = 256;

__global__ void gather_patches_kernel(const float* __restrict__ atlas, int ha,
                                      int wa, const int* __restrict__ ys,
                                      const int* __restrict__ xs,
                                      float* __restrict__ out) {
  const int k = blockIdx.x;
  const int y0 = min(max(ys[k], 0), ha - kPatch);
  const int x0 = min(max(xs[k], 0), wa - kPatch);
  const float* src = atlas + static_cast<long long>(y0) * wa + x0;
  float* dst = out + static_cast<long long>(k) * kPatch * kPatch;
  for (int i = threadIdx.x; i < kPatch * kPatch; i += kThreads) {
    const int r = i / kPatch;
    const int c = i - r * kPatch;
    dst[i] = __ldg(src + static_cast<long long>(r) * wa + c);
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
