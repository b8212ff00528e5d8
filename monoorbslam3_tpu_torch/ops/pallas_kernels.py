"""K3, the dense Hamming block, and K1, the dynamic patch gather that feeds
the ORB descriptor sampler (counterparts of `hamming_matrix_pallas` and
`gather_patches_dyn` in `monoorbslam3_tpu/ops/pallas_kernels.py`).

K3: [N, 8] x [M, 8] descriptor words -> [N, M] int32 Hamming distances.
Descriptors are the int32 view of the uint32 words. A CUDA tensor launches
the hand kernel (`csrc/hamming.cu`); a CPU tensor takes the plain version,
the +-1 product of the JAX package's XLA path. Both are exact.

K1: K windows of 48x48 are copied out of the packed pyramid atlas at
dynamic top-left corners. A CUDA tensor launches the hand kernel
(`csrc/gather_patches.cu`); a CPU tensor takes the plain index gather,
which equals the JAX CPU path (`vmap(dynamic_slice)`) bit for bit. The
kernel is a pure copy, so both are exact.
"""

from __future__ import annotations

import torch

from . import cuda_lib

PATCH = 48


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (SWAR). `>>` is arithmetic on int32; each
    mask clears the sign bits it drags in, so bit 31 counts once."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def pm1_planes(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[n, 8] int32 words -> [n, 256] bit planes of `dtype`, +1 for a 0 bit
    and -1 for a 1 bit, as the JAX package unpacks them for its +-1 product
    (`monoorbslam3_tpu/ops/matching.py:hamming_matrix`): 256 - 2 x the
    distance is their product."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[:, :, None] >> shifts) & 1
    return (1 - 2 * bits).reshape(desc.shape[0], 256).to(dtype)


def hamming_matrix_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA formulation (`ops/matching.py:hamming_matrix`):
    for +-1 bit planes A, B the distance is (256 - A.B) / 2. The products
    are +-1 and every partial sum an integer of at most 256, so the float32
    product is exact in any summation order; one [N, 256] x [256, M] product
    instead of an [N, M, 8] broadcast of popcounts."""
    dot = pm1_planes(desc_a) @ pm1_planes(desc_b).T
    return ((256.0 - dot) * 0.5).to(torch.int32)


def hamming_matrix_cuda(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Launch the hand kernel on the current stream."""
    N, M = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty((N, M), dtype=torch.int32, device=desc_a.device)
    if N == 0 or M == 0:
        return out
    a = desc_a.contiguous()
    b = desc_b.contiguous()
    err = cuda_lib.lib().hamming_i32(
        a.data_ptr(), N, b.data_ptr(), M, out.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(err, "hamming_i32")
    cuda_lib.launches["hamming"] += 1
    return out


def hamming_matrix_pallas(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N, 8] i32 x [M, 8] i32 -> [N, M] int32 Hamming distances.

    Dispatches on the device: CUDA launches the kernel, CPU takes the
    plain version."""
    for name, d in (("desc_a", desc_a), ("desc_b", desc_b)):
        if d.dtype != torch.int32 or d.dim() != 2 or d.shape[1] != 8:
            raise ValueError(f"{name} must be [n, 8] int32, got {d.dtype} {tuple(d.shape)}")
    if desc_a.device != desc_b.device:
        raise ValueError("hamming_matrix: descriptors lie on different devices")
    if desc_a.is_cuda:
        return hamming_matrix_cuda(desc_a, desc_b)
    if desc_a.device.type != "cpu":
        raise ValueError(f"hamming_matrix: unsupported device {desc_a.device}")
    return hamming_matrix_plain(desc_a, desc_b)


def hamming_matrix_best(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """The Hamming matrix by the best route of the device, as the JAX
    package's dispatch between its kernel and its XLA product: K3 on a
    CUDA tensor, the plain version on the CPU (both exact)."""
    return hamming_matrix_pallas(desc_a, desc_b)


def _check_inputs(img, ys, xs):
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"atlas must be a contiguous 2-D float32 tensor, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if img.shape[0] < PATCH or img.shape[1] < PATCH:
        raise ValueError(f"atlas {tuple(img.shape)} smaller than one patch")
    for name, v in (("ys", ys), ("xs", xs)):
        if v.dtype != torch.int32 or v.dim() != 1 or v.device != img.device:
            raise ValueError(f"{name} must be a 1-D int32 tensor on {img.device}")
    if ys.shape != xs.shape:
        raise ValueError("ys and xs differ in length")


def gather_patches_plain(img: torch.Tensor, ys: torch.Tensor,
                         xs: torch.Tensor) -> torch.Tensor:
    """Index-gather version. Corners are treated as `lax.dynamic_slice`
    treats its start indices: a negative one counts from the far border
    (c + size), then all are clamped into the atlas."""
    ha, wa = img.shape
    y0 = torch.where(ys < 0, ys + ha, ys).long().clamp(0, ha - PATCH)
    x0 = torch.where(xs < 0, xs + wa, xs).long().clamp(0, wa - PATCH)
    r = torch.arange(PATCH, device=img.device)
    return img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def gather_patches_cuda(img: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor) -> torch.Tensor:
    """Launch the hand kernel on the current stream."""
    K = ys.shape[0]
    out = torch.empty((K, PATCH, PATCH), dtype=torch.float32, device=img.device)
    if K == 0:
        return out
    ys = ys.contiguous()
    xs = xs.contiguous()
    err = cuda_lib.lib().gather_patches_f32(
        img.data_ptr(), img.shape[0], img.shape[1], ys.data_ptr(),
        xs.data_ptr(), K, out.data_ptr(),
        torch.cuda.current_stream(img.device).cuda_stream)
    cuda_lib.check(err, "gather_patches_f32")
    cuda_lib.launches["gather_patches"] += 1
    return out


def gather_patches_dyn(img: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """[Ha, Wa] f32, top-left corners (ys, xs) int32 -> [K, 48, 48] patches.

    Dispatches on the atlas's device: CUDA launches the kernel, CPU takes
    the plain gather."""
    _check_inputs(img, ys, xs)
    if img.is_cuda:
        return gather_patches_cuda(img, ys, xs)
    if img.device.type != "cpu":
        raise ValueError(f"gather_patches_dyn: unsupported device {img.device}")
    return gather_patches_plain(img, ys, xs)
