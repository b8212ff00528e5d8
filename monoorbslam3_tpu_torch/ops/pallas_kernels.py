"""K1: the dynamic patch gather that feeds the ORB descriptor sampler
(counterpart of `gather_patches_dyn` in `monoorbslam3_tpu/ops/pallas_kernels.py`).

K windows of 48x48 are copied out of the packed pyramid atlas at dynamic
top-left corners. A CUDA tensor launches the hand kernel
(`csrc/gather_patches.cu`); a CPU tensor takes the plain index gather,
which equals the JAX CPU path (`vmap(dynamic_slice)`) bit for bit. The
kernel is a pure copy, so both are exact.
"""

from __future__ import annotations

import torch

from . import cuda_lib

PATCH = 48


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
    """Index-gather version. Corners are clamped into the atlas like
    `lax.dynamic_slice` clamps its start indices."""
    ha, wa = img.shape
    y0 = ys.long().clamp(0, ha - PATCH)
    x0 = xs.long().clamp(0, wa - PATCH)
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
