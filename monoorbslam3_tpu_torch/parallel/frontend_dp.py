"""Data-parallel bulk extraction over a device mesh (counterpart of
`monoorbslam3_tpu/parallel/frontend_dp.py`).

The reference extracts one frame at a time on the tracking thread
(Tracking.cpp:93). Bulk extraction (mapping sessions, multi-sequence
preprocessing) scales across devices by plain data parallelism: the batch
is split over the mesh's "dp" axis, each rank runs the single-frame
extractor on its slice, one frame after the other, and the features are
gathered back so that every rank holds the whole batch. Extraction needs
no other collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .multihost import mesh_axis


def make_batch_extractor(ext, mesh, axis: str = "dp"):
    """Returns `fn(images [B, H, W]) -> features`, each output [B, ...] on
    every rank of `mesh` (which must be of the extractor's device type).
    Every rank passes the same batch; B must be a multiple of the axis
    size (ValueError otherwise). Rank r extracts frames r*B/n .. (r+1)*B/n
    - 1 with `ext` and the results are all-gathered over the axis."""
    if mesh.device_type != ext.device.type:
        raise ValueError(f"make_batch_extractor: a {mesh.device_type} mesh for an extractor on "
                         f"{ext.device}")
    group, rank, n = mesh_axis(mesh, axis)

    def run(images):
        B = images.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by mesh axis {n}")
        mine = shard_images(images, mesh, axis, device=ext.device)
        local = [ext(img) for img in mine]
        out = {}
        for key in local[0]:
            part = torch.stack([o[key] for o in local])
            if n > 1:
                wire = part.to(torch.uint8) if part.dtype == torch.bool else part
                parts = [torch.empty_like(wire) for _ in range(n)]
                dist.all_gather(parts, wire, group=group)
                part = torch.cat(parts).to(part.dtype)
            out[key] = part
        return out

    return run


def shard_images(images, mesh, axis: str = "dp", device=None):
    """This rank's slice [B/n, H, W] of a [B, H, W] batch, as float32 on
    `device` (by default the mesh's device type)."""
    _, rank, n = mesh_axis(mesh, axis)
    b = images.shape[0] // n
    dev = device if device is not None else torch.device(mesh.device_type)
    return torch.as_tensor(images[rank * b:(rank + 1) * b], dtype=torch.float32, device=dev)
