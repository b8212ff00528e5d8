"""SE(3) pose utilities over (R [..., 3, 3], t [..., 3]) tensor pairs
(counterpart of `monoorbslam3_tpu/utils/se3.py`): composition, inversion,
point mapping and quaternion I/O, batched over leading axes."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie


class Pose(NamedTuple):
    """Rigid transform y = R x + t. Batched over leading axes."""

    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, *, device) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return Pose(R, t)

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """Map points [..., 3]."""
        return torch.einsum("...ij,...j->...i", self.R, p) + self.t

    def compose(self, other: "Pose") -> "Pose":
        """self o other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, self.apply(other.t))

    def inverse(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))

    def normalized(self) -> "Pose":
        return Pose(lie.normalize_rotation(self.R), self.t)

    def to_quat_t(self):
        """(q [..., 4] (w, x, y, z), t [..., 3]) for trajectory export."""
        return lie.rot_to_quat(self.R), self.t


def from_quat_t(q: torch.Tensor, t: torch.Tensor) -> Pose:
    return Pose(lie.quat_to_rot(q), t)
