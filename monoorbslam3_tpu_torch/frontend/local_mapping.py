"""The mapper's two device searches for a new keyframe (counterparts of
`_triangulate_pair_kernel` and `_fuse_project_kernel` in
`monoorbslam3_tpu/frontend/local_mapping.py`).

`create_new_map_points` runs `_triangulate_pair_kernel` for the new
keyframe against each covisible neighbour, and `_dispatch_fuse` runs
`_fuse_project_kernel` to fuse the new keyframe's points into each
neighbour. Both rest on the dense Hamming block (`matching.hamming_matrix`,
the hand kernel K3 on a CUDA tensor) under `masked_nn_match`. The
`LocalMapping` class, the map store and the IMU init come with a later
slice.
"""

from __future__ import annotations

import torch

from ..ops import matching
from ..ops.twoview import triangulate_dlt
from ..utils import lie


def _triangulate_pair_kernel(
    xy1, desc1, valid1, sigma2_1,
    xy2, desc2, valid2, sigma2_2,
    camera, R_cw1, t_cw1, R_cw2, t_cw2,
    group1=None, group2=None,
):
    """Match unmatched features of two KFs under an epipolar gate (and the
    shared-vocabulary-node gate when groups are given), triangulate, and
    apply the acceptance gates (LocalMapping.cpp:146-259): positive depth
    in both views, parallax cos < 0.9998, reprojection chi2 < 5.991 in
    both views, scale consistency and a finite point.

    Returns (match_idx [N1] int32 into KF2 (-1 = none), points [N1, 3]
    world, accept [N1] bool)."""
    R21 = R_cw2 @ R_cw1.T
    t21 = t_cw2 - R21 @ t_cw1
    E = lie.hat(t21) @ R21

    m1 = camera.back_project(xy1)  # [N1, 3] normalized (x/z, y/z, 1)
    m2 = camera.back_project(xy2)
    l2 = m1 @ E.T  # epipolar lines of KF1 rays in cam-2 normalized coords
    num = m2 @ E @ m1.T  # [N2, N1]
    # normalized-coord line distance scaled by the focal length ~= pixels
    f2 = 0.25 * (camera.fx + camera.fy) ** 2
    d2 = f2 * (num.T ** 2) / torch.clamp(l2[:, 0] ** 2 + l2[:, 1] ** 2, min=1e-12)[:, None]
    epi_ok = d2 < 3.84 * sigma2_2[None, :]

    pair_mask = valid1[:, None] & valid2[None, :] & epi_ok
    if group1 is not None and group2 is not None:
        pair_mask &= matching.node_gate(group1, group2)
    idx, _ = matching.masked_nn_match(
        matching.hamming_matrix(desc1, desc2), pair_mask,
        max_dist=matching.TH_LOW, ratio=0.9, mutual=True,
    )
    hit = idx >= 0
    safe_idx = torch.clamp(idx, min=0).long()
    xy2_m = xy2[safe_idx]

    P1 = torch.cat([R_cw1, t_cw1[:, None]], dim=1)  # normalized cameras
    P2 = torch.cat([R_cw2, t_cw2[:, None]], dim=1)
    X = triangulate_dlt(P1, P2, m1[:, :2] / m1[:, 2:],
                        (m2[:, :2] / m2[:, 2:])[safe_idx])  # world frame

    O1 = -R_cw1.T @ t_cw1
    O2 = -R_cw2.T @ t_cw2
    n1 = X - O1
    n2 = X - O2
    cos_par = torch.sum(n1 * n2, -1) / torch.clamp(
        torch.linalg.norm(n1, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    pc1 = X @ R_cw1.T + t_cw1
    pc2 = X @ R_cw2.T + t_cw2
    z_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)

    def reproj(pc, xy, s2):
        uv = camera.project(pc)
        return torch.sum((uv - xy) ** 2, dim=-1) / s2

    e1 = reproj(pc1, xy1, sigma2_1)
    e2 = reproj(pc2, xy2_m, sigma2_2[safe_idx])

    # scale consistency: distance ratio within the octave band (.cpp:236-247)
    d_1 = torch.linalg.norm(n1, dim=-1)
    d_2 = torch.linalg.norm(n2, dim=-1)
    ratio = d_1 / torch.clamp(d_2, min=1e-9)
    s_ratio = torch.sqrt(sigma2_1 / torch.clamp(sigma2_2[safe_idx], min=1e-9))
    scale_ok = (ratio < s_ratio * 2.0) & (ratio * 2.0 > s_ratio / 1.0)

    accept = (hit & z_ok & (cos_par < 0.9998) & (e1 < 5.991) & (e2 < 5.991)
              & scale_ok & torch.all(torch.isfinite(X), dim=-1))
    return idx, X, accept


def _fuse_project_kernel(pt_xyz, pt_desc, pt_valid, xy, desc, valid, sigma2,
                         camera, R_cw, t_cw, radius_scale):
    """Project map points into a KF and find the best feature within
    `radius_scale` pixels (the Fuse projection search, ORBMatcher.cpp:
    524-592). Returns idx [P] int32 into the KF's features (-1 = none)."""
    del sigma2  # part of the JAX signature; the fuse gate does not read it
    pc = pt_xyz @ R_cw.T + t_cw
    z_ok = pc[:, 2] > 0.05
    uv = camera.project(pc)
    radius = torch.full((pt_xyz.shape[0],), float(radius_scale),
                        dtype=torch.float32, device=pt_xyz.device)
    mask = matching.projection_mask(uv, z_ok & pt_valid, xy, valid, radius)
    idx, _ = matching.masked_nn_match(
        matching.hamming_matrix(pt_desc, desc), mask,
        max_dist=matching.TH_LOW, ratio=1.0, mutual=False, use_ratio=False,
    )
    return idx
