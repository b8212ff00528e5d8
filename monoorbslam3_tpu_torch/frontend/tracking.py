"""The two fused tracking stages (counterpart of `_project_points`,
`_scatter_by_feature`, `_coarse_track_kernel` and `_local_track_kernel` in
`monoorbslam3_tpu/frontend/tracking.py`).

Each stage is one chain of device work with no host read inside: project
the candidates, run the gated match (K2) at the tight radius AND at the
wide radius, pick one of the two on the device with `torch.where` (the
reference's wide retry, Tracking.cpp:284-314), assemble the per-feature
problem and run the visual pose LM. The caller reads the stage's result
with one `utils.fetch.fetch`. The `Tracking` state machine joins with the
init slice of the port.
"""

from __future__ import annotations

import torch

from ..backend.problems import _identity_edge, _pose_optimize_impl
from ..backend.residuals import KfState
from ..ops import matching
from ..ops.match_pallas import projected_match


def _project_points(R_wb, t_wb, R_cb, t_cb, xyz, camera):
    """Batched world->pixel projection + visibility."""
    R_cw = R_cb @ R_wb.T
    t_cw = t_cb - R_cw @ t_wb
    pc = xyz @ R_cw.T + t_cw
    uv = camera.project(pc)
    ok = (pc[:, 2] > 0.05) & camera.is_in_image(uv)
    return uv, ok


def _scatter_by_feature(idx, hit, n_feat, cand_xyz, cand_extra2):
    """Scatter per-candidate match results into per-feature problem rows.
    Mutual-NN matching guarantees each feature is hit by <= 1 candidate;
    unmatched candidates write the dropped overflow row n_feat."""
    P = cand_xyz.shape[0]
    dev = cand_xyz.device
    f_t = torch.where(hit, idx, torch.full_like(idx, n_feat)).long()
    pts = torch.zeros((n_feat + 1, 3), dtype=torch.float32, device=dev)
    pts[f_t] = cand_xyz
    extra2 = torch.zeros(n_feat + 1, dtype=torch.float32, device=dev)
    extra2[f_t] = cand_extra2
    vo = torch.zeros(n_feat + 1, dtype=torch.bool, device=dev)
    vo[f_t] = hit
    ci = torch.full((n_feat + 1,), -1, dtype=torch.int32, device=dev)
    ci[f_t] = torch.arange(P, dtype=torch.int32, device=dev)
    vo = vo[:n_feat]
    return (pts[:n_feat], extra2[:n_feat], vo,
            torch.where(vo, ci[:n_feat], torch.full_like(ci[:n_feat], -1)))


def _coarse_track_kernel(state0, cand_xyz, cand_desc, cand_valid, cand_ang,
                         cand_extra2, fr_xy, fr_desc, fr_valid, fr_angle,
                         fr_sigma2, camera, R_cb, t_cb, radius, retry_below,
                         use_rotation=True):
    """The coarse tracking stage: project, two-radius projection match (the
    wide pass selected on the device when the tight pass is weak), rotation-
    consistency filter, per-feature problem assembly, visual pose LM.

    Returns (state, cand_of_feature [N] i32, n_match, n_inliers)."""
    uv, ok = _project_points(state0.R_wb, state0.t_wb, R_cb, t_cb, cand_xyz, camera)
    va = ok & cand_valid

    def match_at(r):
        idx, _ = projected_match(
            cand_desc, fr_desc, uv_a=uv, xy_b=fr_xy, radius=r,
            valid_a=va, valid_b=fr_valid, max_dist=matching.TH_HIGH, ratio=0.9)
        if use_rotation:
            keep = matching.rotation_consistency_mask(
                cand_ang, fr_angle, torch.clamp(idx, min=0).long(), idx >= 0,
                min_keep_frac=0.5)
            idx = torch.where(keep, idx, torch.full_like(idx, -1))
        return idx

    idx1 = match_at(radius)
    idx2 = match_at(radius * 2.0)
    idx = torch.where(torch.sum(idx1 >= 0) < retry_below, idx2, idx1)
    n_match = torch.sum(idx >= 0)

    N = fr_xy.shape[0]
    pts, extra2, vo, ci = _scatter_by_feature(idx, idx >= 0, N, cand_xyz, cand_extra2)
    inv_s2 = 1.0 / (fr_sigma2 + extra2)
    z = KfState.zeros(device=cand_xyz.device)
    state, inlier = _pose_optimize_impl(
        state0, pts, fr_xy, inv_s2, vo, camera, R_cb, t_cb,
        _identity_edge(cand_xyz.device), z, 0.0, z, None,
        use_inertial=False, use_prior=False)
    inl = inlier & vo
    return state, torch.where(inl, ci, torch.full_like(ci, -1)), n_match, torch.sum(inl)


def _local_track_kernel(state0, cand_xyz, cand_desc, cand_valid, cand_normal,
                        cand_use_vcos, cand_extra2, radius, blockrow,
                        coarse_pts, coarse_inv_s2, coarse_valid,
                        fr_xy, fr_desc, fr_valid, fr_sigma2,
                        camera, R_cb, t_cb, t_bc, view_cos_gate, retry_min,
                        edge, last_state, edge_valid, use_inertial):
    """The local-map tracking stage: project, view-cos gate, two-radius match
    (the 2.5x wide pass selected on the device when the tight pass
    re-captures under half the in-view candidates), merge with the coarse
    associations, visual pose LM. `use_inertial=True` belongs to the IMU
    slice and raises NotImplementedError in the pose LM.

    blockrow[f] = candidate row of the point the coarse stage assigned to
    feature f (-1 none): the coarse association survives unless the local
    search re-matched that same point at a different feature.

    Returns (state, cand_of_feature, keep_coarse, cand_hit, n_inliers)."""
    uv, ok = _project_points(state0.R_wb, state0.t_wb, R_cb, t_cb, cand_xyz, camera)
    center = state0.t_wb + state0.R_wb @ t_bc
    vec = cand_xyz - center
    dist = torch.linalg.norm(vec, dim=1)
    ray = vec / torch.clamp(dist, min=1e-9)[:, None]
    view_cos = torch.sum(ray * cand_normal, dim=1)
    ok = ok & (~cand_use_vcos | (view_cos > view_cos_gate))
    va = ok & cand_valid

    def match_at(r):
        idx, _ = projected_match(
            cand_desc, fr_desc, uv_a=uv, xy_b=fr_xy, radius=r,
            valid_a=va, valid_b=fr_valid, max_dist=matching.TH_HIGH, ratio=0.8)
        return idx

    idx1 = match_at(radius)
    idx2 = match_at(radius * 2.5)
    thresh = torch.clamp(torch.sum(va) // 2, min=retry_min)
    idx = torch.where(torch.sum(idx1 >= 0) < thresh, idx2, idx1)
    hit = idx >= 0

    N = fr_xy.shape[0]
    lpts, lex2, lvo, lci = _scatter_by_feature(idx, hit, N, cand_xyz, cand_extra2)
    br = torch.clamp(blockrow, min=0).long()
    idx_br = idx[br]
    br_matched_elsewhere = ((blockrow >= 0) & (idx_br >= 0)
                            & (idx_br != torch.arange(N, dtype=idx.dtype, device=idx.device)))
    cvalid = coarse_valid & ~br_matched_elsewhere & ~lvo
    pts = torch.where(lvo[:, None], lpts, coarse_pts)
    vo = lvo | cvalid
    inv_s2 = torch.where(lvo, 1.0 / (fr_sigma2 + lex2), coarse_inv_s2)

    z = KfState.zeros(device=cand_xyz.device)
    state, inlier = _pose_optimize_impl(
        state0, pts, fr_xy, inv_s2, vo, camera, R_cb, t_cb,
        edge, last_state, edge_valid, z, None,
        use_inertial=use_inertial, use_prior=False)
    inl = inlier & vo
    return (state, torch.where(lvo & inl, lci, torch.full_like(lci, -1)), cvalid & inl,
            hit, torch.sum(inl))
