"""Single-card entry point and multi-rank dry run (counterpart of the
repository's `__graft_entry__.py`).

- `entry(device)` returns the flagship tracking step and its example
  arguments on `device` (the card by default): ORB extraction on a full
  EuRoC-resolution image (752x480, 1,024 features; K1 inside), projection
  of a map window with the predicted pose, the fused gated match
  `projected_match` (K2, both passes) and the 4x10 frame-pose LM, visual
  only. The step makes no host read: its outputs stay on the device.
- `dryrun_multichip(n, device)` runs the JAX script's three checks on a
  group of n ranks, one process each (`parallel.multihost.run_ranks`:
  NCCL on cards, gloo on the CPU): one distributed Schur-complement BA
  step on a tiny point-sharded problem, the live mapper's
  `Problems(mesh=).local_full_bundle_adjustment` on a 4-keyframe store,
  and the data-parallel batch extractor with one image a rank.

The example inputs are drawn with the same `np.random.default_rng` calls
in the same order as the JAX script's, so both packages see the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend.problems import Problems, _identity_edge, _pose_optimize_impl
from .backend.residuals import KfState, PreintEdge
from . import convert
from .backend.solver import BAProblem
from .models.camera import Pinhole
from .models.imu import ImuBuffer, ImuCalib
from .models.map_state import MapStore
from .ops import matching
from .ops.match_pallas import projected_match
from .ops.orb import OrbExtractor
from .parallel import frontend_dp, multihost
from .parallel.sharded_ba import shard_problem_by_point, sharded_schur_ba
from .utils.device import CARD, resolve

H, W, N = 480, 752, 1024
FLAGSHIP_CAM = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375)


def seeded_inputs(H=H, W=W, N=N):
    """The flagship's example inputs as numpy, drawn as `__graft_entry__`
    draws them: (image [H, W] f32, pt_xyz [N, 3] f32, pt_desc [N, 8] u32,
    pt_valid [N] bool, R0 [3, 3], t0 [3])."""
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (H, W)).astype(np.float32)
    pt_xyz = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                       rng.uniform(2, 9, N)], -1).astype(np.float32)
    pt_desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    return (image, pt_xyz, pt_desc, np.ones(N, bool), np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32))


def upload(arrays, device) -> tuple:
    """The step's numpy inputs as tensors on `device` (uint32 descriptors
    as their int32 view, the extractor's type)."""
    return tuple(convert.tensor(a, device) for a in arrays)


def flagship(device=CARD, H=H, W=W, N=N):
    """(tracking_step, extractor) for an H x W image with N features on
    `device`. `tracking_step(image, pt_xyz, pt_desc, pt_valid, R0, t0)`
    returns (R, t, n_inliers) as device tensors, without a host read."""
    dev = resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    cam = Pinhole.create(**FLAGSHIP_CAM, width=W, height=H, device=dev)
    ext = OrbExtractor(H, W, n_features=N, device=dev)
    R_cb, t_cb = torch.eye(3, **f32), torch.zeros(3, **f32)
    edge, dummy = _identity_edge(dev), KfState.zeros(device=dev)
    no_weight, no_prior = torch.zeros((), **f32), torch.zeros(9, **f32)

    def tracking_step(image, pt_xyz, pt_desc, pt_valid, R0, t0):
        """One frame: extract ORB -> project the map points with the
        predicted pose -> gated Hamming match -> LM pose optimization."""
        feats = ext._extract(image)
        z3 = torch.zeros(3, **f32)
        state0 = KfState(R0, t0, z3, z3, z3)
        R_cw = R_cb @ state0.R_wb.T
        t_cw = t_cb - R_cw @ state0.t_wb
        pc = pt_xyz @ R_cw.T + t_cw
        uv = cam.project(pc)
        ok = (pc[:, 2] > 0.05) & cam.is_in_image(uv) & pt_valid
        radius = torch.full((pt_xyz.shape[0],), 15.0, **f32)
        idx, _ = projected_match(pt_desc, feats["desc"], uv_a=uv, xy_b=feats["xy"],
                                 radius=radius, valid_a=ok, valid_b=feats["valid"],
                                 max_dist=matching.TH_HIGH, ratio=0.9)
        hit = idx >= 0
        safe = torch.clamp(idx, min=0).long()
        obs_uv = feats["xy"][safe]
        inv_s2 = 1.0 / 1.2 ** (2.0 * feats["level"][safe].to(torch.float32))
        state, inlier = _pose_optimize_impl(
            state0, pt_xyz, obs_uv, inv_s2, hit, cam, R_cb, t_cb, edge, dummy, no_weight,
            dummy, no_prior, use_inertial=False, use_prior=False)
        return state.R_wb, state.t_wb, inlier.sum()

    return tracking_step, ext


def entry(device=CARD):
    """(tracking_step, args): the flagship step at full EuRoC size and its
    seeded example arguments, on `device`."""
    step, _ = flagship(device)
    return step, upload(seeded_inputs(), device)


def dryrun_multichip(n_devices: int, device=CARD) -> list:
    """One distributed BA step, the live sharded mapper BA and the batch
    extractor on a group of `n_devices` ranks of `device`'s type (one
    process a rank; more ranks than cards raises). Returns each rank's
    results; raises with the rank's traceback when a check fails on any."""
    dev = resolve(device)
    return multihost.run_ranks(_dryrun_rank, n_devices, dev.type, args=(dev.type,))


def _check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(device_type: str) -> dict:
    """The body of `dryrun_multichip` on one rank (the JAX script's three
    checks; every rank draws the same inputs)."""
    info = multihost.process_info()
    n = info["process_count"]
    dev = torch.device(device_type, torch.cuda.current_device() if device_type == "cuda" else None)
    f32 = dict(dtype=torch.float32, device=dev)
    mesh = multihost.global_mesh(("dp",), device_type=dev.type)

    rng = np.random.default_rng(1)
    # 16 points a rank, as the JAX script has it, but at least 32: its store
    # samples 32 keyframe features from the points, which one rank's 16
    # cannot give (the JAX script raises there)
    K, P = 4, 16 * max(n, 2)
    O, E = 8 * P, K - 1
    cam = Pinhole.create(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480,
                         device=dev)
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 10, P)], -1).astype(np.float32)
    eye3 = torch.eye(3, **f32)
    z = torch.zeros((K, 3), **f32)
    kf = KfState(eye3.expand(K, 3, 3).clone(),
                 torch.as_tensor(np.cumsum(rng.uniform(0, 0.1, (K, 3)), 0).astype(np.float32),
                                 **f32), z, z.clone(), z.clone())
    obs_kf = torch.as_tensor(rng.integers(0, K, O), dtype=torch.int64, device=dev)
    obs_pt = np.arange(O) % P
    uv = cam.project(torch.as_tensor(pts[obs_pt], **f32))
    uv = uv + torch.as_tensor(rng.normal(0, 0.3, (O, 2)).astype(np.float32), **f32)
    dof = np.ones((K, 15), np.float32)
    dof[0] = 0.0
    z3, z33 = torch.zeros((E, 3), **f32), torch.zeros((E, 3, 3), **f32)
    edge = PreintEdge(
        dR=eye3.expand(E, 3, 3).clone(), dV=z3, dP=z3.clone(), JRg=z33, JVg=z33.clone(),
        JVa=z33.clone(), JPg=z33.clone(), JPa=z33.clone(), bg0=z3.clone(), ba0=z3.clone(),
        dt=torch.full((E,), 0.25, **f32), L_inv=torch.eye(9, **f32).expand(E, 9, 9).clone())
    problem = BAProblem(
        kf=kf, kf_dof=torch.as_tensor(dof, **f32), points=torch.as_tensor(pts, **f32),
        pt_active=torch.ones(P, dtype=torch.bool, device=dev),
        obs_kf=obs_kf, obs_pt=torch.as_tensor(obs_pt, dtype=torch.int64, device=dev),
        obs_uv=uv, obs_inv_sigma2=torch.ones(O, **f32),
        obs_valid=torch.ones(O, dtype=torch.bool, device=dev),
        ie_i=torch.arange(E, device=dev), ie_j=torch.arange(1, E + 1, device=dev),
        ie_edge=edge, ie_valid=torch.ones(E, dtype=torch.bool, device=dev),
        walk_inv_sigma=torch.full((E, 6), 10.0, **f32),
        walk_valid=torch.ones(E, dtype=torch.bool, device=dev),
        prior_inv_sigma=torch.zeros((K, 15), **f32), prior_ref=kf)
    sharded, dropped = shard_problem_by_point(problem, n)
    kf_out, pts_out, ba = sharded_schur_ba(sharded, cam, eye3, torch.zeros(3, **f32), mesh,
                                           n_iters=2)
    out = dict(rank=info["process_index"], ranks=n, device=str(dev), dropped=int(dropped),
               sharded_cost0=float(ba["cost0"]), sharded_cost=float(ba["cost"]),
               sharded_points_finite=bool(torch.isfinite(pts_out).all()))
    _check(np.isfinite(out["sharded_cost"]), "the sharded BA step diverged")

    # the live mapper BA entry point, distributed: a synthetic MapStore
    # through Problems.local_full_bundle_adjustment with the mesh
    n_feat = 32
    store = MapStore(max_kf=8, max_pt=P, n_feat=n_feat, max_obs=8)
    calib = ImuCalib.create(R_bc=np.eye(3), t_bc=np.zeros(3), noise_gyro=1.7e-4,
                            noise_acc=2e-3, walk_gyro=2e-5, walk_acc=3e-3, freq=200.0,
                            device=dev)
    pts_w = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                      rng.uniform(4, 10, P)], -1).astype(np.float32)
    descs = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    sel = rng.choice(P, n_feat, replace=False)
    slot_of = {}
    for i in range(4):
        t_wb = np.array([0.1 * i, 0.0, 0.0], np.float32)
        uvs = cam.project(torch.as_tensor(pts_w[sel] - t_wb, **f32)).cpu().numpy()
        feats = {"xy": uvs.astype(np.float32), "level": np.zeros(n_feat, np.int32),
                 "angle": np.zeros(n_feat, np.float32), "desc": descs[sel],
                 "valid": np.ones(n_feat, bool)}
        k = store.add_keyframe(0.25 * i, np.eye(3, dtype=np.float32), t_wb,
                               np.zeros(3, np.float32), np.zeros(3, np.float32),
                               np.zeros(3, np.float32), feats)
        buf = ImuBuffer()
        for _ in range(8):
            buf.add(np.zeros(3), np.array([0.0, 0.0, 9.8]), 0.03125)
        store.kf_imu[k] = buf
        for f, p in enumerate(sel):
            if i == 0:
                slot_of[int(p)] = store.add_point(pts_w[p], descs[p], k)
            store.add_observation(slot_of[int(p)], k, f)
    problems = Problems(cam, calib, local_k=8, local_p=P, local_o=4 * n_feat * 2, mesh=mesh,
                        device=dev)
    live = problems.local_full_bundle_adjustment(store, window=3, n_iters=2)
    out.update(live_cost0=float(live["cost0"]), live_cost=float(live["cost"]))
    _check(np.isfinite(out["live_cost"]), "the live sharded mapper BA diverged")

    # data-parallel bulk frontend: one image a rank through the full
    # extraction pipeline under the same mesh
    ext = OrbExtractor(64, 96, n_features=64, n_levels=2, device=dev)
    imgs = rng.uniform(0, 255, (n, 64, 96)).astype(np.float32)
    feats = frontend_dp.make_batch_extractor(ext, mesh)(imgs)
    out["extracted_frames"] = int(feats["desc"].shape[0])
    _check(out["extracted_frames"] == n, f"{out['extracted_frames']} frames extracted for {n}")
    return out
