"""Host-side map store: keyframes, map points, observations, covisibility
(counterpart of `monoorbslam3_tpu/models/map_state.py`).

The reference map data model (modules/BasicObject/Map.h:21-73,
KeyFrame.h:26-171, MapPoint.h:18-117) is a pointer graph; here, as in the
JAX package, the map is a struct-of-arrays numpy store with fixed
capacities and validity masks. Deletions are mask flips; slots are
recycled through free lists. The arithmetic is the JAX package's, in the
same order: after the same sequence of calls the two stores hold the same
bits in every array and the same free lists, order and counters.

Covisibility (KeyFrame.cpp:225-345) is recomputed on demand from the
observation table (`native.covis_counts`); the spanning tree
(KeyFrame.cpp:402-467) is implied by `kf_parent` (closest covisible
predecessor), reassigned on culling.
"""

from __future__ import annotations

import logging

import numpy as np

from .imu import ImuBuffer

log = logging.getLogger("monoorbslam3_tpu_torch.map")


class MapStore:
    """Global SLAM map with fixed capacities."""

    def __init__(self, max_kf: int = 512, max_pt: int = 32768, n_feat: int = 1024,
                 max_obs: int = 24):
        self.max_kf, self.max_pt, self.n_feat, self.max_obs = max_kf, max_pt, n_feat, max_obs

        # --- keyframes ---
        self.kf_valid = np.zeros(max_kf, bool)
        self.kf_time = np.zeros(max_kf, np.float64)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (max_kf, 1, 1))  # R_wb
        self.kf_t = np.zeros((max_kf, 3), np.float32)  # t_wb
        self.kf_v = np.zeros((max_kf, 3), np.float32)
        self.kf_bg = np.zeros((max_kf, 3), np.float32)
        self.kf_ba = np.zeros((max_kf, 3), np.float32)
        self.kf_parent = np.full(max_kf, -1, np.int32)

        self.kf_feat_xy = np.zeros((max_kf, n_feat, 2), np.float32)
        self.kf_feat_level = np.zeros((max_kf, n_feat), np.int32)
        self.kf_feat_angle = np.zeros((max_kf, n_feat), np.float32)
        self.kf_feat_desc = np.zeros((max_kf, n_feat, 8), np.uint32)
        self.kf_feat_valid = np.zeros((max_kf, n_feat), bool)
        self.kf_feat_sigma2 = np.ones((max_kf, n_feat), np.float32)
        self.kf_feat_pt = np.full((max_kf, n_feat), -1, np.int32)
        # vocabulary node id per feature (-1 = no BoW info; the KeyFrame
        # FeatureVector analog used to gate SearchByBow/SearchForTriangulation)
        self.kf_feat_group = np.full((max_kf, n_feat), -1, np.int32)

        # per-KF velocity/bias prior information (diag inv-sigma), filled
        # from preintegration covariance at KF creation (KeyFrame.cpp:86-98)
        self.kf_prior_inv_sigma = np.zeros((max_kf, 9), np.float32)

        # preintegration buffer KF -> next KF (raw samples for replay)
        self.kf_imu: dict[int, ImuBuffer] = {}

        # --- map points ---
        self.pt_valid = np.zeros(max_pt, bool)
        self.pt_xyz = np.zeros((max_pt, 3), np.float32)
        self.pt_desc = np.zeros((max_pt, 8), np.uint32)
        self.pt_normal = np.zeros((max_pt, 3), np.float32)
        self.pt_min_dist = np.zeros(max_pt, np.float32)
        self.pt_max_dist = np.zeros(max_pt, np.float32)
        # along-ray (depth) standard deviation estimate, map units; drives
        # per-observation sigma inflation in the frame optimizer (points
        # with little observation parallax must not vote on depth)
        self.pt_sigma_z = np.full(max_pt, 1e3, np.float32)
        self.pt_first_kf = np.full(max_pt, -1, np.int32)
        self.pt_visible = np.zeros(max_pt, np.int32)
        self.pt_found = np.zeros(max_pt, np.int32)
        self.pt_obs_kf = np.full((max_pt, max_obs), -1, np.int32)
        self.pt_obs_feat = np.full((max_pt, max_obs), -1, np.int32)
        self.pt_n_obs = np.zeros(max_pt, np.int32)

        self._kf_order: list[int] = []  # insertion order of valid KF slots
        self._free_pt: list[int] = list(range(max_pt - 1, -1, -1))
        self._free_kf: list[int] = []  # culled slots, recycled like points
        self._next_kf_slot = 0
        # monotonic creation counter (the reference's KeyFrame::id): slot
        # ids recycle, so anything keyed on "how many KFs ever existed"
        # (e.g. the IMU-init trigger, LocalMapping.cpp:57-60) uses this
        self.kf_created_total = 0
        self.version = 0  # map-change epoch (Map.cpp:126-144 analog)

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------

    def n_keyframes(self) -> int:
        return len(self._kf_order)

    def keyframe_ids(self) -> list[int]:
        return list(self._kf_order)

    def recent_keyframes(self, n: int) -> list[int]:
        """Sliding window of the newest n KFs (Map::getRecentKeyFrames,
        Map.cpp:42-53)."""
        return self._kf_order[-n:]

    def _alloc_kf_slot(self) -> int:
        """Fresh slot, recycled culled slot, or — at hard capacity — evict
        the least-connected old KF (graceful degradation; the reference's
        map grows unboundedly, Map.h:62-63, so it never faces this)."""
        if self._next_kf_slot < self.max_kf:
            k = self._next_kf_slot
            self._next_kf_slot += 1
            return k
        if self._free_kf:
            return self._free_kf.pop()
        return self._evict_for_slot()

    def _evict_for_slot(self) -> int:
        """At capacity: cull the weakest old keyframe to free a slot.
        Victims exclude the gauge-anchoring first KF and the newest 8
        (the local-BA window + preintegration chain); weakest = fewest
        attached map-point observations, ties to oldest."""
        candidates = self._kf_order[1:-8] or self._kf_order[1:-1]
        assert candidates, "keyframe capacity too small to evict"
        n_obs = np.array([(self.kf_feat_pt[k] >= 0).sum() for k in candidates])
        victim = candidates[int(np.argmin(n_obs))]
        log.warning("keyframe capacity %d reached: evicting KF slot %d "
                    "(%d observations)", self.max_kf, victim, n_obs.min())
        self.remove_keyframe(victim)
        return self._free_kf.pop()

    def add_keyframe(self, time, R_wb, t_wb, v, bg, ba, features: dict,
                     prior_inv_sigma=None) -> int:
        k = self._alloc_kf_slot()
        self.kf_created_total += 1
        # clear any recycled-slot residue not overwritten below (stale
        # feature rows beyond nf are masked by kf_feat_valid, but clear
        # them anyway so no code path can read a dead KF's features)
        self.kf_feat_valid[k] = False
        self.kf_feat_group[k] = -1
        self.kf_prior_inv_sigma[k] = 0.0
        self.kf_parent[k] = -1
        self.kf_valid[k] = True
        self.kf_time[k] = time
        self.kf_R[k] = R_wb
        self.kf_t[k] = t_wb
        self.kf_v[k] = v
        self.kf_bg[k] = bg
        self.kf_ba[k] = ba
        nf = min(self.n_feat, len(features["xy"]))
        self.kf_feat_xy[k, :nf] = features["xy"][:nf]
        self.kf_feat_level[k, :nf] = features["level"][:nf]
        self.kf_feat_angle[k, :nf] = features["angle"][:nf]
        self.kf_feat_desc[k, :nf] = features["desc"][:nf]
        self.kf_feat_valid[k, :nf] = features["valid"][:nf]
        self.kf_feat_sigma2[k, :nf] = features.get(
            "sigma2", np.ones(nf, np.float32)
        )[:nf]
        if features.get("group") is not None:
            self.kf_feat_group[k, :nf] = features["group"][:nf]
        self.kf_feat_pt[k] = -1
        if prior_inv_sigma is not None:
            self.kf_prior_inv_sigma[k] = prior_inv_sigma
        if self._kf_order:
            self.kf_parent[k] = self._kf_order[-1]
        self._kf_order.append(k)
        self.version += 1
        return k

    def remove_keyframe(self, k: int):
        """Cull a KF: detach observations and merge its IMU window into the
        predecessor (Map.cpp:21-30 / Imu MergeNext)."""
        if not self.kf_valid[k]:
            return
        order_idx = self._kf_order.index(k)
        # merge IMU samples into predecessor's window
        if order_idx > 0:
            prev = self._kf_order[order_idx - 1]
            if prev in self.kf_imu and k in self.kf_imu:
                self.kf_imu[prev].extend(self.kf_imu[k])
        self.kf_imu.pop(k, None)
        # detach from points
        for f in np.nonzero(self.kf_feat_pt[k] >= 0)[0]:
            self.remove_observation(int(self.kf_feat_pt[k, f]), k)
        self.kf_valid[k] = False
        self.kf_feat_pt[k] = -1
        self._kf_order.remove(k)
        # reassign children's parent to this KF's parent
        children = np.nonzero(self.kf_parent == k)[0]
        self.kf_parent[children] = self.kf_parent[k]
        self._free_kf.append(k)
        self.version += 1

    def kf_pose_cw(self, k: int, R_cb, t_cb):
        """World->camera pose of KF k given extrinsics."""
        R_cw = R_cb @ self.kf_R[k].T
        t_cw = t_cb - R_cw @ self.kf_t[k]
        return R_cw, t_cw

    # ------------------------------------------------------------------
    # points
    # ------------------------------------------------------------------

    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def add_point(self, xyz, desc, first_kf: int) -> int:
        if not self._free_pt:
            self._evict_points()
        p = self._free_pt.pop()
        self.pt_valid[p] = True
        self.pt_xyz[p] = xyz
        self.pt_desc[p] = desc
        self.pt_first_kf[p] = first_kf
        self.pt_visible[p] = 1
        self.pt_found[p] = 1
        self.pt_n_obs[p] = 0
        self.pt_obs_kf[p] = -1
        self.pt_obs_feat[p] = -1
        return p

    def add_observation(self, p: int, k: int, feat: int):
        n = self.pt_n_obs[p]
        if n >= self.max_obs:
            return  # observation table full; keep the oldest
        self.pt_obs_kf[p, n] = k
        self.pt_obs_feat[p, n] = feat
        self.pt_n_obs[p] = n + 1
        self.kf_feat_pt[k, feat] = p

    def remove_observation(self, p: int, k: int):
        obs = self.pt_obs_kf[p, : self.pt_n_obs[p]]
        sel = np.nonzero(obs == k)[0]
        if len(sel) == 0:
            return
        i = sel[0]
        n = self.pt_n_obs[p]
        feat = self.pt_obs_feat[p, i]
        if self.kf_feat_pt[k, feat] == p:
            self.kf_feat_pt[k, feat] = -1
        self.pt_obs_kf[p, i : n - 1] = self.pt_obs_kf[p, i + 1 : n]
        self.pt_obs_feat[p, i : n - 1] = self.pt_obs_feat[p, i + 1 : n]
        self.pt_obs_kf[p, n - 1] = -1
        self.pt_obs_feat[p, n - 1] = -1
        self.pt_n_obs[p] = n - 1
        if self.pt_n_obs[p] <= 1 and self.pt_valid[p]:
            self.remove_point(p)

    def _evict_points(self, batch: int = 1024):
        """At point capacity: free a batch of the weakest landmarks
        (fewest observations, then lowest found ratio) — graceful
        degradation for long sequences, like the KF-slot eviction. The
        reference's point set grows unboundedly (Map.h:63)."""
        valid = np.nonzero(self.pt_valid)[0]
        n = min(batch, len(valid))
        assert n > 0, "point capacity too small to evict"
        found_ratio = self.pt_found[valid] / np.maximum(self.pt_visible[valid], 1)
        score = self.pt_n_obs[valid].astype(np.float64) + 0.9 * found_ratio
        victims = valid[np.argpartition(score, n - 1)[:n]]
        log.warning("map point capacity %d reached: evicting %d weakest "
                    "landmarks", self.max_pt, n)
        for p in victims:
            self.remove_point(int(p))

    def remove_point(self, p: int):
        if not self.pt_valid[p]:
            return
        for i in range(self.pt_n_obs[p]):
            k, f = self.pt_obs_kf[p, i], self.pt_obs_feat[p, i]
            if k >= 0 and self.kf_feat_pt[k, f] == p:
                self.kf_feat_pt[k, f] = -1
        self.pt_valid[p] = False
        self.pt_n_obs[p] = 0
        self.pt_obs_kf[p] = -1
        self.pt_obs_feat[p] = -1
        self._free_pt.append(p)

    def replace_point(self, p_old: int, p_new: int):
        """Fuse: every observation of p_old re-targets p_new
        (MapPoint::replace, MapPoint.cpp:210-264)."""
        if p_old == p_new or not self.pt_valid[p_old]:
            return
        obs = [(int(self.pt_obs_kf[p_old, i]), int(self.pt_obs_feat[p_old, i]))
               for i in range(self.pt_n_obs[p_old])]
        self.pt_found[p_new] += self.pt_found[p_old]
        self.pt_visible[p_new] += self.pt_visible[p_old]
        self.remove_point(p_old)
        existing = set(self.pt_obs_kf[p_new, : self.pt_n_obs[p_new]].tolist())
        for k, f in obs:
            if k >= 0 and k not in existing:
                self.add_observation(p_new, k, f)

    def update_point_stats(self, pids, R_cb, t_cb, scale_factors):
        """Recompute representative descriptor, viewing normal and scale band
        for the given points (MapPoint.cpp:43-152)."""
        for p in pids:
            if not self.pt_valid[p]:
                continue
            n = self.pt_n_obs[p]
            if n == 0:
                continue
            kfs = self.pt_obs_kf[p, :n]
            feats = self.pt_obs_feat[p, :n]
            descs = self.kf_feat_desc[kfs, feats]  # [n, 8]
            # min-median-Hamming representative descriptor
            x = descs[:, None, :] ^ descs[None, :, :]
            dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            med = np.median(dist, axis=1)
            self.pt_desc[p] = descs[int(np.argmin(med))]
            # viewing normal + scale band from the reference (= first) obs
            centers = np.stack([
                self.kf_t[k] + self.kf_R[k] @ (-(R_cb.T @ t_cb)) for k in kfs
            ])
            vecs = self.pt_xyz[p][None] - centers
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            self.pt_normal[p] = (vecs / np.maximum(norms, 1e-9)).mean(0)
            self.pt_normal[p] /= max(np.linalg.norm(self.pt_normal[p]), 1e-9)
            # depth uncertainty from the observation-baseline span:
            # sigma_z ~ (sigma_px / f) * zbar^2 / b_span  (f ~ 450 px,
            # sigma_px ~ 0.6 combining both views)
            zbar = float(norms.mean())
            if n >= 2:
                d2 = centers[:, None, :] - centers[None, :, :]
                b_span = float(np.sqrt((d2 ** 2).sum(-1)).max())
            else:
                b_span = 0.0
            self.pt_sigma_z[p] = (0.6 / 450.0) * zbar * zbar / max(b_span, 1e-4)
            ref_i = n - 1
            dist_ref = float(norms[ref_i, 0])
            level = int(self.kf_feat_level[kfs[ref_i], feats[ref_i]])
            sf = float(scale_factors[level])
            n_levels = len(scale_factors)
            self.pt_max_dist[p] = dist_ref * sf
            self.pt_min_dist[p] = self.pt_max_dist[p] / float(scale_factors[n_levels - 1])

    # ------------------------------------------------------------------
    # covisibility
    # ------------------------------------------------------------------

    def covisibility_weights(self, k: int) -> dict[int, int]:
        """#shared map points between KF k and every other KF
        (KeyFrame::updateConnections analog, KeyFrame.cpp:225-291).
        Hot host-graph scan -> native C++ kernel with numpy fallback."""
        from .. import native

        counts = native.covis_counts(self.kf_feat_pt[k], self.pt_obs_kf,
                                     self.pt_n_obs, self.max_kf, k)
        nz = np.nonzero(counts)[0]
        return {int(j): int(counts[j]) for j in nz}

    def covisible_keyframes(self, k: int, min_weight: int = 15, top: int | None = None):
        w = self.covisibility_weights(k)
        items = sorted(((c, j) for j, c in w.items() if c >= min_weight), reverse=True)
        if not items:  # fall back to best single neighbor
            items = sorted(((c, j) for j, c in w.items()), reverse=True)[:1]
        out = [j for c, j in items]
        return out[:top] if top else out

    # ------------------------------------------------------------------
    # gauge transform
    # ------------------------------------------------------------------

    def apply_scale_rotation(self, R_gw: np.ndarray, scale: float,
                             t_bc: np.ndarray | None = None):
        """Whole-map gauge rewrite after inertial init (Map::applyScaleRotation,
        Map.cpp:96-124): world frame rotated by R_gw, scaled by `scale`.

        IMPORTANT: the monocular scale applies to CAMERA CENTERS and points;
        the camera-to-IMU lever arm t_bc is metric and must not scale (the
        reference's gauge code scales Oc, not the body origin). Body
        translations therefore transform as
            t_wb' = R_gw (s t_wb + (s - 1) R_wb t_bc).
        """
        R_gw = R_gw.astype(np.float32)
        if t_bc is None:
            t_bc = np.zeros(3, np.float32)
        lever = np.einsum("kij,j->ki", self.kf_R, t_bc.astype(np.float32))
        self.kf_t[:] = (scale * self.kf_t + (scale - 1.0) * lever) @ R_gw.T
        self.kf_R[:] = R_gw[None] @ self.kf_R
        self.kf_v[:] = scale * (self.kf_v @ R_gw.T)
        self.pt_xyz[:] = scale * (self.pt_xyz @ R_gw.T)
        self.pt_min_dist *= scale
        self.pt_max_dist *= scale
        self.pt_normal[:] = self.pt_normal @ R_gw.T
        self.version += 1

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    def keyframe_states(self, ids):
        idx = np.asarray(ids, np.int32)
        return (self.kf_R[idx], self.kf_t[idx], self.kf_v[idx],
                self.kf_bg[idx], self.kf_ba[idx])

    def reset(self):
        self.__init__(self.max_kf, self.max_pt, self.n_feat, self.max_obs)
