"""Map-state checkpoint/restore (counterpart of
`monoorbslam3_tpu/models/checkpoint.py`, in the same npz format: each
package reads the other's files).

The whole MapStore plus the caller's runtime scalars round-trip through
one compressed npz, with the per-keyframe raw IMU windows needed for
re-integration. The reference is save-only at shutdown
(System.cpp:125-222)."""

from __future__ import annotations

import json

import numpy as np

from .imu import ImuBuffer
from .map_state import MapStore

_ARRAY_FIELDS = [
    "kf_valid", "kf_time", "kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba",
    "kf_parent", "kf_feat_xy", "kf_feat_level", "kf_feat_angle",
    "kf_feat_desc", "kf_feat_valid", "kf_feat_sigma2", "kf_feat_pt",
    "kf_feat_group", "kf_prior_inv_sigma",
    "pt_valid", "pt_xyz", "pt_desc", "pt_normal", "pt_min_dist",
    "pt_max_dist", "pt_sigma_z", "pt_first_kf", "pt_visible", "pt_found",
    "pt_obs_kf", "pt_obs_feat", "pt_n_obs",
]


def save_map(store: MapStore, path: str, extra: dict | None = None):
    """Serialize the full map (+ optional runtime scalars) to one npz."""
    payload = {name: getattr(store, name) for name in _ARRAY_FIELDS}
    meta = {
        "max_kf": store.max_kf, "max_pt": store.max_pt,
        "n_feat": store.n_feat, "max_obs": store.max_obs,
        "kf_order": store._kf_order,
        "free_pt": store._free_pt,
        "free_kf": store._free_kf,
        "next_kf_slot": store._next_kf_slot,
        "kf_created_total": store.kf_created_total,
        "version": store.version,
        "extra": extra or {},
    }
    payload["_meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8).copy()
    # IMU windows: ragged -> concatenated with index
    kf_ids, lens, samples = [], [], []
    for k, buf in store.kf_imu.items():
        kf_ids.append(k)
        lens.append(buf.n)
        samples.append(np.concatenate(
            [buf.gyro[:buf.n], buf.acc[:buf.n], buf.dts[:buf.n, None]], axis=1))
    payload["_imu_kf"] = np.asarray(kf_ids, np.int64)
    payload["_imu_len"] = np.asarray(lens, np.int64)
    payload["_imu_data"] = (np.concatenate(samples, axis=0)
                            if samples else np.zeros((0, 7), np.float32))
    np.savez_compressed(path, **payload)


def load_map(path: str) -> tuple[MapStore, dict]:
    """Restore a MapStore (+ the extra dict saved with it)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["_meta"]).decode())
    store = MapStore(max_kf=meta["max_kf"], max_pt=meta["max_pt"],
                     n_feat=meta["n_feat"], max_obs=meta["max_obs"])
    for name in _ARRAY_FIELDS:
        getattr(store, name)[...] = data[name]
    store._kf_order = list(meta["kf_order"])
    store._free_pt = list(meta["free_pt"])
    store._free_kf = list(meta.get("free_kf", []))
    store._next_kf_slot = meta["next_kf_slot"]
    store.kf_created_total = meta.get("kf_created_total",
                                      meta["next_kf_slot"])
    store.version = meta["version"]

    off = 0
    for k, n in zip(data["_imu_kf"], data["_imu_len"]):
        buf = ImuBuffer(capacity=max(64, int(n)))
        block = data["_imu_data"][off:off + n]
        off += int(n)
        for row in block:
            buf.add(row[0:3], row[3:6], float(row[6]))
        store.kf_imu[int(k)] = buf
    return store, meta["extra"]
