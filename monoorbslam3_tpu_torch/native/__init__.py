"""Native (C++) host bookkeeping of the map store, built by g++ at first use
(counterpart of the `map_ops` part of `monoorbslam3_tpu/native/__init__.py`).

`covis_counts` (KeyFrame.cpp:225-291) and `redundancy_count`
(LocalMapping.cpp:318-372) scan the MapStore's numpy arrays in
`src/map_ops.cpp`, a CPython extension compiled into `_build/` beside this
file. Each has a numpy fallback that gives the same result, taken when no
compiler is present or `MONOSLAM_NO_NATIVE` is set. This is host code, not
a device kernel.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig

import numpy as np

_exts: dict[str, object] = {}


def _build(name: str) -> str | None:
    src = os.path.join(os.path.dirname(__file__), "src", name + ".cpp")
    cache = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(cache, exist_ok=True)
    so_path = os.path.join(cache, name + sysconfig.get_config_var("EXT_SUFFIX"))
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src):
        return so_path
    include = sysconfig.get_paths()["include"]
    # build under a name of this process, then rename: concurrent builders
    # (test workers) never load a half-written library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None


def get_ext(name: str = "map_ops"):
    """The compiled module, or None (the numpy fallbacks run)."""
    if name in _exts:
        return _exts[name]
    if os.environ.get("MONOSLAM_NO_NATIVE"):
        _exts[name] = None
        return None
    mod = None
    so_path = _build(name)
    if so_path is not None:
        import importlib.util

        spec = importlib.util.spec_from_file_location(name, so_path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except ImportError:
            mod = None
    _exts[name] = mod
    return mod


def covis_counts(pt_ids: np.ndarray, pt_obs_kf: np.ndarray,
                 pt_n_obs: np.ndarray, max_kf: int, exclude_kf: int) -> np.ndarray:
    """Shared-point counts vs every other keyframe (KeyFrame.cpp:225-291)."""
    ext = get_ext("map_ops")
    pt_ids = np.ascontiguousarray(pt_ids, np.int32)
    if ext is not None:
        raw = ext.covis_counts(
            pt_ids, np.ascontiguousarray(pt_obs_kf, np.int32),
            np.ascontiguousarray(pt_n_obs, np.int32),
            int(pt_obs_kf.shape[1]), int(max_kf), int(exclude_kf),
        )
        return np.frombuffer(raw, np.int32).copy()
    sel = pt_ids[pt_ids >= 0]
    if len(sel) == 0:
        return np.zeros(max_kf, np.int32)
    obs = pt_obs_kf[sel].reshape(-1)
    obs = obs[(obs >= 0) & (obs != exclude_kf)]
    return np.bincount(obs, minlength=max_kf).astype(np.int32)[:max_kf]


def redundancy_count(feat_pt, feat_level, pt_obs_kf, pt_obs_feat, pt_n_obs,
                     kf_feat_level, self_kf: int):
    """(n_checked, n_redundant) for the 90% culling rule
    (LocalMapping.cpp:318-372): a feature is redundant when its point is
    seen by >= 3 other keyframes at scale level <= its level + 1."""
    ext = get_ext("map_ops")
    n_feat = int(feat_pt.shape[0])
    if ext is not None:
        return ext.redundancy_count(
            np.ascontiguousarray(feat_pt, np.int32),
            np.ascontiguousarray(feat_level, np.int32),
            np.ascontiguousarray(pt_obs_kf, np.int32),
            np.ascontiguousarray(pt_obs_feat, np.int32),
            np.ascontiguousarray(pt_n_obs, np.int32),
            np.ascontiguousarray(kf_feat_level, np.int32),
            n_feat, int(pt_obs_kf.shape[1]), int(self_kf),
        )
    sel = np.nonzero(feat_pt >= 0)[0]
    if len(sel) == 0:
        return 0, 0
    pids = feat_pt[sel]
    lv = feat_level[sel]
    okf = pt_obs_kf[pids]  # [n, max_obs]
    ofe = pt_obs_feat[pids]
    valid = (okf >= 0) & (okf != self_kf)
    safe_kf = np.maximum(okf, 0)
    safe_fe = np.maximum(ofe, 0)
    levels = kf_feat_level[safe_kf, safe_fe]
    better = (valid & (levels <= lv[:, None] + 1)).sum(1)
    return int(len(sel)), int((better >= 3).sum())
