"""Native (C++) host runtime, built by g++ at first use (counterpart of
`monoorbslam3_tpu/native/__init__.py`). Host code, not device kernels.

- `map_ops` (`src/map_ops.cpp`): the map store's bookkeeping scans,
  `covis_counts` (KeyFrame.cpp:225-291) and `redundancy_count`
  (LocalMapping.cpp:318-372);
- `dataloader` (`src/dataloader.cpp`, linked with zlib and pthreads): PNG
  and PNM decode to float32 grayscale, the IMU text parser and a threaded
  in-order image prefetcher (test/Data.h:14-49; the demo mains'
  cv::imread path).

Each is a CPython extension compiled into `_build/` beside this file. The
map scans have numpy fallbacks that give the same result, and the loader's
callers fall back to PIL and the Python parser
(`runners/datasets.py`), taken when no compiler is present, the build
fails (its g++ output is kept in `build_errors`) or `MONOSLAM_NO_NATIVE`
is set. `branch(name)` says which one a process takes.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig
import time

import numpy as np

_exts: dict[str, object] = {}
_LINK_FLAGS = {"dataloader": ["-lz", "-pthread"]}
# the compiler's output of each failed build, by module name
build_errors: dict[str, str] = {}


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
    cmd = (["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}", src, "-o", tmp]
           + _LINK_FLAGS.get(name, []))
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except subprocess.CalledProcessError as e:
        build_errors[name] = f"{' '.join(cmd)}\n{e.stderr}"
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        build_errors[name] = f"{' '.join(cmd)}\n{e!r}"
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


def branch(name: str) -> str:
    """"native" when the module `name` loads, else "fallback"."""
    return "native" if get_ext(name) is not None else "fallback"


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


def load_gray(path: str) -> np.ndarray | None:
    """Native PNG/PNM decode to float32 grayscale [H, W] (ITU-R 601 luma),
    or None without the module or for a file it does not decode (the caller
    falls back to PIL or cv2)."""
    ext = get_ext("dataloader")
    if ext is None:
        return None
    try:
        h, w, buf = ext.load_gray(path)
    except ValueError:
        return None
    return np.frombuffer(buf, np.float32).reshape(h, w).copy()


def parse_imu(path: str) -> np.ndarray | None:
    """Native 't gx gy gz ax ay az' parser (strictly increasing t,
    test/Data.h:29-49) -> [N, 7] float64, or None without the module."""
    ext = get_ext("dataloader")
    if ext is None:
        return None
    raw = ext.parse_imu(path)
    return np.frombuffer(raw, np.float64).reshape(-1, 7).copy()


class ImagePrefetcher:
    """Threaded in-order image prefetch: C++ workers decode ahead of the
    consumer without the GIL. Iterating yields float32 [H, W] grayscale
    frames in path order; a frame the native decoder refuses is decoded by
    `fallback(path)` instead. Without the module every frame goes through
    `fallback`, synchronously. `wait_s` sums the seconds the consumer waited
    in `__next__`."""

    def __init__(self, paths, fallback, workers: int = 2, depth: int = 8):
        self.paths = list(paths)
        self.fallback = fallback
        self._ext = get_ext("dataloader")
        self._cap = (self._ext.prefetch_open(self.paths, int(workers), int(depth))
                     if self._ext is not None else None)
        self._idx = 0
        self.wait_s = 0.0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._idx >= len(self.paths):
            raise StopIteration
        path = self.paths[self._idx]
        self._idx += 1
        t0 = time.perf_counter()
        try:
            if self._cap is None:
                return self.fallback(path)
            out = self._ext.prefetch_next(self._cap)
            if out is None:  # the queue ended early
                raise StopIteration
            h, w, buf = out
            if h == 0:  # the native decode failed (buf holds the error)
                return self.fallback(path)
            return np.frombuffer(buf, np.float32).reshape(h, w).copy()
        finally:
            self.wait_s += time.perf_counter() - t0
