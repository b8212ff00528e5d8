"""Build and load the hand-written CUDA kernels of `csrc/`.

The kernels are compiled with `nvcc` for `sm_90a`, one process per source,
all started together, then linked into one shared library with a plain C
interface, loaded with ctypes. The library builds from the package's own
sources at first use, into `monoorbslam3_tpu_torch/_build/`, and rebuilds
when a source is newer than it. A failed build or load raises; there is no
fallback.

`launches` counts, per kernel, the launches its wrapper made: each wrapper
adds one right where it launches, nowhere else. `builds` counts this
process's builds of the library and the nvcc processes they started (a
measured run holds both at 0 after its warm-up).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
LIB = BUILD / "libmonoorb_kernels.so"
BUILD_LOG = BUILD / "nvcc.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

launches = {"gather_patches": 0, "match_rows": 0, "hamming": 0, "chol_solve": 0,
            "chol_solve_l2": 0}

builds = {"builds": 0, "nvcc_calls": 0}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # atlas, Ha, Wa, ys, xs, K, out, stream
    "gather_patches_f32": [_P, _I, _I, _P, _P, _I, _P, _P],
    # desc_a, ax, ay, r2a, ga, va, N, desc_b, bx, by, r2b, gb, vb, M,
    # best, second, idx, stream
    "match_rows_f32": [_P, _P, _P, _P, _P, _P, _I,
                       _P, _P, _P, _P, _P, _P, _I,
                       _P, _P, _P, _P],
    # N -> blocks of a launch
    "match_rows_blocks": [_I],
    # desc_a, N, desc_b, M, out, stream
    "hamming_i32": [_P, _I, _P, _I, _P, _P],
    # S, b, G, D, x, stream
    "chol_solve_cluster_f32": [_P, _P, _I, _I, _P, _P],
    # -> the cluster route's blocks per cluster
    "chol_cluster_size": [],
    # -> the largest D of the cluster route on the current device
    "chol_cluster_max_d": [],
    # G, D -> floats of the large-D route's work buffer
    "chol_grid_work_floats": [_I, _I],
    # D -> blocks of the large-D route's cooperative grid (0: not resident)
    "chol_grid_blocks": [_I],
    # S, b, G, D, work, x, stream
    "chol_solve_grid_f32": [_P, _P, _I, _I, _P, _P, _P],
    # S, b, G, D, work, x, clocks (5 int64 on the device), stream
    "chol_solve_grid_clocks_f32": [_P, _P, _I, _I, _P, _P, _P, _P],
    # n grid barriers in an empty kernel, stream
    "chol_grid_sync_probe": [_I, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def build() -> Path:
    """Compile csrc/*.cu into LIB when missing or older than a source."""
    srcs = sorted(CSRC.glob("*.cu"))
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    if (LIB.exists()
            and LIB.stat().st_mtime >= max(p.stat().st_mtime for p in deps)):
        return LIB
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    builds["builds"] += 1
    builds["nvcc_calls"] += len(srcs) + 1  # one a source, then the link
    tag = os.getpid()
    objs = [BUILD / f"{src.stem}.{tag}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    tmp = LIB.with_suffix(f".{tag}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    BUILD_LOG.write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB)
    return LIB


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on the cudaError_t a launch function returned."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
