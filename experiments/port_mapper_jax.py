"""chip_smoke.py's mapper search and window BA through the JAX package, on
the CPU.

Runs the same rendered EuRoC-size keyframes, triangulation, fuse and
scoring as `chip_smoke.mapper_search`, but extracts and searches with
`monoorbslam3_tpu` (OrbExtractor, features_from_extractor,
_triangulate_pair_kernel, _fuse_project_kernel); then runs `schur_ba` on
`bench.build_problem(seed=0)` in each of chip_smoke's BA_VARIANTS. Its
numbers set the bounds that chip_smoke.py holds the port to (PERF.md
records the run).

    python experiments/port_mapper_jax.py

Prints the mapper record and one line per BA variant.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import jax.numpy as jnp
import numpy as np

import bench
import chip_smoke as cs
from monoorbslam3_tpu.backend.solver import schur_ba
from monoorbslam3_tpu.frontend.frame import features_from_extractor
from monoorbslam3_tpu.frontend.local_mapping import (_fuse_project_kernel,
                                                     _triangulate_pair_kernel)
from monoorbslam3_tpu.models.camera import Pinhole
from monoorbslam3_tpu.ops.orb import OrbExtractor


class JaxMapperPipe:
    """chip_smoke's mapper-search pipe interface over the JAX package."""

    def __init__(self):
        self.cam = Pinhole.create(**cs.EUROC_CAM)
        self.ext = OrbExtractor(cs.EUROC_CAM["height"], cs.EUROC_CAM["width"],
                                n_features=cs.N_FEAT, n_levels=cs.N_LEVELS, scale=cs.SCALE)
        self.kfs = []
        self.mapper_times = {}

    def keyframe(self, img):
        f = features_from_extractor(self.ext(img), self.cam, self.ext.scale_factors)
        f = {k: np.asarray(v) for k, v in f.items()}
        self.kfs.append(f)
        return {k: f[k] for k in ("xy_raw", "valid")}

    def triangulate(self, i, j, pose_i, pose_j):
        a, b = self.kfs[i], self.kfs[j]
        idx, X, accept = _triangulate_pair_kernel(
            a["xy"], a["desc"], a["valid"], a["sigma2"],
            b["xy"], b["desc"], b["valid"], b["sigma2"], self.cam,
            *map(jnp.asarray, (*pose_i, *pose_j)))
        return dict(idx=np.asarray(idx), X=np.asarray(X), accept=np.asarray(accept))

    def fuse(self, i, pts, src, j, pose_j):
        a, b = self.kfs[i], self.kfs[j]
        valid = src >= 0
        desc = np.where(valid[:, None], a["desc"][np.maximum(src, 0)], 0).astype(np.uint32)
        idx = _fuse_project_kernel(pts, desc, valid, b["xy"], b["desc"], b["valid"],
                                   b["sigma2"], self.cam, *map(jnp.asarray, pose_j),
                                   cs.FUSE_RADIUS)
        return np.asarray(idx)


def main():
    cs.mapper_search(JaxMapperPipe())
    problem, cam = bench.build_problem(seed=0)
    for name, kw in cs.BA_VARIANTS.items():
        _, pts, info = schur_ba(problem, cam, jnp.eye(3), jnp.zeros(3),
                                n_iters=cs.BA_ITERS, **kw)
        print(json.dumps(dict(variant=name, cost0=float(info["cost0"]),
                              cost=float(info["cost"]),
                              finite=bool(np.isfinite(np.asarray(pts)).all()))))


if __name__ == "__main__":
    main()
