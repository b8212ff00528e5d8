"""chip_smoke.py's polish-window BA through the JAX package, on the CPU.

Builds the full polish's window (`chip_smoke.POLISH_WINDOW`: 96 keyframes,
all free but the anchor, 4096 points, 192 observations a keyframe) with
`bench.build_problem` and runs the JAX package's `schur_ba` on it in each
of chip_smoke's POLISH_VARIANTS (grouped layout, deferred and
parallel-lambda LM, 12 iterations). Its cost0 and converged costs are the
anchors chip_smoke.py holds the port's polish path to (PERF.md records the
run).

    python experiments/port_polish_jax.py [--small]

`--small` runs the window of the CPU parity test instead (12 keyframes,
256 points, 48 observations a keyframe). Prints one line per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import jax.numpy as jnp
import numpy as np

import bench
import chip_smoke as cs
from monoorbslam3_tpu.backend.solver import schur_ba

SMALL_WINDOW = dict(n_kf=12, n_fixed=1, n_pts=256, obs_per_kf=48)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    window = SMALL_WINDOW if ap.parse_args().small else cs.POLISH_WINDOW
    problem, cam = bench.build_problem(seed=0, **window)
    for name, kw in cs.POLISH_VARIANTS.items():
        t0 = time.perf_counter()
        kw = dict(kw, grouped_obs=window["obs_per_kf"])
        _, pts, info = schur_ba(problem, cam, jnp.eye(3), jnp.zeros(3),
                                n_iters=cs.POLISH_ITERS, **kw)
        print(json.dumps(dict(window=window, variant=name, cost0=float(info["cost0"]),
                              cost=float(info["cost"]),
                              cost_hist=[float(c) for c in np.asarray(info["cost_hist"])],
                              finite=bool(np.isfinite(np.asarray(pts)).all()),
                              seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
