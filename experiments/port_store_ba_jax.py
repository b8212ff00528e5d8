"""chip_smoke.py's store BA path through the JAX package, on the CPU.

Builds the same seeded stores with the JAX package's `MapStore` and
`ImuBuffer` (`chip_smoke.seeded_store`: bit-identical to the port's) and
runs the same `Problems` calls (`chip_smoke.init_phase`,
`chip_smoke.store_calls`) through `monoorbslam3_tpu.backend.problems`,
each call on a copy of the 96-keyframe store. Prints, per call, cost0,
cost, outliers removed, points solved, the JAX package's fetches
(`utils.fetch.sync_count`), the ATE before and after and the seconds
(compiles included): the sources of the JAX_STORE_* bounds of
chip_smoke.py (PERF.md records the run). About 2 minutes on one CPU.

    python experiments/port_store_ba_jax.py
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import chip_smoke as cs
from monoorbslam3_tpu import config
from monoorbslam3_tpu.backend.problems import Problems
from monoorbslam3_tpu.models.imu import ImuBuffer, ImuCalib
from monoorbslam3_tpu.models.map_state import MapStore
from monoorbslam3_tpu.utils.fetch import sync_count


def main():
    cam = config.build_camera(config.load_settings(str(cs.SETTINGS / cs.EUROC_PROFILE)))
    pr = Problems(cam, cs.store_calibration(ImuCalib))
    t0 = time.perf_counter()
    init = cs.init_phase(pr, MapStore, ImuBuffer)
    print(json.dumps({"call": "inertial_optimize", "seconds": time.perf_counter() - t0} | init),
          flush=True)
    base, truth = cs.seeded_store(MapStore, ImuBuffer)
    for name, fn in cs.store_calls(base):
        st = copy.deepcopy(base)
        ate0 = cs.store_ate(st, truth)
        n0, t0 = sync_count(), time.perf_counter()
        out = fn(pr, st)
        print(json.dumps(dict(call=name, cost0=out["cost0"], cost=out["cost"],
                              n_outliers=out["n_outliers"], n_points=out["n_points"],
                              n_kf=len(out["ids"]), n_ie=out["n_ie"], fetches=sync_count() - n0,
                              ate_before_m=ate0, ate_after_m=cs.store_ate(st, truth),
                              seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
