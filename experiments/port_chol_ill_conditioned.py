"""K4's reduced systems on the forward profile, on the CPU: how ill
conditioned the capped polish past full_k makes them.

Runs the port's corridor60 world (`runners.validation.run_world`,
settings/synthetic_forward.yaml) on the CPU for the first 36 s, so that
the keyframe count passes full_k = 96 and the hybrid polish takes its
stride subsample capped at local_k (D = 15 local_k = 600, K4's cluster
route). Every reduced system of D = 600 that `backend/solver` hands to
`ops/chol_pallas.chol_solve` is kept with where it was solved: a window
BA ("local"), a full polish up to full_k ("polish"), or the capped polish
past it ("capped polish"). For each class it prints the count, the range
of condition numbers, and the forward error (against float64) and
normwise backward error (`chip_smoke.k4_backward`) of the plain version
(the library's Cholesky and one refinement step) and of the numpy
emulation of the kernel's cluster schedule
(experiments/port_chol_cluster_emulate.py, float32, the kernel's order)
on the same systems, and the ratio of the two forward errors. These are
the source of chip_smoke's K4_FWD_COND.

    python experiments/port_chol_ill_conditioned.py [--t-end 36]

About 15 minutes on a CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

import numpy as np
import torch

import chip_smoke as cs
from monoorbslam3_tpu_torch.backend import solver
from monoorbslam3_tpu_torch.runners import validation
from port_chol_cluster_emulate import CLUSTER, cluster_solve


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=36.0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    where = ["local"]
    kept = collections.defaultdict(list)
    inner = solver.chol_solve

    def chol_solve(S, b):
        if S.shape[-1] == 600:
            kept[where[0]].append((S.clone(), b.clone()))
        return inner(S, b)

    solver.chol_solve = chol_solve

    def instrument(syst):
        polish = syst.problems.full_inertial_optimize

        def tagged(store, *a, **k):
            past = store.n_keyframes() > syst.problems.full_k
            where[0] = "capped polish" if past else "polish"
            try:
                return polish(store, *a, **k)
            finally:
                where[0] = "local"

        syst.problems.full_inertial_optimize = tagged

    settings, spec, _, _ = validation.WORLDS["corridor60"]
    spec = spec.replace("t_end=60", f"t_end={args.t_end:g}")
    info = validation.run_world("corridor60", settings, spec, tempfile.mkdtemp(), device="cpu",
                                instrument=instrument)
    print(json.dumps({"frames": info["frames"], "n_keyframes": info["n_keyframes"],
                      "polishes": info["polishes"]}), flush=True)
    rel = lambda x, x64: float(np.linalg.norm(x - x64) / np.linalg.norm(x64))
    for name, items in kept.items():
        # every capped polish's system, a sample of the others
        step = 1 if name == "capped polish" else max(1, len(items) // 40)
        rows = []
        for S, b in items[::step]:
            x64 = torch.linalg.solve(S.double(), b.double())
            xp = inner(S, b)
            xe = torch.as_tensor(cluster_solve(S[0].numpy(), b[0].numpy(), CLUSTER)[0])[None]
            rows.append(dict(cond=float(torch.linalg.cond(S.double()).max()),
                             plain=rel(xp.double().numpy(), x64.numpy()),
                             kernel=rel(xe.double().numpy(), x64.numpy()),
                             plain_bw=float(cs.k4_backward(xp, S, b).max()),
                             kernel_bw=float(cs.k4_backward(xe, S, b).max())))
        col = lambda k: np.asarray([r[k] for r in rows])
        past = col("cond") > cs.K4_FWD_COND
        ratio = col("kernel") / col("plain")
        print(json.dumps({
            "solved in": name, "systems": len(items), "examined": len(rows),
            "cond": [float(col("cond").min()), float(col("cond").max())],
            "past K4_FWD_COND": int(past.sum()),
            "forward error, plain (max)": float(col("plain").max()),
            "forward error, kernel's emulation (max)": float(col("kernel").max()),
            "forward ratio kernel / plain, cond <= K4_FWD_COND": (
                [float(ratio[~past].min()), float(ratio[~past].max())] if (~past).any() else None),
            "forward ratio kernel / plain, cond > K4_FWD_COND": (
                [float(ratio[past].min()), float(ratio[past].max())] if past.any() else None),
            "backward ratio kernel / plain": [float((col("kernel_bw") / col("plain_bw")).min()),
                                              float((col("kernel_bw") / col("plain_bw")).max())],
            "backward error, plain (max)": float(col("plain_bw").max())}), flush=True)


if __name__ == "__main__":
    main()
