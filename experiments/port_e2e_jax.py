"""The end-to-end run's circle10 world through the JAX package, on the CPU.

Runs `experiments/tpu_e2e.run_world("circle10", sync=True)` (the JAX
package's `config.build_system(settings/synthetic.yaml)`, `warmup`,
`runners.synth.SyntheticDataset` of "circle:t_end=10,fps=20", 200 frames
through `System.track` with the synchronous mapper, the keyframe
trajectory scored by `evaluation.metrics.evaluate_sequences`), as
`monoorbslam3_tpu_torch.measure.e2e.run_world` runs the same world through
the port, and prints the row's outcome fields: OK frames and their ratio,
LOST events, keyframes, keyframe ATE and scale error. The row's times are
this CPU's and are not printed.

`--seeds` runs the world once a seed of the tracker's RANSAC draws (the
`seed` knob of both packages' `Tracking`, set through `build_system`'s
`config_overrides`; patched in this process, no file changes); `--port`
runs the port on the CPU instead (`measure.e2e.run_world(device="cpu")`),
for the same table. Seed 0 is the default of both packages. These runs are
the sources of chip_smoke's JAX_E2E_CIRCLE10 bounds (seed 0's outcome, and
the largest ATE over seeds 0-3).

    python experiments/port_e2e_jax.py [--seeds 0,1,2,3] [--port] [--out-dir DIR]

About 4 minutes a JAX run on a CPU, 6 a port run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

KEYS = ("frames", "ok_frames", "lost_events", "n_keyframes", "ate_rmse", "scale_err")


def _with_seed(module, seed):
    """Patch `module.build_system` to pass the tracker's RANSAC seed."""
    inner = module.build_system

    def build_system(*a, **k):
        return inner(*a, config_overrides={"seed": seed}, **k)

    module.build_system = build_system
    return lambda: setattr(module, "build_system", inner)


def run(seed, out_dir, port=False):
    if port:
        import torch

        from monoorbslam3_tpu_torch.measure import e2e

        torch.set_num_threads(4)
        restore = _with_seed(e2e, seed)
        try:
            row = e2e.run_world("circle10", out_dir, sync=True, device="cpu",
                                log=lambda line: None)
        finally:
            restore()
    else:
        import monoorbslam3_tpu.config as jconfig
        from experiments import tpu_e2e

        restore = _with_seed(jconfig, seed)
        try:
            row = tpu_e2e.run_world("circle10", out_dir, sync=True)
        finally:
            restore()
    out = {k: row[k] for k in KEYS}
    out["ok_ratio"] = row["ok_frames"] / row["frames"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU instead")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="port_e2e_jax_")
    os.makedirs(out_dir, exist_ok=True)
    rows = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        rows[seed] = run(seed, out_dir, port=args.port)
        print(f"seed {seed}:", json.dumps(rows[seed]), flush=True)
    name = "PORT_CPU_E2E_CIRCLE10" if args.port else "JAX_E2E_CIRCLE10"
    print(f"{name} =", json.dumps(rows))


if __name__ == "__main__":
    main()
