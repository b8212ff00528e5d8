"""Where the time of the port's window BA goes, on one CUDA card.

Builds `bench_window.build_problem(seed=0)` on the card (the bench window,
or with `--window polish` chip_smoke's POLISH_WINDOW), warms up, and runs
one `schur_ba` solve per variant of chip_smoke's BA_VARIANTS (or
POLISH_VARIANTS) under `torch.profiler`. With `--ab DIR` each variant is
profiled a second time with its reduced solves going through the
one-block large-D kernel of `DIR/chol_solve.cu` (a build from before the
grid route), so K4's share stands beside the parent's. Prints, per variant: wall time of the profiled solve,
kernel launches (`cudaLaunchKernel` calls), device busy time (sum of the
device rows' time, `port_track_profile.device_rows`; one stream, so they
do not overlap) and idle share,
the kernels that take the most device time, and the host ops that take the
most host time. The profiler's own cost inflates the wall time; chip_smoke
times the solves without it.

    python experiments/port_ba_profile.py [--variant flat_deferred]
    python experiments/port_ba_profile.py --window polish [--ab DIR]
    python experiments/port_ba_profile.py --window store

`--window store` profiles chip_smoke's store BA calls instead (each
`Problems` method of `chip_smoke.store_calls` on a copy of the seeded
96-keyframe store, after one warm-up call: host assembly, edges, upload,
solve, fetch and write-back), then the façade's `_batch_edges` at E = 31
and E = 95 edges (one batched tree each: the launches should not grow
with E). `--window store --cpu-ops` needs no card: it counts the
non-view aten operations of the same calls on the CPU
(`port_track_profile.count_ops`), a proxy for their launches.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from experiments.port_track_profile import _dev_us, count_ops, device_rows
from monoorbslam3_tpu_torch.backend.solver import schur_ba
from monoorbslam3_tpu_torch.bench_window import build_problem


def report(label, prof, wall, iters, top):
    """Print the launches, device busy time, idle share and top rows of
    one profiled run of `wall` seconds."""
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunch"))
    kern = sorted(device_rows(ka), key=_dev_us, reverse=True)
    busy_us = sum(_dev_us(e) for e in kern)
    k4_us = sum(_dev_us(e) for e in kern if "chol_" in e.key)
    every_row = sum(_dev_us(e) for e in ka if not e.key.startswith("cudaLaunch"))
    print(f"== {label}: profiled wall {1e3 * wall:.3f} ms, {launches} kernel "
          f"launches ({launches / iters:.0f} per iteration), device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}, K4 "
          f"{k4_us / 1e3:.3f} ms ({k4_us / max(busy_us, 1e-9):.1%} of busy) (summed over every "
          f"row, host ops' rows too: {every_row / 1e3:.3f} ms)")
    for e in kern[:top]:
        print(f"   device {_dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    host = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:top]:
        print(f"   host   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    return launches


def profiled(fn):
    """(profiler, wall seconds) of one fn() ending in a synchronize."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def store_profile(dev, top, cpu_ops=False):
    """Profile (or, with `cpu_ops`, count the CPU operations of) every store
    BA call and `_batch_edges` at E = 31 and 95."""
    import copy

    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.backend.problems import Problems
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer, ImuCalib
    from monoorbslam3_tpu_torch.models.map_state import MapStore

    cam = config.build_camera(config.load_settings(cs.SETTINGS / cs.EUROC_PROFILE), device=dev)
    pr = Problems(cam, cs.store_calibration(ImuCalib, device=dev), device=dev)
    pr.warm_solvers()
    base, _ = cs.seeded_store(MapStore, ImuBuffer)
    if cpu_ops:
        ids = base.keyframe_ids()
        for name, fn in cs.store_calls(base):
            st = copy.deepcopy(base)
            print(f"store {name}: {count_ops(lambda: fn(pr, st))} aten operations on the CPU")
        for E in (31, 95):
            print(f"_batch_edges E={E}: {count_ops(lambda: pr._batch_edges(base, ids[:E + 1]))} "
                  "aten operations on the CPU")
        return
    for name, fn in cs.store_calls(base):
        fn(pr, copy.deepcopy(base))
        torch.cuda.synchronize()
        st = copy.deepcopy(base)
        prof, wall = profiled(lambda: fn(pr, st))
        report(f"store {name}", prof, wall, cs.STORE_ITERS[name], top)
    ids = base.keyframe_ids()
    counts = {}
    for E in (31, 95):
        pr._batch_edges(base, ids[:E + 1])
        prof, wall = profiled(lambda: pr._batch_edges(base, ids[:E + 1]))
        counts[E] = report(f"_batch_edges E={E}", prof, wall, 1, 4)
    print(f"_batch_edges launches: E=31 {counts[31]}, E=95 {counts[95]} "
          f"({counts[95] / counts[31] - 1:+.1%})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--window", choices=["bench", "polish", "store"], default="bench")
    ap.add_argument("--variant", action="append")
    ap.add_argument("--ab", metavar="DIR", default=None)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--cpu-ops", action="store_true",
                    help="with --window store: count CPU operations, no card needed")
    args = ap.parse_args()
    if args.cpu_ops:
        return store_profile(torch.device("cpu"), args.top, cpu_ops=True)
    if not torch.cuda.is_available():
        sys.exit("port_ba_profile: needs a CUDA device")
    dev = torch.device("cuda:0")
    if args.window == "store":
        print(torch.cuda.get_device_name(0))
        store_profile(dev, args.top)
        return
    polish = args.window == "polish"
    variants = cs.POLISH_VARIANTS if polish else cs.BA_VARIANTS
    iters = cs.POLISH_ITERS if polish else cs.BA_ITERS
    problem, cam = build_problem(seed=0, device=dev, **(cs.POLISH_WINDOW if polish else {}))
    R_cb, t_cb = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    print(torch.cuda.get_device_name(0))
    other = cs._ab_build(args.ab, "chol_solve.cu")
    builds = [("package", contextlib.nullcontext())]
    if other is not None and cs.one_block_solver(other) is not None:
        builds.append(("A/B build, one-block K4", cs._SolverChol(cs.one_block_solver(other))))
    for name in args.variant or list(variants):
        kw = variants[name]
        for build, patch in builds:
            with patch:
                for _ in range(2):
                    schur_ba(problem, cam, R_cb, t_cb, n_iters=iters, **kw)
                torch.cuda.synchronize()
                prof, wall = profiled(lambda: schur_ba(problem, cam, R_cb, t_cb, n_iters=iters, **kw))
            report(f"{name} ({build})", prof, wall, iters, args.top)


if __name__ == "__main__":
    main()
