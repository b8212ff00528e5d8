"""Scaling of the batch extractor and the sharded BA over process groups
(counterpart of the repository's `bench_scaling.py`).

The JAX script measures one sharded program on a virtual CPU mesh of N
single-threaded devices. A torch mesh is N processes, one a rank
(`parallel.multihost.run_ranks`): with `--device cpu` they are gloo ranks
at one thread each, the JAX script's measurement; by default NCCL ranks,
one a card. NCCL takes one card a rank, so on a host with one card only
N = 1 exists: a larger N is reported as not measured, with the reason,
and no scaling figure is made up.

For each N it times:
- `sharded_ba_iters_per_s`: `parallel.sharded_ba.sharded_schur_ba`, 6
  iterations, on a large window (32 keyframes, 16,384 points, 24,576
  observations, `bench_window.build_problem`), split by point over the
  ranks;
- `frontend_dp_fps`: `parallel.frontend_dp.make_batch_extractor` over 4
  frames a rank (512x384, 768 features);
and the efficiency against N = 1, then a summary at the first N > 1.
Each time is a rank's wall clock over the whole call (ending in a
synchronize on the card), the slowest rank's; the median and quartiles of
`--reps` runs after one warm-up, and the rate at the median.

`--profile` separates where the time of N ranks goes, as the JAX
script's profile does: besides the mesh run, `shard1` (the 1/N-size
program of one rank, alone), `replicaN` (N processes each running that
program in a one-rank group of its own, side by side: host contention
without collectives) and `cpu_util` (the ranks' CPU seconds over the mesh
run's wall time and the host's cores).

    python -m monoorbslam3_tpu_torch.measure.bench_scaling [N ...] [--profile]
    python -m monoorbslam3_tpu_torch.measure.bench_scaling 1 2 4 --device cpu

Without a card and without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..bench_window import build_problem
from ..ops.orb import OrbExtractor
from ..parallel import frontend_dp, multihost
from ..parallel.sharded_ba import shard_problem_by_point, sharded_schur_ba
from ..utils.device import CARD, resolve
from .timing import device_identity

BA_WINDOW = dict(n_kf=32, n_fixed=8, n_pts=16384, obs_per_kf=768)
BA_ITERS = 6
FRONTEND = dict(frames_per_rank=4, h=384, w=512, n_features=768)
REPS = 5


def _cpu_seconds() -> float:
    with open("/proc/self/stat") as f:
        parts = f.read().split()
    return (int(parts[13]) + int(parts[14])) / os.sysconf("SC_CLK_TCK")


def _program(kind, ranks_of_work, device_type, ba_window, frontend):
    """(run, work) of one rank: the sharded BA on the window, or the batch
    extractor over frames_per_rank frames a rank, for a group of
    `ranks_of_work` ranks' worth of work split over the current group.
    `work` is iterations or frames a run."""
    dev = torch.device(device_type, torch.cuda.current_device() if device_type == "cuda" else None)
    mesh = multihost.global_mesh(("dp",), device_type=device_type)
    n = dist.get_world_size()
    sync = torch.cuda.synchronize if device_type == "cuda" else (lambda: None)
    if kind == "ba":
        win = dict(ba_window)
        win["n_pts"] //= ranks_of_work // n
        win["obs_per_kf"] //= ranks_of_work // n
        problem, cam = build_problem(seed=0, device=dev, **win)
        sharded, dropped = shard_problem_by_point(problem, n)
        R_cb, t_cb = torch.eye(3, device=dev), torch.zeros(3, device=dev)

        def run():
            kf, pts, info = sharded_schur_ba(sharded, cam, R_cb, t_cb, mesh, n_iters=BA_ITERS)
            sync()
            return info

        return run, BA_ITERS
    fr = frontend
    ext = OrbExtractor(fr["h"], fr["w"], n_features=fr["n_features"], device=dev)
    extract = frontend_dp.make_batch_extractor(ext, mesh)
    B = n * fr["frames_per_rank"]
    images = np.random.default_rng(0).uniform(0, 255, (B, fr["h"], fr["w"])).astype(np.float32)

    def run():
        out = extract(images)
        sync()
        return out

    return run, B


def _rank(kind, ranks_of_work, device_type, ba_window, frontend, reps, ready_dir=None):
    """One rank's timing: a warm-up run (a BA run must lower the cost), then
    `reps` timed runs, each started together on every rank (a barrier;
    replicas, which share no group, wait instead until every replica has
    written its file into `ready_dir`). Returns the rank's run times, its
    CPU seconds over them and its wall time over them."""
    run, work = _program(kind, ranks_of_work, device_type, ba_window, frontend)
    out = run()
    if kind == "ba" and not float(out["cost"]) < float(out["cost0"]):
        raise RuntimeError("bench_scaling: the sharded BA did not lower the cost")
    if ready_dir is not None:
        Path(ready_dir, f"{os.getpid()}").touch()
        deadline = time.monotonic() + 600.0
        while len(os.listdir(ready_dir)) < ranks_of_work:
            if time.monotonic() > deadline:
                raise RuntimeError("bench_scaling: the other replicas never became ready")
            time.sleep(0.005)
    times = []
    c0, w0 = _cpu_seconds(), time.perf_counter()
    for _ in range(reps):
        if ready_dir is None:
            dist.barrier()
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return dict(times=times, work=work, cpu_s=_cpu_seconds() - c0,
                wall_s=time.perf_counter() - w0)


def _summary(results):
    """The slowest rank's run times: median, quartiles, n."""
    t = np.max(np.asarray([r["times"] for r in results]), axis=0)
    q25, q50, q75 = np.percentile(t, [25, 50, 75])
    return dict(median_s=float(q50), q25_s=float(q25), q75_s=float(q75), n=len(t))


def measure(kind, n, device_type, ba_window=BA_WINDOW, frontend=FRONTEND, reps=REPS,
            profile=False):
    """One (kind, N) row: the mesh run over N ranks; with `profile` also
    shard1, replicaN and cpu_util."""
    res = multihost.run_ranks(_rank, n, device_type,
                              args=(kind, n, device_type, ba_window, frontend, reps))
    mesh = _summary(res)
    work = res[0]["work"]
    row = dict(kind=kind, n_devices=n, rate=work / mesh["median_s"],
               unit="iters/s" if kind == "ba" else "frames/s", mesh=mesh)
    if not profile:
        return row
    cpu = sum(r["cpu_s"] for r in res) / max(r["wall_s"] for r in res) / (os.cpu_count() or 1)
    shard1 = _summary(multihost.run_ranks(_rank, 1, device_type,
                                          args=(kind, n, device_type, ba_window, frontend, reps)))
    if n == 1:
        replica = shard1
    else:
        with tempfile.TemporaryDirectory(prefix="replicas_") as ready:
            replica = _summary(multihost.run_ranks(
                _rank, n, device_type, independent=True,
                args=(kind, n, device_type, ba_window, frontend, reps, ready)))
    row.update(shard1=shard1, replica=replica,
               host_contention_s=replica["median_s"] - shard1["median_s"],
               collective_s=mesh["median_s"] - replica["median_s"], cpu_util_during_mesh=cpu)
    return row


def scaling(sizes, device=CARD, profile=False, ba_window=BA_WINDOW, frontend=FRONTEND,
            reps=REPS, log=print) -> list:
    """Every line of the script for the group sizes `sizes` on `device`'s
    type; returns them. A size above the host's cards is not measured."""
    dev = resolve(device)
    ident = device_identity(dev)
    if dev.type == "cpu":
        ident["note"] = ("gloo ranks at one thread each: host rates of a CPU mesh, the JAX "
                         "script's own measurement")
    have = torch.cuda.device_count() if dev.type == "cuda" else os.cpu_count() or 1
    lines, base = [], {}
    for kind, metric in (("ba", "sharded_ba_iters_per_s"), ("frontend", "frontend_dp_fps")):
        for n in sizes:
            line = dict(metric=metric, n_devices=n, device=ident)
            if dev.type == "cuda" and n > have:
                line.update(value="not measured", note=(
                    f"{n} ranks need {n} cards (NCCL takes one card a rank); this host has "
                    f"{have}"))
            else:
                row = measure(kind, n, dev.type, ba_window, frontend, reps, profile)
                base.setdefault(kind, row["rate"] / n)
                line.update(value=row["rate"], efficiency=row["rate"] / (n * base[kind]), **row)
            lines.append(line)
            log(line)
    measured = [ln for ln in lines if ln["metric"] == "frontend_dp_fps"
                and ln["n_devices"] > 1 and ln["value"] != "not measured"]
    summary = dict(metric="frontend_dp_scaling_efficiency", device=ident, unit="fraction")
    if measured:
        eff = measured[0]["efficiency"]
        summary.update(value=eff, n_devices=measured[0]["n_devices"], vs_baseline=eff / 0.75)
    else:
        summary.update(value="not measured", note="no group of more than one rank was measured")
    lines.append(summary)
    log(summary)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, help="group sizes (default: 1 2 4 8 up to "
                    "the host's cards, or its cores with --device cpu)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default=CARD.type, help="cuda (the card, default) or cpu")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    have = torch.cuda.device_count() if dev.type == "cuda" else os.cpu_count() or 1
    sizes = args.sizes or [n for n in (1, 2, 4, 8) if n <= have]
    return scaling(sizes, dev, args.profile, reps=args.reps,
                   log=lambda line: print(json.dumps(line), flush=True))


if __name__ == "__main__":
    main()
