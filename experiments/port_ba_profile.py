"""Where the time of the port's window BA goes, on one CUDA card.

Builds `bench_window.build_problem(seed=0)` on the card, warms up, and runs
one `schur_ba` solve per variant of chip_smoke's BA_VARIANTS under
`torch.profiler`. Prints, per variant: wall time of the profiled solve,
kernel launches (`cudaLaunchKernel` calls), device busy time (sum of the
kernels' device time; one stream, so they do not overlap) and idle share,
the kernels that take the most device time, and the host ops that take the
most host time. The profiler's own cost inflates the wall time; chip_smoke
times the solves without it.

    python experiments/port_ba_profile.py [--variant flat_deferred]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from monoorbslam3_tpu_torch.backend.solver import schur_ba
from monoorbslam3_tpu_torch.bench_window import build_problem


def _dev_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=list(cs.BA_VARIANTS), action="append")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_ba_profile: needs a CUDA device")
    dev = torch.device("cuda:0")
    problem, cam = build_problem(seed=0, device=dev)
    R_cb, t_cb = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    print(torch.cuda.get_device_name(0))
    for name in args.variant or list(cs.BA_VARIANTS):
        kw = cs.BA_VARIANTS[name]
        for _ in range(2):
            schur_ba(problem, cam, R_cb, t_cb, n_iters=cs.BA_ITERS, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, pts, info = schur_ba(problem, cam, R_cb, t_cb, n_iters=cs.BA_ITERS, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
        busy_us = sum(_dev_us(e) for e in ka if e.key != "cudaLaunchKernel")
        print(f"== {name}: profiled wall {1e3 * wall:.3f} ms, {launches} kernel launches "
              f"({launches / cs.BA_ITERS:.0f} per iteration), device busy "
              f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}")
        kern = sorted((e for e in ka if _dev_us(e) > 0), key=_dev_us, reverse=True)
        for e in kern[: args.top]:
            print(f"   device {_dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
        host = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in host[: args.top]:
            print(f"   host   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
