"""Where the device time of the port's tracking step goes, on one CUDA card.

Runs chip_smoke's tracking drive (rendered EuRoC-size frames, the coarse
and the local stage) twice: once without the profiler, for the host frame
time (p50 over the frames after the first two), then again with the
frames after the first two under `torch.profiler` (it starts once frame 2
has been logged, so the seed frame and the first launches stay outside). Prints, per tracked
frame in the window: kernel launches, device busy time (sum of the device
rows' time, kernels and copies; one stream, so they do not overlap), the idle share
of the host frame time, K1's and K2's device time, and the kernels that
take the most device time.

    python experiments/port_track_profile.py [--frames 10]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

WARM_FRAMES = 2  # tracked frames before the profiled window


def _dev_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def device_rows(ka):
    """The rows of `key_averages()` that ran on the device (kernels and
    copies). A host op's row also carries the device time of the kernels
    it launched, so summing every row counts each kernel twice."""
    return [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=10, help="frames of the drive, seed included")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_track_profile: needs a CUDA device")
    print(torch.cuda.get_device_name(0))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = []

    def log(line):
        rec = json.loads(line)
        if rec["frame"] == WARM_FRAMES:
            torch.cuda.synchronize()
            prof.start()
        elif rec["frame"] > WARM_FRAMES:
            window.append(rec)

    pipe = cs.TorchPipe("cuda")
    plain = cs.drive(pipe, n_frames=args.frames, log=lambda line: None)[WARM_FRAMES:]
    print(f"unprofiled drive: host frame ms p50 {cs._pct([r['host_frame_ms'] for r in plain], 50):.3f} "
          f"over {len(plain)} frames")
    cs.drive(pipe, n_frames=args.frames, log=log)
    torch.cuda.synchronize()
    prof.stop()
    n = len(window)
    frame_ms = sum(r["host_frame_ms"] for r in window)
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunchKernel"))
    kern = sorted(device_rows(ka), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in kern) / 1e3
    by_name = lambda s: sum(_dev_us(e) for e in kern if s in e.key) / 1e3
    print(f"{n} tracked frames profiled: {launches / n:.0f} launches a frame; device busy "
          f"{busy_ms / n:.3f} ms a frame against {frame_ms / n:.3f} ms of host frame time "
          f"(idle share {1 - busy_ms / frame_ms:.3f}); K1 {by_name('gather_patches') / n:.4f} ms "
          f"and K2 {by_name('match_rows') / n:.4f} ms a frame")
    every_row = sum(_dev_us(e) for e in ka if not e.key.startswith("cuda")) / 1e3
    print(f"   (summed over every row, the host ops' rows too, which count their kernels "
          f"twice: {every_row / n:.3f} ms a frame)")
    for e in kern[: args.top]:
        print(f"   device {_dev_us(e) / 1e3 / n:9.4f} ms a frame  x{e.count / n:6.1f}  {e.key[:90]}")


if __name__ == "__main__":
    main()
