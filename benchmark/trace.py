"""The traced part of a `--trace 1` run: `torch.profiler` over the last
seconds of the measured window, reduced to what the per-layer metrics and
the result's `breakdown` read.

- device busy: the union of the intervals in which a kernel, a copy or a
  fill ran on the card, against the traced window's length;
- kernel device time by name (its first NAME_CHARS characters);
- host launch calls: the runtime's and the driver's kernel, cooperative
  and graph launches, counted on the host;
- the longest idle gaps of the card, each named by the innermost of the
  benchmark's own spans (`extract`, `track`, `mapper`, `solve`, recorded
  with `record_function` around the calls into each layer) open at the
  gap's middle, or `host` where none was.
"""

from __future__ import annotations

import re
import time

import torch

SPANS = ("extract", "track", "mapper", "solve")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|LaunchKernelEx|"
                    r"LaunchKernelExC|GraphLaunch)(_v\d+)?$")
TOP = 10
NAME_CHARS = 160  # a kernel's name in the breakdown: its first characters


class Tracer:
    """Starts and stops the profiler; `summary()` reduces its events."""

    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = None

    @staticmethod
    def warm():
        """Profile one tiny op, so that the profiler's own set-up (CUPTI
        and its buffers) is paid in set-up, not inside the window."""
        x = torch.ones(8, device="cuda")
        with torch.profiler.profile(activities=_activities()):
            (x + 1).sum().item()

    def start(self):
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self):
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        busy, kernels, spans, launches = [], {}, [], 0
        for e in events:
            kind, name = _kind(e), e.name()
            if kind in DEVICE_ACTIVITIES:
                s, d = _start_ns(e), _duration_ns(e)
                busy.append((s, s + d))
                if kind == "kernel":
                    key = name[:NAME_CHARS]
                    kernels[key] = kernels.get(key, 0.0) + 1e-9 * d
            elif kind in ("cuda_runtime", "cuda_driver"):
                launches += bool(LAUNCH.match(name))
            elif kind == "user_annotation" and name in SPANS:
                s = _start_ns(e)
                spans.append((s, s + _duration_ns(e), name))
        w0, w1 = self.t0_ns, self.t1_ns
        merged = _merge(sorted((max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1))
        busy_ns = sum(b - a for a, b in merged)
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = sorted(((b - a, (a + b) // 2) for a, b in zip(edges[0::2], edges[1::2])
                       if b > a), reverse=True)[:TOP]
        return {
            "busy_s": 1e-9 * busy_ns,
            "window_s": 1e-9 * (w1 - w0),
            "launches": launches,
            "kernels": kernels,
            "device_ops": [[n, s] for n, s in sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[_label(spans, mid), 1e-9 * ns] for ns, mid in gaps],
        }


def _kind(e) -> str:
    """The event's activity type; where the event does not say (older
    torch), worked out from its device and its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if name in SPANS:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name in SPANS:
        return "user_annotation"
    if name.startswith("cuda") or name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()


def _duration_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else 1000 * e.duration_us()


def _activities():
    return [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def _merge(intervals):
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(spans, t):
    """The innermost (shortest) benchmark span open at time t."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "host"
