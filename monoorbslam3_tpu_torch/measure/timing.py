"""The card's timing tools, shared by `chip_smoke.py` and the measuring
entry points of `measure/`.

- `time_kernel`: a kernel's device time (CUDA events around calls the host
  enqueued while a `torch.cuda._sleep` kernel held the stream) beside its
  host-inclusive call time.
- `step_time`: a host clock around work that ends in
  `torch.cuda.synchronize()`: the time a caller waits for a step, as the
  median, the quartiles and the sample count.
- `bound` and the `k*_bound` helpers: the least time the card could take for
  a kernel's work, the larger of its bytes over the HBM rate and its
  operations over the peak rate of their type.
- `card_identity`: the card's name, the device count and the
  `nvidia-smi` name and power limit; every measured number is written
  beside it.

Nothing here runs on the CPU: a measurement without a card raises.
"""

from __future__ import annotations

import collections
import functools
import subprocess
import time

import numpy as np
import torch

# kernel times: TIMED_CALLS calls back to back behind a sleep kernel
# (`time_kernel`); SLEEP_HZ is at or above the H100's SM clock, so a hold
# of n cycles lasts at least n / SLEEP_HZ seconds
TIMED_CALLS = 20
SLEEP_HZ = 2.0e9
# published peaks of one H100 SXM, dense (NVIDIA's data sheet), at the full
# power limit of 700 W
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
# K2's float32 work a pair: q = dx*dx + dy*dy (5), q against both r^2 (2),
# the group compare (1), the select of the gated distance (1) and the two
# compares of the running top-2 (2)
K2_GATE_OPS = 11

NOT_MEASURED = "not measured"


def time_kernel(fn, label="", n=TIMED_CALLS, reps=5, warmup=3, held_only=False):
    """(device_ms, call_ms) of one fn() call.

    device_ms: `torch.cuda._sleep` holds the stream while the host enqueues
    n calls back to back between two CUDA events, so the events time the
    device alone, not the wrapper's host time between launches. If the
    first event had already been reached when the host finished enqueuing,
    the hold was too short: it is doubled and the window run again. Median
    over `reps` windows, divided by n. A function that synchronizes inside
    (a library call reading a status back), or whose n calls launch more
    kernels than the launch queue holds (the host then waits for the held
    stream), cannot be held: past a 0.25 s hold its device_ms is the median
    event span of single calls instead, host time inside the call
    included, and a line says so; with `held_only` it is None instead.
    call_ms: host clock over n calls ending in a synchronize, per call:
    what a launch-bound caller pays for one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        calls.append(1e3 * (time.perf_counter() - t0) / n)
    call_ms = float(np.median(calls))
    hold_s = max(2e-3, 3e-3 * call_ms * n)
    dev = []
    while len(dev) < reps:
        torch.cuda._sleep(int(hold_s * SLEEP_HZ))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        covered = not a.query()
        b.synchronize()
        if covered:
            dev.append(a.elapsed_time(b) / n)
        elif hold_s < 0.25:
            hold_s *= 2
        elif held_only:
            return None, call_ms
        else:
            print(f"timing: {label or 'a call'} cannot be held (it synchronizes inside, or its "
                  "launches fill the launch queue); its device time is the event span of one call")
            return span_ms(fn, n), call_ms
    return float(np.median(dev)), call_ms


def span_ms(fn, n):
    """Median CUDA-event span of single fn() calls, each after a sync."""
    spans = []
    for _ in range(n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    return float(np.median(spans))


def step_time(fn, n=1, reps=15):
    """Host milliseconds of n fn() calls ending in `torch.cuda.synchronize()`,
    per call, over `reps` samples (the caller warms up first): the median,
    the quartiles and the sample count. The work's own host reads stay in
    it: this is what a caller waits for a step, not device time."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        samples.append(1e3 * (time.perf_counter() - t0) / n)
    q25, q50, q75 = np.percentile(np.asarray(samples, np.float64), [25, 50, 75])
    return dict(median_ms=float(q50), q25_ms=float(q25), q75_ms=float(q75), n=reps,
                calls_per_sample=n)


@functools.cache
def _smi_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    line = out.strip().splitlines()[0].strip() if out.strip() else ""
    name, _, power = line.partition(",")
    if not name.strip() or not power.strip() or "N/A" in power:
        raise RuntimeError(f"nvidia-smi gave no card name and power limit: {out!r}")
    return line


def card_identity() -> dict:
    """The card every measurement stands beside: `torch.cuda.get_device_name(0)`,
    the device count, and the name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them. Raises
    without a card, or when nvidia-smi is missing or reports no power limit."""
    if not torch.cuda.is_available():
        raise RuntimeError("card_identity: no CUDA card on this host")
    line = _smi_name_power()
    return dict(kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
                nvidia_smi=line, power_limit=line.partition(",")[2].strip())


def device_identity(device) -> dict:
    """`card_identity()` for a CUDA device; for the CPU, a record that says
    no device metric was measured."""
    if torch.device(device).type == "cuda":
        return dict(platform="gpu", **card_identity())
    return dict(platform="cpu", note="a CPU run: every device metric reads 'not measured'")


def bound(n_bytes, ops=()):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and, for each (count, peak) in `ops`, the operations over the
    peak rate of their type (the types run on separate units, so the
    largest of them, not their sum, is a bound)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max((count / peak for count, peak in ops), default=0.0)
    t = max(t_bytes, t_ops)
    return dict(bound_ms=1e3 * t, bound_us=1e6 * t,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(n_bytes), ops=[[float(c), p] for c, p in ops])


def k1_bound(atlas, ys, xs, atlas_in_l2=False):
    """K1 moves the atlas pixels its windows cover (read once; the windows
    of neighbouring keypoints overlap), the corners, and K 48x48 windows
    written. With `atlas_in_l2` the atlas is read from the L2 cache, not
    from HBM, and only the corners and the windows count."""
    ha, wa = atlas.shape
    y0 = ys.long().clamp(0, ha - 48)
    x0 = xs.long().clamp(0, wa - 48)
    r = torch.arange(48, device=atlas.device)
    cover = torch.zeros(ha * wa, dtype=torch.bool, device=atlas.device)
    cover[((y0[:, None] + r) * wa)[:, :, None] + (x0[:, None] + r)[:, None, :]] = True
    K = ys.shape[0]
    read = 0 if atlas_in_l2 else 4 * int(cover.sum())
    return bound(read + 8 * K + 4 * 48 * 48 * K)


def k2_bound(N, M):
    """K2 reads both sides' descriptors and five per-side vectors and
    writes best, second and idx. Operations: the Hamming distances as a
    depth-256 binary product (2 x 256 a pair) at the int8 tensor peak, and
    the gate and running top-2 (K2_GATE_OPS a pair) at the float32 peak."""
    return bound((N + M) * (32 + 5 * 4) + 12 * N,
                 [(2 * 256 * N * M, INT8_OPS_PER_S), (K2_GATE_OPS * N * M, F32_OPS_PER_S)])


def k3_bound(N, M):
    """K3 reads both sides' descriptors and writes the [N, M] int32 block;
    its operations, as a depth-256 binary product, at the int8 peak."""
    return bound((N + M) * 32 + 4 * N * M, [(2 * 256 * N * M, INT8_OPS_PER_S)])


def k4_bound(G, D):
    """K4 reads S and b and writes x; a Cholesky factor (D^3/3 multiply-
    adds), four triangular solves and the residual of the refinement step
    (6 D^2) at the float32 peak."""
    return bound(4 * G * (D * D + 2 * D), [(G * (2 * D ** 3 / 3 + 6 * D * D), F32_OPS_PER_S)])


class Capture:
    """Keeps the arguments of the last `maxlen` calls of `module.name` made
    inside the block (a kernel wrapper), so a kernel phase replays exactly
    the inputs its path gave it."""

    def __init__(self, module, name, maxlen=8):
        self.mod, self.name, self.maxlen = module, name, maxlen

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)
        self.calls, self.n = collections.deque(maxlen=self.maxlen), 0
        self.kwargs = collections.deque(maxlen=self.maxlen)

        def spy(*args, **kwargs):
            self.calls.append(args)
            self.kwargs.append(kwargs)
            self.n += 1
            return self.orig(*args, **kwargs)

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)
