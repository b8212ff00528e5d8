"""Where the device time of the port's tracking step goes, on one CUDA card.

Runs chip_smoke's tracking drive (rendered EuRoC-size frames, the coarse
and the local stage) twice: once without the profiler, for the host frame
time (p50 over the frames after the first two), then again with the
frames after the first two under `torch.profiler` (it starts once frame 2
has been logged, so the seed frame and the first launches stay outside). Prints, per tracked
frame in the window: kernel launches, device busy time (sum of the device
rows' time, kernels and copies; one stream, so they do not overlap), the idle share
of the host frame time, K1's and K2's device time, and the kernels that
take the most device time. With `--inertial` the drive is
`chip_smoke.vi_drive` (the IMU prediction, the 15-dim local LM), and one
call of each inertial piece (`preintegrate_tree` on a keyframe window,
`whiten`, `_predict_deltas`, and the last frame's local pose LM with its
inertial tail and without it) is profiled too: its launches and device
time (these launch too many kernels to be timed behind a sleep).
`--cpu-ops` needs no card: it counts the aten operations (views left out)
of each inertial piece on the CPU, the proxy for its launches that the
inertial path's predictions were made with.

`--track-map` profiles chip_smoke's track-map path instead (the port's
`Tracking` and `LocalMapping` in sync mode over the rendered stream): each
of the tracked frames `--frame` .. `--frame` + 4 under its own profiler
(extraction, `track_feats`; a frame whose keyframe ran a mapper step is
reported apart), and the `--step`-th regular mapper step (`process`).
For each: kernel launches, device busy, host wall time and the idle share,
and the kernels that take the most device time.

    python experiments/port_track_profile.py [--frames 10] [--inertial]
    python experiments/port_track_profile.py --cpu-ops
    python experiments/port_track_profile.py --track-map [--frame 70] [--step 10]
    python experiments/port_track_profile.py --system [--frame 70] [--step 10]

`--system` profiles the same window of chip_smoke's system world instead
(`System.track` on the circlebow30 stream: the extraction, the
vocabulary's tree descent, `track_feats`, with the System's sync mapper).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as cs
from monoorbslam3_tpu_torch.frontend import tracking

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
    ap.add_argument("--inertial", action="store_true",
                    help="the visual-inertial drive, and the inertial pieces' launches")
    ap.add_argument("--cpu-ops", action="store_true",
                    help="only the inertial pieces' aten operations on the CPU (no card)")
    ap.add_argument("--system", action="store_true",
                    help="profile frames and a mapper step of chip_smoke's system world")
    ap.add_argument("--track-map", action="store_true",
                    help="the track-map path: tracked frames and a mapper step")
    ap.add_argument("--frame", type=int, default=70,
                    help="--track-map: the first of the five profiled frames")
    ap.add_argument("--step", type=int, default=10,
                    help="--track-map: the regular mapper step profiled (1 = the first)")
    args = ap.parse_args()
    if args.cpu_ops:
        return cpu_ops()
    if not torch.cuda.is_available():
        sys.exit("port_track_profile: needs a CUDA device")
    print(torch.cuda.get_device_name(0))
    if args.track_map or args.system:
        return track_map_profile(args.frame, args.step, args.top, system=args.system)
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
    if args.inertial:
        drive = lambda **kw: cs.vi_drive(pipe, **kw)[0]
    else:
        drive = lambda **kw: cs.drive(pipe, **kw)
    with cs._Capture(tracking, "_pose_optimize_impl", maxlen=1) as lm_cap:
        plain = drive(n_frames=args.frames, log=lambda line: None)[WARM_FRAMES:]
    print(f"unprofiled drive: host frame ms p50 {cs._pct([r['host_frame_ms'] for r in plain], 50):.3f} "
          f"over {len(plain)} frames")
    drive(n_frames=args.frames, log=log)
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
    if args.inertial:
        inertial_pieces(pipe, lm_cap)


def _summary(prof, host_ms, top):
    """Launches, device busy, idle share and the top kernels of one profiled
    window of `host_ms` of host time."""
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key.startswith(("cudaLaunch", "cuLaunch")))
    kern = sorted(device_rows(ka), key=_dev_us, reverse=True)
    busy = sum(_dev_us(e) for e in kern) / 1e3
    return dict(launches=launches, device_busy_ms=busy, host_ms=host_ms,
                idle_share=1.0 - busy / host_ms,
                top=[(e.key[:70], round(_dev_us(e) / 1e3, 4), e.count) for e in kern[:top]])


def track_map_profile(frame_at, step_at, top, system=False):
    """Profile five tracked frames and one regular mapper step of
    chip_smoke's track-map path, or of its system world (see the module
    docstring)."""
    import tempfile
    import time

    from monoorbslam3_tpu_torch.frontend.local_mapping import LocalMapping

    frames, out = {}, {}
    current = {}

    def log(line):
        rec = json.loads(line)
        if "mapper_step" in rec:
            return
        i = rec["frame"]
        if i in frames:
            torch.cuda.synchronize()
            frames[i].stop()
            out[f"frame {i}"] = dict(state=rec["state"], n_tracked=rec["n_tracked"],
                                     keyframe=rec["n_kf"] != current.get("n_kf", rec["n_kf"]))
            out[f"frame {i}"].update(_summary(frames[i], rec["frame_ms"], top))
        current["n_kf"] = rec["n_kf"]
        if frame_at - 1 <= i < frame_at + 4:
            torch.cuda.synchronize()
            frames[i + 1] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            frames[i + 1].start()

    orig = LocalMapping.process
    calls = [0]

    def process(self, k, initial=False, light=False):
        if not initial:
            calls[0] += 1
        if initial or calls[0] != step_at:
            return orig(self, k, initial=initial, light=light)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            orig(self, k, initial=initial, light=light)
            torch.cuda.synchronize()
        out[f"mapper step {step_at} (KF {k}, imu_state {self.imu_state})"] = _summary(
            p, 1e3 * (time.perf_counter() - t0), top)

    # the tracer's first start takes seconds: not inside a measured window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    LocalMapping.process = process
    try:
        if system:
            with tempfile.TemporaryDirectory() as d:
                *_, stream, _ = cs.system_world("cuda", d, n_frames=frame_at + 5, log=log)
                stream.close()
        else:
            pipe = cs.TorchPipe("cuda")
            pipe.features(torch.zeros((pipe.cam.height, pipe.cam.width)).numpy())
            cs.track_map(pipe, n_frames=frame_at + 5, log=log)
    finally:
        LocalMapping.process = orig
    for name, rec in out.items():
        print(name, json.dumps(rec))


def profile_call(fn):
    """(kernel launches, device ms) of one fn() call after a warm-up call:
    the device rows of `key_averages()`, as the frame's busy time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    ka = p.key_averages()
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunchKernel"))
    return launches, sum(_dev_us(e) for e in device_rows(ka)) / 1e3


def inertial_pieces(pipe, lm_cap):
    """Launches and device ms of one call of each piece of the inertial
    stage, on a keyframe window of 50 samples (padded to 64: 6 tree
    levels), and of the last local stage's pose LM with its inertial tail
    and without it (the difference is the tail and the 15-dim solve)."""
    from monoorbslam3_tpu_torch.backend.problems import _pose_optimize_impl
    from monoorbslam3_tpu_torch.backend.problems import whiten
    from monoorbslam3_tpu_torch.frontend.tracking import _predict_deltas
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer
    from monoorbslam3_tpu_torch.sim import Trajectory

    g, a, d = Trajectory().imu_samples(0.0, 0.25, 200.0, bg=cs.BG_TRUE, ba=cs.BA_TRUE)
    buf = ImuBuffer()
    for k in range(len(d)):
        buf.add(g[k], a[k], d[k])
    bg = torch.as_tensor(cs.BG_TRUE, dtype=torch.float32, device="cuda")
    ba = torch.as_tensor(cs.BA_TRUE, dtype=torch.float32, device="cuda")
    pre = buf.integrate(bg, ba, pipe.calib)
    lm_args, lm_kw = lm_cap.calls[-1], lm_cap.kwargs[-1]
    pieces = {"preintegrate_tree (50 samples, padded to 64)":
              lambda: buf.integrate(bg, ba, pipe.calib),
              "whiten": lambda: whiten(pre),
              "_predict_deltas": lambda: _predict_deltas(pre, bg, ba),
              "pose LM, inertial": lambda: _pose_optimize_impl(*lm_args, **lm_kw),
              "pose LM, visual": lambda: _pose_optimize_impl(
                  *lm_args, **dict(lm_kw, use_inertial=False))}
    out = {}
    for name, fn in pieces.items():
        n, ms = profile_call(fn)
        out[name] = dict(launches=n, device_ms=ms)
    out["inertial tail (LM difference)"] = {
        k: out["pose LM, inertial"][k] - out["pose LM, visual"][k] for k in ("launches", "device_ms")}
    print("inertial stage, one call each:", json.dumps(out))


VIEWS = {"view", "expand", "slice", "select", "transpose", "t", "permute", "unsqueeze",
         "squeeze", "as_strided", "alias", "detach", "_unsafe_view", "diagonal", "unbind",
         "split", "chunk", "_reshape_alias", "reshape", "lift_fresh", "expand_as", "view_as",
         "narrow"}


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn):
    with _OpCount() as c:
        fn()
    return c.n


def cpu_ops():
    """Non-view aten operations of one call of each inertial piece on the
    CPU: `ImuBuffer.integrate` (upload and tree) on a frame window (10
    samples) and a keyframe window (50), both padded to 64; the deltas; the
    prediction from the keyframe; `whiten`; one step of the pose LM's
    inertial tail over 5 candidates; the 15-dim damped solve of 4
    dampings against the visual branch's 6-dim one."""
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.backend import solver
    from monoorbslam3_tpu_torch.backend.problems import _tail_linearize, whiten
    from monoorbslam3_tpu_torch.backend.residuals import KfState
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer
    from monoorbslam3_tpu_torch.sim import Trajectory

    settings = config.load_settings(cs.SETTINGS / cs.EUROC_PROFILE)
    calib = config.build_imu_calib(settings, device="cpu")
    bg, ba = torch.zeros(3), torch.zeros(3)
    out = {}
    for n in (10, 50):
        g, a, d = Trajectory().imu_samples(0.0, n / 200.0, 200.0)
        buf = ImuBuffer()
        for k in range(len(d)):
            buf.add(g[k], a[k], d[k])
        out[f"integrate_{n}_samples"] = count_ops(lambda: buf.integrate(bg, ba, calib))
    pre = buf.integrate(bg, ba, calib)
    kf = KfState(torch.eye(3), torch.zeros(3), torch.zeros(3), bg, ba)
    deltas = tracking._predict_deltas(pre, bg, ba)
    out["predict_deltas"] = count_ops(lambda: tracking._predict_deltas(pre, bg, ba))
    out["prediction"] = count_ops(lambda: tracking._predict_state_inertial(kf, *deltas, pre.dt))
    out["whiten"] = count_ops(lambda: whiten(pre))
    edge = whiten(pre)
    cands = KfState(*(x[None].expand(5, *x.shape) for x in kf))
    out["lm_tail_step"] = count_ops(lambda: _tail_linearize(cands, edge, kf, 1.0, kf, None,
                                                              True, False))
    H, g15 = torch.eye(15)[None].repeat(4, 1, 1), torch.ones(4, 15)
    out["solve_15"] = count_ops(lambda: solver.solve_spd15_jacobi(H, g15))
    H6 = torch.eye(6)[None].repeat(4, 1, 1)

    def solve_6():  # the visual branch's solve (problems._pose_optimize_impl)
        d6 = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(H6, dim1=-2, dim2=-1)), min=1e-12))
        Hn = H6 / (d6[..., :, None] * d6[..., None, :])
        steps = -(solver.inv_spd6(Hn) @ (g15[:, :6] / d6)[..., None]).squeeze(-1) / d6
        return torch.nn.functional.pad(steps, (0, 9))

    out["solve_6"] = count_ops(solve_6)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
