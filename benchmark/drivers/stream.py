"""Generator of the `stream` mixes: a recorded sequence processed offline,
closed loop, every frame through `System.track(t, image, imu)` with the
synchronous mapper (the user's path: the configuration's settings profile
through `config.build_system`, the vocabulary, `System.warmup`).

Set-up renders the sequence from the seed (`benchmark/world`), builds the
System, warms it up, and tracks the mix's first frames: the bootstrap and
the mapper's first inertial init. The window then tracks frame after
frame for `--seconds`; `stream_fps` is the frames tracked in those
seconds over the seconds, the mapper's steps inside them. The frame that
straddles the window's end counts by the share of its time that falls
inside the window: counted whole, with all its time, it would weigh the
rate toward the longest frames (a frame that holds a polish of seconds
straddles the end more often than a short one does). The sequence holds
the frames the camera records over the window, at most the mix's
`max_window_frames`; where the port tracks them all first, the window
ends there (a line on standard error says so).

The benchmark's wrappers (`benchmark/probes.py`) time the mapper's steps,
count the tracker's fetches, name the spans of a traced run, log the hand
kernels' shapes while tracing and, in frames drawn from the seed, keep the
inputs and outputs of each stage for the check: extraction (K1 inside),
the vocabulary's transform, the gated match (K2), the frame LM, and the
mapper's next Hamming blocks (K3) and window BA (K4). The window's first
polishes (the solves of `Problems.full_inertial_optimize`, K4's large-D
route past `local_k` keyframes) are kept for the check too.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
import yaml

from benchmark import host, probes
from benchmark.harness import check
from benchmark.reference.judge import Reference, ate
from benchmark.trace import Tracer
from benchmark.world.stream import build_stream, seeds

TRACE_S = 3.0
LOST = 4
# how many calls of a kind a sampled frame or step keeps
KEEP = {"extract": 3, "bow": 3, "match_rows": 24, "pose": 9, "hamming": 8, "schur_ba": 1,
        "polish_ba": 2}


class Proxy:
    """Wraps a callable object (the extractor): times and spans its calls,
    forwards every attribute."""

    def __init__(self, obj, call):
        self._obj, self._call = obj, call

    def __call__(self, *a, **k):
        return self._call(self._obj, *a, **k)

    def __getattr__(self, name):
        return getattr(self._obj, name)


def _settings_file(cfg, root) -> str:
    """The configuration's settings profile, with its vocabulary node
    pointing at the benchmark's copy, as a YAML file for `build_system`."""
    s = dict(cfg["settings"])
    voc = cfg["vocabulary"]
    s["Vocabulary"] = {"File": str(root / voc["file"]), "GroupLevel": int(voc["group_level"])}
    fd, path = tempfile.mkstemp(suffix=".yaml")
    with os.fdopen(fd, "w") as f:
        yaml.safe_dump(s, f, sort_keys=False)
    return path


def run(job, t_start):
    from monoorbslam3_tpu_torch import config as port_config
    from monoorbslam3_tpu_torch import native
    from monoorbslam3_tpu_torch.backend import problems as port_problems
    from monoorbslam3_tpu_torch.backend import solver as port_solver
    from monoorbslam3_tpu_torch.frontend import local_mapping  # noqa: F401 (wrapped by name)
    from monoorbslam3_tpu_torch.frontend import tracking  # noqa: F401 (wrapped by name)
    from monoorbslam3_tpu_torch.ops import chol_pallas, match_pallas, pallas_kernels, vocab

    cfg, mix, dev = job.cfg, job.mix, job.device
    on_card = dev.type == "cuda"
    fps = float(cfg["settings"]["Camera"]["fps"])
    n_warm = int(cfg["stream"]["warm_frames"])
    n_frames = n_warm + min(int(np.ceil(job.seconds * fps)), int(mix["max_window_frames"]))
    t0 = time.perf_counter()
    stream = build_stream(cfg, job.seed, n_frames, dev)
    job.log(f"[{job.workload['name']}] {n_frames} frames rendered in "
            f"{time.perf_counter() - t0:.2f} s")
    frames = stream["frames"]
    # the frames of the window whose stages the check replays, drawn from
    # the seed among its first `sample_from` (every run tracks that many;
    # the window's whole span but its last frames)
    sampled = set(np.random.default_rng(seeds(job.seed, 4)[3]).choice(
        int(mix["sample_from"]), int(mix["sample_frames"]), replace=False).tolist())

    native.get_ext("map_ops")  # its g++ build (a checkout's first run) stays out of the window
    path = _settings_file(cfg, job.root)
    t0 = time.perf_counter()
    try:
        system = port_config.build_system(path, device=dev)
    finally:
        os.unlink(path)
    job.log(f"[{job.workload['name']}] System built in {time.perf_counter() - t0:.2f} s")

    rec = probes.Recorder()
    mapper_ms, mapper_syncs = [], []
    state = {"in_mapper": False, "sample_mapper": False, "in_polish": False, "in_window": False}

    def extract_call(ext, img):
        with torch.profiler.record_function("extract"):
            out = ext(img)
        if rec.sampling:
            rec.keep("extract", (img, ext.n_features), {}, out, KEEP["extract"])
        return out

    patches = probes.Patches()
    patches.set(system, "extractor", Proxy(system.extractor, extract_call))
    if system.init_extractor is not None:
        patches.set(system, "init_extractor", Proxy(system.init_extractor, extract_call))

    track_feats = system.tracking.track_feats

    def track_call(*a, **k):
        with torch.profiler.record_function("track"):
            return track_feats(*a, **k)

    patches.set(system.tracking, "track_feats", track_call)
    process = system.mapper.process
    syncs = system.problems.syncs

    def mapper_call(*a, **k):
        s0, t0 = syncs.n, time.perf_counter()
        state["in_mapper"] = True
        try:
            with torch.profiler.record_function("mapper"):
                return process(*a, **k)
        finally:
            state["in_mapper"] = False
            state["sample_mapper"] = False
            mapper_ms.append(1e3 * (time.perf_counter() - t0))
            mapper_syncs.append(syncs.n - s0)

    patches.set(system.mapper, "process", mapper_call)
    polish = system.problems.full_inertial_optimize

    def polish_call(*a, **k):
        state["in_polish"] = True
        try:
            return polish(*a, **k)
        finally:
            state["in_polish"] = False

    patches.set(system.problems, "full_inertial_optimize", polish_call)

    def keep_when_sampled(name, mapper_side=False):
        def make(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                if (state["sample_mapper"] and state["in_mapper"]) if mapper_side \
                        else (rec.sampling and not state["in_mapper"]):
                    rec.keep(name, a, k, out, KEEP[name])
                return out
            return wrapped
        return make

    transform = vocab.Vocabulary.transform

    def bow_call(self, desc, valid):
        out = transform(self, desc, valid)
        if rec.sampling:
            rec.keep("bow", (desc, valid), {}, out, KEEP["bow"])
        return out

    patches.set(vocab.Vocabulary, "transform", bow_call)

    def k2(orig):
        keep = keep_when_sampled("match_rows")(orig)

        def wrapped(desc_a, desc_b, *rest):
            rec.shape("match_rows", (desc_a.shape[0], desc_b.shape[0]))
            return keep(desc_a, desc_b, *rest)
        return wrapped

    def ba(orig):
        keep = keep_when_sampled("schur_ba", mapper_side=True)(orig)

        def wrapped(problem, *a, **k):
            with torch.profiler.record_function("solve"):
                if not state["in_polish"]:
                    return keep(problem, *a, **k)
                out = orig(problem, *a, **k)
            if state["in_window"]:
                rec.keep("polish_ba", (problem,) + a, k, out, KEEP["polish_ba"])
            return out
        return wrapped

    def k4(orig):
        def wrapped(S, b):
            D = S.shape[-1]
            rec.shape("chol_solve", (S.reshape(-1, D, D).shape[0], D))
            return orig(S, b)
        return wrapped

    with patches:
        patches.wrap_function(match_pallas._match_rows, k2)
        patches.wrap_function(pallas_kernels.hamming_matrix_pallas,
                              keep_when_sampled("hamming", mapper_side=True))
        patches.wrap_function(port_problems._pose_optimize_impl, keep_when_sampled("pose"))
        patches.wrap_function(port_solver.schur_ba, ba)
        patches.wrap_function(chol_pallas.chol_solve, k4)
        return _stream(job, t_start, system, frames, stream, n_warm, sampled, rec, state,
                       mapper_ms, mapper_syncs, on_card)


def _stream(job, t_start, system, frames, stream, n_warm, sampled, rec, state, mapper_ms,
            mapper_syncs, on_card):
    dev = job.device
    name = job.workload["name"]
    t0 = time.perf_counter()
    system.warmup()
    t1 = time.perf_counter()
    states = [system.track(*frames[i]) for i in range(n_warm)]
    job.log(f"[{name}] warmup {t1 - t0:.2f} s, warm frames {time.perf_counter() - t1:.2f} s")
    imu_state0 = int(system.mapper.imu_state)
    kf0, pt0 = system.store.n_keyframes(), system.store.n_points()
    tracer = Tracer() if job.trace else None
    if tracer:
        tracer.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    job.log(f"[{name}] set-up {setup_s:.2f} s: {n_warm} frames tracked, imu_state "
            f"{imu_state0}, {kf0} keyframes, {pt0} map points; window of {job.seconds} s")
    n_steps0 = len(mapper_ms)
    host0 = host.sample()
    state["in_window"] = True

    syncs = system.problems.syncs
    frame_rec = []  # (ms, mapper ms inside, tracker fetches, traced)
    trace_from = job.seconds - TRACE_S if tracer else float("inf")
    i = n_warm
    t0 = f0 = f1 = time.perf_counter()
    while i < len(frames):
        elapsed = time.perf_counter() - t0
        if elapsed >= job.seconds:
            break
        if tracer and tracer.prof is None and elapsed >= trace_from:
            tracer.start()
            rec.tracing = True
        w = i - n_warm
        rec.sampling = w in sampled
        if rec.sampling:
            state["sample_mapper"] = True
        m0, s0 = len(mapper_ms), syncs.n
        f0 = time.perf_counter()
        states.append(system.track(*frames[i]))
        f1 = time.perf_counter()
        ms = 1e3 * (f1 - f0)
        rec.sampling = False
        in_map = sum(mapper_ms[m0:])
        fetches = syncs.n - s0 - sum(mapper_syncs[m0:])
        frame_rec.append((ms, in_map, fetches, rec.tracing))
        i += 1
    else:
        job.log(f"[{name}] the port tracked all {len(frames) - n_warm} frames of the sequence "
                f"before the window's end: the window ends there")
    window_s = time.perf_counter() - t0
    state["in_window"] = False
    host1 = host.sample()
    # the last frame straddles the window's end (or ends it, where the
    # sequence ran out): it counts by its share inside the window
    start, end = f0 - t0, f1 - t0
    rate_s = min(end, job.seconds)
    n_rate = len(frame_rec) - 1 + (rate_s - start) / (end - start) if frame_rec else 0.0
    trace = None
    if tracer and tracer.prof is not None:
        tracer.stop()
        rec.tracing = False
        trace = tracer.summary()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_window = len(frame_rec)
    steps = len(mapper_ms) - n_steps0
    job.log(f"[{name}] window: {n_window} frames in {window_s:.2f} s ({n_rate:.3f} in the "
            f"first {rate_s:.2f} s), {steps} mapper steps, "
            f"{len(rec.calls.get('polish_ba', []))} polishes kept, "
            f"{system.store.n_keyframes() - kf0} keyframes, imu_state {system.mapper.imu_state}; "
            f"map at the end {system.store.n_keyframes()} keyframes, "
            f"{system.store.n_points()} points")
    job.log(f"[{name}] host over the window: {host.describe(host0, host1, window_s)}")
    times, positions, _ = system.keyframe_trajectory()
    system.shutdown()
    del system
    if on_card:
        torch.cuda.empty_cache()

    ref = Reference(job.cfg, dev, vocab_path=str(job.root / job.cfg["vocabulary"]["file"]))
    checks = _checks(job, stream, states, times, positions, rec, ref, control=False)
    if job.control:
        # the port's own readings first (on standard error), then the
        # control's, which the result line carries
        for k, v in checks.items():
            job.log(f"port {k} {v['value']}")
        checks = _checks(job, stream, states, times, positions, rec, ref, control=True)
    nm = "not measured"
    e2e = {"stream_fps": n_rate / rate_s if on_card else nm,
           "setup_s": setup_s if on_card else nm}
    record = {"kind": "stream", "on_card": on_card, "trace": trace, "shapes": rec.shapes,
              "frames": frame_rec, "mapper_ms": mapper_ms[n_steps0:],
              "window_s": window_s, "imu_state_at_window": imu_state0}
    return {"attempted": n_window, "failed": int(sum(s == LOST for s in states[n_warm:])),
            "memory_peak_bytes": int(peak), "e2e": e2e, "checks": checks, "trace": trace,
            "record": record}


def _checks(job, stream, states, times, positions, rec, ref, control):
    limits, guar = job.mix["checks"], job.cfg["guarantees"]
    calls = rec.calls

    def worst(name, values):
        return check(max(values) if values else None, limits[name])

    ext = [ref.extract(a[0], a[1], out, control) for a, _, out in calls.get("extract", [])]
    bow = [ref.bow(a[0], a[1], out[0], out[1]) for a, _, out in calls.get("bow", [])]
    k2 = [ref.match_rows(a, out, control) for a, _, out in calls.get("match_rows", [])]
    pose = [ref.pose(a, k, out, control) for a, k, out in calls.get("pose", [])]
    k3 = [ref.hamming(a[0], a[1], out, control) for a, _, out in calls.get("hamming", [])]
    ba = [ref.window_ba(a[0], k, out, control=control) for a, k, out in calls.get("schur_ba", [])]
    polish = [ref.window_ba(a[0], k, out, control=control)
              for a, k, out in calls.get("polish_ba", [])]
    return {
        "lost_frames": check(int(sum(s == LOST for s in states)), guar["lost_frames"]),
        "ate_m": check(ate(np.asarray(times), np.asarray(positions), stream["gt_t"],
                           stream["gt_p"]), _ate_limit(guar, times, stream)),
        "extract_mismatch": worst("extract_mismatch", ext),
        "bow_mismatch": worst("bow_mismatch", bow),
        "match_mismatch": worst("match_mismatch", k2),
        "pose_gap_m": worst("pose_gap_m", pose),
        "hamming_mismatch": worst("hamming_mismatch", k3),
        "ba_cost_excess": worst("ba_cost_excess", [b[0] for b in ba]),
        "ba_step_gap": worst("ba_step_gap", [b[1] for b in ba]),
        "polish_cost_excess": worst("polish_cost_excess", [b[0] for b in polish]),
        "polish_step_gap": worst("polish_step_gap", [b[1] for b in polish]),
    }


def _ate_limit(guar, times, stream) -> float:
    """The configuration's ATE guarantee: `ate_m` as it stands, or
    `ate_per_m` times the length of the true path the keyframes span."""
    if "ate_m" in guar:
        return float(guar["ate_m"])
    t, p = stream["gt_t"], stream["gt_p"]
    span = (t >= min(times, default=0.0)) & (t <= max(times, default=0.0))
    return float(guar["ate_per_m"] * np.linalg.norm(np.diff(p[span], axis=0), axis=1).sum())
