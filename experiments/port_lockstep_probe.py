"""Where two lock-step runs part: the bootstrap, the keyframes, the polish.

Three CPU diagnostics behind experiments/port_lockstep_jax.py's breaks.

`bootstrap`: both packages' `System` of one battery world and seed over
its first frames, in this process (JAX on the CPU), each package's
`reconstruct_two_views` watched. For every bootstrap attempt it prints
whether the two packages got the same inputs (the ideal pixels' largest
difference, in pixels and float32 ulps, and the rows that differ) and the
same `[200, 8]` samples, both outcomes (success, rh, n_good, n_inliers,
min_good, parallax), the CheckRT flags that differ, the depths of the
points both keep good, and the best fundamental-matrix hypotheses of each
package on the JAX run's inputs (sample, score, whether its 8 indices
repeat one: such a sample's 8x9 system has a two-dimensional null space).

`keyframes`: the keyframe trajectories that port_lockstep_jax.py wrote
into `--out`, each aligned to the ground truth as `evaluate_sequences`
aligns it: per run, its ATE, its median keyframe error and its worst
keyframes (time, error); per pair, the median and largest distance
between the two runs' keyframes of equal time.

`polish`: one package's run of the world at `--seed` (all its frames),
the keyframe trajectory exported before and after every full polish
(`full_inertial_optimize`) and scored against the ground truth: per
polish, the keyframe count, the ATE before and after, and the keyframes
the polish moved most (time, error before and after).

    python experiments/port_lockstep_probe.py bootstrap [--world circlebow30] [--seed 5] [--frames 3]
    python experiments/port_lockstep_probe.py keyframes --out DIR [--world circlebow30] [--seeds 0,1]
    python experiments/port_lockstep_probe.py polish --package port|jax [--world circlebow30] [--seed 0]

A bootstrap probe takes about two minutes, the keyframe one seconds, a
polish probe a whole run (10-30 minutes on a CPU).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def _host(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _attempts(pkg, world, seed, frames):
    """The (inputs, outputs) of each `reconstruct_two_views` call of one
    package's System over the world's first frames."""
    if pkg == "jax":
        from monoorbslam3_tpu.config import build_system
        from monoorbslam3_tpu.frontend import tracking
        from monoorbslam3_tpu.runners.synth import SyntheticDataset
        kw = {}
    else:
        from monoorbslam3_tpu_torch.config import build_system
        from monoorbslam3_tpu_torch.frontend import tracking
        from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset
        kw = {"device": "cpu"}
    from monoorbslam3_tpu_torch.runners.validation import WORLDS

    settings, spec = WORLDS[world][:2]
    syst = build_system(os.path.join(ROOT, settings), config_overrides={"seed": seed}, **kw)
    dataset = SyntheticDataset(spec, syst.camera, syst.calib)
    seen, inner = [], tracking.reconstruct_two_views

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(([_host(a) for a in args[:5]], {k: _host(v) for k, v in out.items()}))
        return out

    tracking.reconstruct_two_views = spy
    try:
        for i, (t, image, imu) in enumerate(dataset.frames()):
            if i >= frames:
                break
            syst.track(t, image, imu)
    finally:
        tracking.reconstruct_two_views = inner
    return seen


def _f_ranking(xy1, xy2, valid, idx):
    """Each package's fundamental-matrix scores of the 200 hypotheses of
    `idx` on the same inputs: the top three (sample, score, repeats)."""
    import jax
    import jax.numpy as jnp
    import torch

    from monoorbslam3_tpu.ops import twoview as jtv
    from monoorbslam3_tpu_torch.ops import twoview as ttv

    j = [jnp.asarray(a) for a in (xy1, xy2, valid)]
    _, m1, c1, T1 = jtv._masked_normalize(j[0], j[2])
    _, m2, c2, T2 = jtv._masked_normalize(j[1], j[2])
    Fn = jtv._dlt_fundamental((j[0][idx] - m1) * c1, (j[1][idx] - m2) * c2)
    F = jnp.swapaxes(T2, -1, -2)[None] @ Fn @ T1[None]
    sj = np.asarray(jax.vmap(lambda f: jtv._score_fundamental(f, *j, 1.0)[0])(F))
    t = [torch.as_tensor(np.array(a)) for a in (xy1, xy2, valid)]
    ti = torch.as_tensor(idx)
    _, m1, c1, T1 = ttv._masked_normalize(t[0], t[2])
    _, m2, c2, T2 = ttv._masked_normalize(t[1], t[2])
    Fn = ttv._dlt_fundamental((t[0][ti] - m1) * c1, (t[1][ti] - m2) * c2)
    st = ttv._score_fundamental(T2.T[None] @ Fn @ T1[None], *t, 1.0)[0].numpy()
    repeats = np.array([len(set(row)) < 8 for row in idx])
    top = lambda s: [(int(i), round(float(s[i]), 1), bool(repeats[i])) for i in np.argsort(-s)[:3]]
    return dict(jax=top(sj), port=top(st), samples_repeating=int(repeats.sum()))


def bootstrap(args):
    import tests.conftest  # noqa: F401  (JAX on the CPU backend)
    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    runs = {p: _attempts(p, args.world, args.seed, args.frames) for p in ("jax", "port")}
    for n, ((ij, oj), (it, ot)) in enumerate(zip(runs["jax"], runs["port"])):
        w = ij[2].astype(np.float32)
        idx = np.asarray(jax.random.choice(ij[4], len(w), (200, 8),
                                           p=jnp.asarray(w / max(w.sum(), 1.0))))
        print(f"attempt {n}: inputs equal {[bool(np.array_equal(a, b)) for a, b in zip(ij[:4], it[:4])]}, "
              f"samples equal {bool(np.array_equal(idx, it[4]))}, valid rows {int(ij[2].sum())}")
        for k in (0, 1):
            d = np.abs(ij[k] - it[k]).max(axis=1)
            ulps = np.abs(ij[k].view(np.int32).astype(np.int64) - it[k].view(np.int32)).max()
            print(f"  xy{k + 1}: largest difference {d.max():.3e} px ({int(ulps)} ulps), "
                  f"{int((d > 0).sum())} rows differ")
        for k in ("success", "rh", "n_good", "n_inliers", "min_good", "parallax_deg"):
            print(f"  {k}: JAX {oj[k]}, port {ot[k]}")
        good = oj["good"] & ot["good"]
        rel = np.abs(ot["points"][good, 2] / oj["points"][good, 2] - 1.0)
        print(f"  CheckRT flags differing: {int((oj['good'] != ot['good']).sum())} of "
              f"{int(oj['good'].sum())}; depths of the common good points: median "
              f"{np.median(rel):.2e}, p95 {np.percentile(rel, 95):.2e}, max {rel.max():.2e}")
        print(f"  best F hypotheses (sample, score, repeats an index): "
              f"{_f_ranking(ij[0], ij[1], ij[2], idx)}")


def _kf_errors(est, t_gt, p_gt):
    """{keyframe time: error} of a keyframe trajectory file, aligned to the
    ground truth as `evaluate_sequences` aligns it, and its ATE."""
    from monoorbslam3_tpu_torch.evaluation.ate import umeyama_align
    from monoorbslam3_tpu_torch.evaluation.metrics import load_tum

    t, p, _ = load_tum(est)
    g = p_gt[np.clip(np.searchsorted(t_gt, t - 1e-6), 0, len(t_gt) - 1)]
    s, R, tr = umeyama_align(p, g)
    err = np.linalg.norm(s * p @ R.T + tr - g, axis=1)
    return dict(zip(np.round(t, 3).tolist(), err.tolist())), float(np.sqrt(np.mean(err ** 2)))


def keyframes(args):
    from monoorbslam3_tpu_torch.evaluation.metrics import load_tum

    for seed in (int(s) for s in args.seeds.split(",")):
        tag = os.path.join(args.out, f"{args.world}_s{seed}_")
        t_gt, p_gt, _ = load_tum(tag + "jax_gt.txt")
        kf = {}
        for pkg in ("jax", "port"):
            t, p, _ = load_tum(tag + pkg + "_est.txt")
            err, ate = _kf_errors(tag + pkg + "_est.txt", t_gt, p_gt)
            worst = sorted(err, key=lambda k: -err[k])[:3]
            kf[pkg] = dict(zip(np.round(t, 3), p))
            print(f"{args.world} seed {seed} {pkg}: ATE {ate:.4f} m, median keyframe error "
                  f"{np.median(list(err.values())):.4f} m, worst "
                  f"{[(k, round(err[k], 4)) for k in worst]}")
        common = sorted(set(kf["jax"]) & set(kf["port"]))
        gap = np.array([np.linalg.norm(kf["jax"][c] - kf["port"][c]) for c in common])
        print(f"{args.world} seed {seed}: {len(common)} keyframes of equal time, distance "
              f"between the runs median {np.median(gap):.4f}, max {gap.max():.4f} at "
              f"{common[int(np.argmax(gap))]} s")


def polish(args):
    import tempfile

    from monoorbslam3_tpu_torch.evaluation.metrics import load_tum
    from monoorbslam3_tpu_torch.runners.validation import WORLDS

    if args.package == "jax":
        import tests.conftest  # noqa: F401  (JAX on the CPU backend)
        from monoorbslam3_tpu.config import build_system
        from monoorbslam3_tpu.runners.datasets import run_sequence
        from monoorbslam3_tpu.runners.synth import SyntheticDataset
        kw = {}
    else:
        from monoorbslam3_tpu_torch.config import build_system
        from monoorbslam3_tpu_torch.runners.datasets import run_sequence
        from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset
        kw = {"device": "cpu"}
    settings, spec = WORLDS[args.world][:2]
    syst = build_system(os.path.join(ROOT, settings), config_overrides={"seed": args.seed}, **kw)
    dataset = SyntheticDataset(spec, syst.camera, syst.calib)
    out = tempfile.mkdtemp()
    gt = os.path.join(out, "gt.txt")
    dataset.save_ground_truth(gt)
    t_gt, p_gt, _ = load_tum(gt)
    inner, snaps = syst.problems.full_inertial_optimize, []

    def polished(store, *a, **k):
        paths = [os.path.join(out, f"polish{len(snaps)}_{w}.txt") for w in ("before", "after")]
        syst.save_keyframe_trajectory(paths[0])
        result = inner(store, *a, **k)
        syst.save_keyframe_trajectory(paths[1])
        snaps.append((store.n_keyframes(), paths))
        return result

    syst.problems.full_inertial_optimize = polished
    run_sequence(syst, dataset, progress_every=0)
    syst.shutdown()
    for n, (n_kf, (before, after)) in enumerate(snaps):
        (eb, ate_b), (ea, ate_a) = _kf_errors(before, t_gt, p_gt), _kf_errors(after, t_gt, p_gt)
        moved = sorted(ea, key=lambda t: -abs(ea[t] - eb.get(t, ea[t])))[:3]
        print(f"polish {n} at {n_kf} keyframes: ATE {ate_b:.4f} -> {ate_a:.4f} m; moved most "
              f"{[(t, round(eb.get(t, float('nan')), 4), round(ea[t], 4)) for t in moved]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("bootstrap", "keyframes", "polish"))
    ap.add_argument("--package", choices=("port", "jax"), default="port",
                    help="the polish probe's package")
    ap.add_argument("--world", default="circlebow30")
    ap.add_argument("--seed", type=int, default=5, help="the bootstrap probe's seed")
    ap.add_argument("--frames", type=int, default=3, help="the bootstrap probe's frames")
    ap.add_argument("--out", default=None, help="port_lockstep_jax.py's --out (keyframes)")
    ap.add_argument("--seeds", default="0", help="the keyframe probe's seeds")
    args = ap.parse_args(argv)
    if args.probe == "bootstrap":
        bootstrap(args)
    elif args.probe == "polish":
        polish(args)
    else:
        if not args.out:
            ap.error("keyframes needs --out")
        keyframes(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
