"""The check that decides `correct`, driven through the harness on the CPU
with the timed path broken underneath: each fault the cell can have has
to come out not correct, and the unbroken path correct.

The stream cell's faults, on a short stream whose window holds the
mapper's first inertial init and its polish: an answer altered where each
stage produces it (a descriptor bit in the extractor, a word in the
vocabulary's transform, an index of K2, the frame LM's position, a
distance of K3); a window BA that returns its state unchanged; half of a
window BA's observations left out, the solve run over the rest. The BA
faults reach both the mapper's local windows and the polish."""

import json

import pytest
import torch

from benchmark.harness import ROOT, Bench, main


def small_bench(tmp_path, cfg_name, mix: dict, mix_name: str, checks_of="stream") -> Bench:
    """A Bench in tmp_path whose one cell runs `mix` (a small window or
    stream) on `cfg_name`, held to the limits of the real mix `checks_of`."""
    bench = Bench.load()
    real = bench.traffic(checks_of)
    (tmp_path / "traffic").mkdir(exist_ok=True)
    (tmp_path / "traffic" / f"{mix_name}.json").write_text(
        json.dumps(dict(mix, checks=real["checks"])))
    for sub in ("drivers", "metrics", "configs"):
        if not (tmp_path / sub).exists():
            (tmp_path / sub).symlink_to(ROOT / sub)
    for f in ("synthetic_voc_100k.txt.gz",):
        if not (tmp_path / f).exists():
            (tmp_path / f).symlink_to(ROOT / f)
    spec = dict(bench.spec, workloads=[{"name": f"{cfg_name}.{mix_name}", "config": cfg_name,
                                        "traffic": mix_name, "chips": 1}])
    return Bench(spec, root=tmp_path, checkout=bench.checkout)


def run_cell(bench, cell, capsys, seconds):
    rc = main(["--workload", cell, "--seed", "2147483659", "--seconds", seconds, "--trace", "0",
               "--device", "cpu"], 0.0, bench=bench)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# the window ends where its 70 frames run out, whatever the CPU's speed
SMALL_STREAM = {"driver": "stream", "sample_frames": 2, "sample_from": 3,
                "max_window_frames": 70}


def small_stream_bench(tmp_path):
    """euroc_mav at 376x240 (its intrinsics halved), 512 features, 40 warm
    frames: a stream the CPU tracks at a few frames a second, whose 70
    window frames reach the first inertial init and its polish."""
    bench = small_bench(tmp_path, "euroc_mav", SMALL_STREAM, "tiny_stream")
    cfg = bench.config("euroc_mav")
    cam = dict(cfg["settings"]["Camera"], Width=376, Height=240,
               CameraMatrix=[229.327, 0, 183.6075, 0, 228.648, 124.1875, 0, 0, 1.0])
    cfg = dict(cfg, settings=dict(cfg["settings"], Camera=cam,
                                  ORB=dict(cfg["settings"]["ORB"], Features=512)),
               stream={"warm_frames": 40})
    (tmp_path / "tiny_configs").mkdir()
    (tmp_path / "tiny_configs" / "euroc_small.json").write_text(json.dumps(cfg))
    spec = dict(bench.spec, configs=[dict(bench.spec["configs"][0], name="euroc_small",
                                          file="tiny_configs/euroc_small.json")],
                workloads=[{"name": "euroc_small.tiny_stream", "config": "euroc_small",
                            "traffic": "tiny_stream", "chips": 1}])
    return Bench(spec, root=tmp_path, checkout=tmp_path)


def _unchanged(orig):
    """A solve whose steps are never applied: it returns its input state,
    and its cost stays the starting one."""
    def fault(problem, *a, **k):
        kf, pts, info = orig(problem, *a, **k)
        start = info["cost0"]
        return problem.kf, problem.points, dict(info, cost=start,
                                                cost_hist=torch.full_like(info["cost_hist"], 0)
                                                + start)
    return fault


def _half_the_batch(orig):
    def fault(problem, *a, **k):
        valid = problem.obs_valid.clone()
        valid[::2] = False
        return orig(problem._replace(obs_valid=valid), *a, **k)
    return fault


def _solve_fault(make, polish_only=False):
    """`make`'s fault in every window BA, or only in the polish's solves
    (a stream whose solves all break may not reach its inertial init)."""
    def install(monkeypatch):
        from monoorbslam3_tpu_torch.backend import problems, solver

        orig = solver.schur_ba
        broken = make(orig)
        if polish_only:
            inside = {"polish": False}
            full = problems.Problems.full_inertial_optimize

            def polish(self, *a, **k):
                inside["polish"] = True
                try:
                    return full(self, *a, **k)
                finally:
                    inside["polish"] = False

            def schur_ba(*a, **k):
                return (broken if inside["polish"] else orig)(*a, **k)

            monkeypatch.setattr(problems.Problems, "full_inertial_optimize", polish)
        else:
            schur_ba = broken
        for mod in (solver, problems):
            monkeypatch.setattr(mod, "schur_ba", schur_ba)
    return install


def _stage_faults(monkeypatch):
    """An answer altered where each stage produces it."""
    from monoorbslam3_tpu_torch.backend import problems
    from monoorbslam3_tpu_torch.frontend import tracking
    from monoorbslam3_tpu_torch.ops import match_pallas, matching, orb, pallas_kernels, vocab

    call = orb.OrbExtractor.__call__

    def extract(self, img):
        out = dict(call(self, img))
        out["desc"] = out["desc"] ^ 1  # bit 0 of every descriptor
        return out

    transform = vocab.Vocabulary.transform

    def bow(self, desc, valid):
        word, group, hist = transform(self, desc, valid)
        return word + 1, group, hist

    k2 = match_pallas._match_rows

    def match_rows(*a):
        best, second, idx = k2(*a)
        return best + 1, second, idx

    lm = problems._pose_optimize_impl

    def pose(*a, **k):
        state, inlier = lm(*a, **k)
        return state._replace(t_wb=state.t_wb + 0.01), inlier

    k3 = pallas_kernels.hamming_matrix_pallas

    def hamming(a, b):
        return k3(a, b) + 1

    monkeypatch.setattr(orb.OrbExtractor, "__call__", extract)
    monkeypatch.setattr(vocab.Vocabulary, "transform", bow)
    monkeypatch.setattr(match_pallas, "_match_rows", match_rows)
    for mod in (problems, tracking):
        monkeypatch.setattr(mod, "_pose_optimize_impl", pose)
    for mod in (pallas_kernels, matching):
        monkeypatch.setattr(mod, "hamming_matrix_pallas", hamming)


STAGED = ("extract_mismatch", "bow_mismatch", "match_mismatch", "pose_gap_m", "hamming_mismatch")
SOLVES = ("ba_cost_excess", "polish_cost_excess")
FAULTS = {"sound": (None, ()),
          "every_stage_altered": (_stage_faults, STAGED),
          "solve_unchanged": (_solve_fault(_unchanged), ("ba_cost_excess",)),
          "half_the_batch": (_solve_fault(_half_the_batch), ("ba_cost_excess",)),
          "polish_unchanged": (_solve_fault(_unchanged, True), ("polish_cost_excess",)),
          "polish_half_the_batch": (_solve_fault(_half_the_batch, True),
                                    ("polish_cost_excess",))}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_stream_cell_faults_come_out_not_correct(tmp_path, capsys, monkeypatch, fault):
    install, caught = FAULTS[fault]
    if install is not None:
        install(monkeypatch)
    line = run_cell(small_stream_bench(tmp_path), "euroc_small.tiny_stream", capsys,
                    seconds="600")
    checks = line["checks"]
    for name in STAGED + SOLVES:
        v = checks[name]
        if name in caught:
            assert v["value"] is not None and v["value"] > v["limit"], (name, v)
        elif install is None:
            assert v["value"] is not None and v["value"] <= v["limit"], (name, v)
        else:  # a stream whose solves all break may not reach the polish
            assert v["value"] is None or v["value"] <= v["limit"], (name, v)
    assert line["correct"] is (install is None)
    assert list(line)[-1] == "checks"
