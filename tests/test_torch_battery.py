"""PyTorch port: the validation battery's runner and chip_smoke's battery
path on the CPU.

- `chip_smoke.battery_checks` passes a healthy run of both worlds, and
  each of its gates fails a case of its own.
- `chip_smoke.JAX_BATTERY`'s bounds are run_validation.py's, and the
  port's world table is run_validation.py's.
- `runners.validation.BatteryMeter` counts the polishes by branch, the
  culled slots recycled, the keyframe and point evictions, the
  RECENTLY_LOST frames and the reference-keyframe matches on a seeded
  `MapStore` and a stubbed tracker, and reads no tensor while it counts.
- K4's check on the battery's reduced systems: past `K4_FWD_COND` (the
  capped polish's systems reach condition ~1e8) the plain version and the
  numpy emulation of the kernel's cluster schedule land far from float64
  and many times apart, while both backward errors stay below float32's
  unit roundoff; `k4_split` sends such a system to the
  backward rule and a well-conditioned one to the forward rule.
- A short run of the forward profile (`corridor:t_end=4,fps=10`) through
  `runners.validation.run_world(..., device="cpu")`: the bootstrap, no
  LOST frame, and `score_world`'s row in run_validation.py's schema with
  the battery's fields beside it.
"""

import copy
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import run_validation
from experiments.port_chol_cluster_emulate import CLUSTER, cluster_solve
from monoorbslam3_tpu_torch.ops.chol_pallas import chol_solve_plain
from monoorbslam3_tpu_torch.models.map_state import MapStore
from monoorbslam3_tpu_torch.runners import validation as tval

from tests.test_torch_aux import BATTERY_ROW
from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("gather_patches", "match_rows", "hamming", "chol_solve", "chol_solve_l2")


def _healthy():
    """A run of both battery worlds that passes every gate: JAX's outcome,
    three fetches and syncs a tracked frame (more on the frames that fall
    back to other stages), a reset and a second bootstrap, flat device
    memory."""
    bat = {}
    for name in cs.BATTERY_WORLDS:
        ref = cs.JAX_BATTERY[name]
        _, _, ate_bound, scale_bound = tval.WORLDS[name]
        n = ref["frames"]
        row = dict(frames=n, ok_frames=ref["ok_frames"], lost_events=0,
                   n_keyframes=ref["n_keyframes"], kf_created_total=ref["kf_created_total"],
                   imu_state=2, ate_rmse=ref["ate_rmse"], scale_err=ref["scale_err"],
                   bound_ate=ate_bound, bound_scale=scale_bound,
                   kernel_builds_after_warmup={"builds": 0, "nvcc_calls": 0},
                   launches={k: 10 for k in KERNELS},
                   polishes=dict(n=6, mode="hybrid", window=2, grouped=2, subsampled=2,
                                 kf_counts=[]),
                   memory=dict(census=[dict(frame=f, rss_mb=900.0, alloc_mb=300.0,
                                            reserved_mb=400.0) for f in range(0, n, 100)]))
        records = [dict(frame=i, state=2, fetches=3, syncs=3, fetch_allowance=3)
                   for i in range(n)]
        for i, state, fetches, syncs in ((0, 1, 1, 1), (1, 2, 4, 14), (5, 1, 1, 1), (6, 2, 4, 14)):
            records[i].update(state=state, fetches=fetches, syncs=syncs)  # two bootstraps
        # fall-backs: to the last keyframe, and to the reference keyframe too
        records[8].update(fetches=4, syncs=4, fetch_allowance=4)
        records[9].update(fetches=6, syncs=6, fetch_allowance=6)
        steps = [dict(kf=k, fetches=8, syncs=7) for k in range(10)]
        bat[name] = dict(row=row, records=records, steps=steps,
                         region_syncs={"two-view bootstrap": 10, "local stage": 0})
    return bat


def test_battery_checks_pass_on_a_healthy_run():
    assert cs.battery_checks(_healthy()) == []
    assert cs.battery_checks(_healthy(), on_card=False) == []


def _set(name, **kw):
    return lambda bat: bat[name]["row"].update(**kw)


def _frame(name, i, **kw):
    return lambda bat: bat[name]["records"][i].update(**kw)


def _scale(name, key, factor):
    return lambda bat: bat[name]["row"].update({key: int(bat[name]["row"][key] * factor)})


def _no_launch(name, kernel):
    return lambda bat: bat[name]["row"]["launches"].update({kernel: 0})


def _memory(name, census):
    return lambda bat: bat[name]["row"]["memory"].update(census=census)


GATES = {
    "ate over the world's bound": (_set("corridor60", ate_rmse=4.6), "the world's"),
    "scale error": (_set("corridor60", scale_err=0.26), "scale error"),
    "a LOST event": (_set("fastspin30", lost_events=1), "LOST events"),
    "OK ratio": (_scale("fastspin30", "ok_frames", 0.9), "frames OK"),
    "inertial init unfinished": (_set("corridor60", imu_state=1), "imu_state"),
    "keyframes kept": (_scale("corridor60", "n_keyframes", 1.35), "n_keyframes"),
    "keyframes created": (_scale("fastspin30", "kf_created_total", 0.65), "kf_created_total"),
    "ATE over twice JAX's seeds": (
        lambda bat: bat["fastspin30"]["row"].update(
            ate_rmse=2.01 * max(cs.JAX_BATTERY["fastspin30"]["ate_over_seeds"])),
        "twice JAX's"),
    "a kernel build": (lambda bat: bat["fastspin30"]["row"].update(
        kernel_builds_after_warmup={"builds": 1, "nvcc_calls": 5}), "kernel builds"),
    **{f"{k} not launched": (_no_launch("corridor60", k), f"kernel {k}") for k in KERNELS},
    "no polish past full_k": (lambda bat: bat["corridor60"]["row"]["polishes"].update(
        subsampled=0), "past full_k"),
    "a fetch beyond the stages'": (
        lambda bat: bat["corridor60"]["records"][40].update(fetches=4, syncs=4),
        "fetched 4 times for 3"),
    "a fetch beyond the fall-back stages'": (
        lambda bat: bat["fastspin30"]["records"][9].update(fetches=7, syncs=7),
        "fetched 7 times for 6"),
    "syncs beyond the fetches": (_frame("corridor60", 90, syncs=4), "synced 4"),
    "a mapper step's syncs": (lambda bat: bat["corridor60"]["steps"][3].update(syncs=9),
                              "mapper step"),
    "a sync inside a stage": (lambda bat: bat["fastspin30"]["region_syncs"].update(
        {"local stage": 1}), "inside the local stage"),
    "device memory grows": (_memory("corridor60", [dict(frame=300, alloc_mb=300.0),
                                                   dict(frame=500, alloc_mb=380.0)]),
                            "device memory"),
    "no progress line at frame 300": (_memory("fastspin30", [dict(frame=0, alloc_mb=300.0)]),
                                      "device memory"),
}
CARD_ONLY = {"a fetch beyond the stages'", "a fetch beyond the fall-back stages'",
             "syncs beyond the fetches",
             "a mapper step's syncs", "a sync inside a stage", "device memory grows",
             "no progress line at frame 300"}


@pytest.mark.parametrize("gate", list(GATES))
def test_battery_checks_each_gate_fails(gate):
    mutate, says = GATES[gate]
    bat = _healthy()
    mutate(bat)
    fails = cs.battery_checks(bat)
    assert fails and any(says in f for f in fails), fails
    # the fetch, sync and memory gates are the card's only
    assert (cs.battery_checks(copy.deepcopy(bat), on_card=False) == []) == (gate in CARD_ONLY)


def test_jax_battery_bounds_are_run_validation_s():
    assert tval.WORLDS == run_validation.WORLDS
    for name in cs.BATTERY_WORLDS:
        ref = cs.JAX_BATTERY[name]
        assert (ref["bound_ate"], ref["bound_scale"]) == run_validation.WORLDS[name][2:]
        assert ref["ate_rmse"] in ref["ate_over_seeds"]
        assert ref["frames"] == {"fastspin30": 600, "corridor60": 600}[name]


def _feats(n):
    return dict(xy=np.zeros((n, 2), np.float32), level=np.zeros(n, np.int32),
                angle=np.zeros(n, np.float32), desc=np.zeros((n, 8), np.uint32),
                valid=np.ones(n, bool))


def _forbid(*a, **k):
    raise AssertionError("the battery's counters read a tensor")


def test_battery_meter_counts(monkeypatch):
    store = MapStore(max_kf=12, max_pt=40, n_feat=16)
    states = iter([1, 2, 3, 3, 2, 3, 2])
    steps = []
    system = types.SimpleNamespace(
        store=store,
        problems=types.SimpleNamespace(local_k=4, full_k=8, full_polish_mode="hybrid",
                                       full_inertial_optimize=lambda st, n_iters=12: None),
        tracking=types.SimpleNamespace(_match_against_ref_kf=lambda frame: True),
        mapper=types.SimpleNamespace(process=lambda k, initial=False, light=False:
                                     steps.append((k, initial))))

    def track(t, image, imu=None):
        state = next(states)
        if state == 3:  # a frame that falls back to the reference keyframe
            system.tracking._match_against_ref_kf(None)
        system.mapper.process(int(t), initial=t < 2)
        return state

    system.track = track
    meter = tval.BatteryMeter(system)
    for name in ("item", "cpu", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, _forbid)
    monkeypatch.setattr(torch.cuda, "synchronize", _forbid)

    got = [system.track(float(i), None) for i in range(7)]
    assert got == [1, 2, 3, 3, 2, 3, 2]
    # every slot once, then two culled slots recycled, then one eviction
    eye = np.eye(3, dtype=np.float32)
    kfs = [store.add_keyframe(0.1 * i, eye, np.zeros(3), np.zeros(3), np.zeros(3),
                              np.zeros(3), _feats(16)) for i in range(12)]
    store.remove_keyframe(kfs[3])
    store.remove_keyframe(kfs[5])
    for i in range(3):
        store.add_keyframe(2.0 + 0.1 * i, eye, np.zeros(3), np.zeros(3), np.zeros(3),
                           np.zeros(3), _feats(16))
    # every point slot, then one more: one eviction of the whole batch
    for i in range(41):
        store.add_point(np.zeros(3, np.float32), np.zeros(8, np.uint32), 0)
    for n in (3, 4, 5, 8, 9, 30):
        system.problems.full_inertial_optimize(types.SimpleNamespace(n_keyframes=lambda n=n: n))

    c = meter.counters()
    assert c["polishes"] == dict(n=6, mode="hybrid", window=2, grouped=2, subsampled=2,
                                 kf_counts=[3, 4, 5, 8, 9, 30])
    assert (c["kf_slots_recycled"], c["kf_evicted"]) == (2, 1)
    assert store.n_keyframes() == 12 and store.kf_created_total == 15
    assert (c["pt_evictions"], c["pts_evicted"]) == (1, 40)
    assert (c["recently_lost_frames"], c["ref_kf_matches"]) == (3, 3)
    assert c["n_mapper_steps"] == 5 and len(steps) == 7
    times = meter.times()
    assert times["frame_ms"]["n"] == 7 and times["mapper_ms"]["n"] == 5
    json.dumps(c)


def _seeded_system(seed, tiny):
    """A Jacobi-scaled SPD system of D = 600 whose `tiny` smallest
    eigenvalues lie at 1e-4 .. 1e-7 (the capped polish's shape: condition
    ~3e7) or, with tiny = 0, spread over 1e0.5 .. 1e-3."""
    rng = np.random.default_rng(seed)
    D = 600
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    lam = np.concatenate([np.logspace(0.5, -3, D - tiny), np.logspace(-4, -7, tiny)])
    S = (Q * lam) @ Q.T
    d = np.sqrt(np.diag(S))
    S = S / d[:, None] / d[None, :]
    S = ((S + S.T) / 2).astype(np.float32)
    return torch.tensor(S)[None], torch.tensor(rng.standard_normal(D).astype(np.float32))[None]


def test_k4_rule_past_its_condition_number():
    fwd, ratio = [], []
    for seed in range(3):
        S, b = _seeded_system(seed, tiny=184)
        x64 = torch.linalg.solve(S.double(), b.double())
        xp = chol_solve_plain(S, b)
        xk = torch.as_tensor(cluster_solve(S[0].numpy(), b[0].numpy(), CLUSTER)[0])[None]
        errs = [float(cs._rel(x, x64).max()) for x in (xp, xk)]
        fwd += errs
        ratio.append(max(errs) / min(errs))
        # both solved a system within float32's rounding of S
        for x in (xp, xk):
            assert float(cs.k4_backward(x, S, b).max()) < 2.0 ** -24
        parts, conds = cs.k4_split("battery G=1", [(S, b)])
        assert conds[0] > 1e7 and list(parts) == ["battery G=1, cond > 1e+05"]
    # no forward bound holds there: both codes err far past K4_RTOL, apart
    assert min(fwd) > 100 * cs.K4_RTOL and max(ratio) > 2.0
    S, b = _seeded_system(0, tiny=0)
    x64 = torch.linalg.solve(S.double(), b.double())
    xk = torch.as_tensor(cluster_solve(S[0].numpy(), b[0].numpy(), CLUSTER)[0])[None]
    assert float(cs._rel(chol_solve_plain(S, b), x64).max()) < cs.K4_RTOL
    assert float(cs._rel(xk, x64).max()) < cs.K4_RTOL
    parts, conds = cs.k4_split("battery G=1", [(S, b)])
    assert conds[0] < cs.K4_FWD_COND and list(parts) == ["battery G=1"]


def test_forward_profile_run(tmp_path):
    settings, _, ate_bound, scale_bound = tval.WORLDS["corridor60"]
    info = tval.run_world("corridor60", settings, "corridor:t_end=4,fps=10", str(tmp_path),
                          device="cpu")
    row = tval.score_world("corridor60", info)
    assert row["frames"] == 40 and row["lost_events"] == 0 and row["lost_at"] == []
    assert row["ok_frames"] >= 35 and row["n_keyframes"] >= 5
    assert row["kf_created_total"] >= row["n_keyframes"]
    # run_validation.py's row, as VALIDATION_r05.json holds it, and the
    # battery's fields beside it
    (ref,) = [r for r in json.loads((REPO / "VALIDATION_r05.json").read_text())
              if r["name"] == "corridor60"]
    assert set(row) == set(ref) | BATTERY_ROW
    assert (row["bound_ate"], row["bound_scale"]) == (ate_bound, scale_bound)
    assert row["device"]["platform"] == "cpu"
    for key in ("warmup_s", "frame_ms", "mapper_ms"):
        assert row[key] == "not measured"
    assert row["launches"] == {k: 0 for k in KERNELS}  # the plain versions on the CPU
    assert row["kernel_builds_after_warmup"] == {"builds": 0, "nvcc_calls": 0}
    assert row["n_mapper_steps"] >= 3 and row["recently_lost_frames"] == 0
    assert row["memory"]["first"]["frame"] == 0 and row["peak_rss_mb"] > 0
    assert row["kf_slots_recycled"] == row["kf_evicted"] == row["pts_evicted"] == 0
    json.dumps(row)
