"""PyTorch port: the multi-rank entry points on the CPU, over gloo.

- `graft_entry.dryrun_multichip(2, "cpu")` (two spawned ranks) runs the
  JAX script's three checks, and its sharded costs (the distributed BA
  step and the live mapper BA through `Problems(mesh=)`) are within 2e-3
  of `__graft_entry__.dryrun_multichip(2)`'s on two of the CPU's virtual
  devices (read by spies on the JAX functions it calls), the same on every
  rank.
- `measure.bench_scaling` at one and two ranks with `--profile`'s split,
  on a small window: every line and key of the JAX script, a sharded BA
  that lowers its cost at two ranks (the window's observation 0 sees a
  point of the second shard: the case `sharded_schur_ba`'s clamp of an
  empty slot's point index covers), and the summary's efficiency.
"""

import numpy as np
import pytest

import __graft_entry__ as jge
from monoorbslam3_tpu.backend import problems as jproblems
from monoorbslam3_tpu.parallel import sharded_ba as jsb
from monoorbslam3_tpu_torch import bench_window, graft_entry
from monoorbslam3_tpu_torch.measure import bench_scaling
from monoorbslam3_tpu_torch.parallel import sharded_ba as tsb

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

SMALL_BA = dict(n_kf=8, n_fixed=2, n_pts=256, obs_per_kf=48)
SMALL_FRONTEND = dict(frames_per_rank=1, h=96, w=128, n_features=64)


def test_dryrun_multichip_matches_jax(monkeypatch):
    seen = {}
    inner = jsb.sharded_schur_ba

    def sharded(*a, **k):
        out = inner(*a, **k)
        seen.setdefault("sharded", out[2])
        return out

    inner_live = jproblems.Problems.local_full_bundle_adjustment

    def live(self, *a, **k):
        out = inner_live(self, *a, **k)
        seen["live"] = out
        return out

    monkeypatch.setattr(jsb, "sharded_schur_ba", sharded)
    monkeypatch.setattr(jproblems.Problems, "local_full_bundle_adjustment", live)
    jge.dryrun_multichip(2)
    ranks = graft_entry.dryrun_multichip(2, "cpu")
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["ranks"] == 2 and r["dropped"] == 0 and r["extracted_frames"] == 2
        assert r["sharded_points_finite"]
        for key in ("sharded_cost0", "sharded_cost", "live_cost0", "live_cost"):
            assert r[key] == ranks[0][key], key
    for key, ref in (("sharded_cost0", seen["sharded"]["cost0"]),
                     ("sharded_cost", seen["sharded"]["cost"]),
                     ("live_cost0", seen["live"]["cost0"]), ("live_cost", seen["live"]["cost"])):
        np.testing.assert_allclose(ranks[0][key], float(ref), rtol=2e-3, err_msg=key)


def test_small_window_puts_observation_0_in_the_second_shard():
    """The bench_scaling test below must meet an empty slot whose point
    lies in another shard."""
    problem, _ = bench_window.build_problem(seed=0, device="cpu", **SMALL_BA)
    order, keep = tsb.shard_order(problem.obs_pt.numpy(), problem.obs_valid.numpy(),
                                  SMALL_BA["n_pts"], 2)
    per_obs = len(order) // 2
    assert int(problem.obs_pt[0]) >= SMALL_BA["n_pts"] // 2
    assert not keep[:per_obs].all()


@pytest.fixture(scope="module")
def scaling_lines():
    return bench_scaling.scaling([1, 2], "cpu", profile=True, ba_window=SMALL_BA,
                                 frontend=SMALL_FRONTEND, reps=2, log=lambda line: None)


def test_scaling_lines(scaling_lines):
    metrics = [(ln["metric"], ln.get("n_devices")) for ln in scaling_lines]
    assert metrics == [("sharded_ba_iters_per_s", 1), ("sharded_ba_iters_per_s", 2),
                       ("frontend_dp_fps", 1), ("frontend_dp_fps", 2),
                       ("frontend_dp_scaling_efficiency", 2)]
    for ln in scaling_lines:
        assert ln["device"]["platform"] == "cpu"


@pytest.mark.parametrize("kind", ["ba", "frontend"])
def test_scaling_profile(scaling_lines, kind):
    rows = [ln for ln in scaling_lines if ln.get("kind") == kind]
    assert [r["efficiency"] for r in rows][0] == 1.0
    for r in rows:
        assert r["value"] > 0 and r["unit"] == ("iters/s" if kind == "ba" else "frames/s")
        for part in ("mesh", "shard1", "replica"):
            t = r[part]
            assert t["n"] == 2 and 0 < t["q25_s"] <= t["median_s"] <= t["q75_s"]
        assert r["host_contention_s"] == pytest.approx(
            r["replica"]["median_s"] - r["shard1"]["median_s"])
        assert r["collective_s"] == pytest.approx(r["mesh"]["median_s"] - r["replica"]["median_s"])
        assert 0 < r["cpu_util_during_mesh"] <= 1.0


def test_scaling_summary(scaling_lines):
    summary = scaling_lines[-1]
    fps2 = scaling_lines[3]
    assert summary["value"] == fps2["efficiency"]
    assert summary["vs_baseline"] == pytest.approx(fps2["efficiency"] / 0.75)
