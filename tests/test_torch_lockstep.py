"""PyTorch port: a live port `System` in lock step with the JAX package's
`System` of the same seed, on the CPU, with no injection of draws.

Both run tests/test_torch_system.py's feature-injection world and
configuration (tests/test_e2e_synthetic.py's: 256 features, the circle
trajectory, IMU at 200 Hz) over its first FRAMES frames, at the tracker's
seeds 0 and 1, each recorded by experiments/port_lockstep_jax.py's
`Recorder`. The port draws the JAX package's RANSAC samples
(`utils/prng.py`), so the two runs are one run up to rounding:

- every bootstrap attempt is the same, with identical [200, 8] sample
  indices (a spy on each package's `reconstruct_two_views`);
- the tracking state is equal on every frame;
- the keyframe counts are never more than 1 apart, and equal at the end;
- the inertial init happens at the same frame;
- the positions stay within 1% of the distance travelled since the first
  keyframe (measured: at most 0.41% at seed 0, frame 15, and 0.017% at
  seed 1, frame 12, both before the init; the init at frame 46 in both,
  its cost 67.85 -> 62.63 in both and its scale 3.339 against 3.353 at
  seed 0, 3.3913 against 3.3910 at seed 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from experiments.port_lockstep_jax import POS_RTOL, Recorder, first_parting, travelled
from monoorbslam3_tpu import sim as jsim
from monoorbslam3_tpu.frontend import tracking as jtr
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.models.imu import ImuCalib as JCalib
from monoorbslam3_tpu.system import System as JSystem
from monoorbslam3_tpu_torch import sim as tsim
from monoorbslam3_tpu_torch.frontend import tracking as ttr
from monoorbslam3_tpu_torch.models.camera import Pinhole
from monoorbslam3_tpu_torch.models.imu import ImuCalib
from monoorbslam3_tpu_torch.system import System

from tests.test_torch_tracking import (CAM, CONFIG, NOISE, R_BC, T_BC, _stream,
                                      one_torch_thread)  # noqa: F401  (autouse)

FRAMES = 50
SEEDS = (0, 1)


def _jax_run(seed, draws):
    cam = JPinhole.create(**CAM)
    syst = JSystem(cam, JCalib.create(R_bc=R_BC, t_bc=T_BC, **NOISE),
                   config=dict(CONFIG, seed=seed))
    rec = Recorder(syst, entry="track_features")
    inner = jtr.reconstruct_two_views

    def spy(xy1, xy2, valid, K, key, *a, **kw):
        w = np.asarray(valid, np.float32)
        probs = jnp.asarray(w / max(w.sum(), 1.0))
        draws.append(np.asarray(jax.random.choice(key, len(w), shape=(200, 8), p=probs)))
        return inner(xy1, xy2, valid, K, key, *a, **kw)

    jtr.reconstruct_two_views = spy
    try:
        for t, feats, imu, _ in _stream(jsim, cam, FRAMES):
            syst.track_features(t, feats, imu)
    finally:
        jtr.reconstruct_two_views = inner
    syst.shutdown()
    return rec.record()


def _port_run(seed, draws):
    cam = Pinhole.create(**CAM, device="cpu")
    syst = System(cam, ImuCalib.create(R_bc=R_BC, t_bc=T_BC, **NOISE, device="cpu"),
                  config=dict(CONFIG, seed=seed), device="cpu")
    rec = Recorder(syst, entry="track_features")
    inner = ttr.reconstruct_two_views

    def spy(xy1, xy2, valid, K, sample_idx, *a, **kw):
        draws.append(sample_idx.cpu().numpy())
        return inner(xy1, xy2, valid, K, sample_idx, *a, **kw)

    ttr.reconstruct_two_views = spy
    try:
        for t, feats, imu, _ in _stream(tsim, cam, FRAMES):
            syst.track_features(t, feats, imu)
    finally:
        ttr.reconstruct_two_views = inner
    syst.shutdown()
    return rec.record()


@pytest.fixture(scope="module", params=SEEDS, ids=[f"seed{s}" for s in SEEDS])
def pair(request):
    draws = {"jax": [], "port": []}
    ref = _jax_run(request.param, draws["jax"])
    port = _port_run(request.param, draws["port"])
    return dict(jax=ref, port=port, draws=draws)


def test_the_same_bootstrap_attempts_from_the_same_samples(pair):
    dj, dp = pair["draws"]["jax"], pair["draws"]["port"]
    assert len(dj) == len(dp) >= 1
    for a, b in zip(dj, dp):
        np.testing.assert_array_equal(b, a)
    boot = [next(r["frame"] for r in rec["frames"] if r["state"] == 2)
            for rec in (pair["jax"], pair["port"])]
    assert boot[0] == boot[1]


def test_states_and_keyframes_in_lock_step(pair):
    fj, fp = pair["jax"]["frames"], pair["port"]["frames"]
    assert len(fj) == len(fp) == FRAMES
    assert [r["state"] for r in fp] == [r["state"] for r in fj]
    gaps = [abs(a["n_kf"] - b["n_kf"]) for a, b in zip(fj, fp)]
    assert max(gaps) <= 1 and gaps[-1] == 0, gaps
    assert first_parting(pair["jax"], pair["port"]) is None


def test_inertial_init_at_the_same_frame(pair):
    init = [next((r["frame"] for r in rec["frames"] if r["imu_state"] >= 1), None)
            for rec in (pair["jax"], pair["port"])]
    assert init[0] is not None and init[0] == init[1], init


def test_positions_within_a_percent_of_the_distance(pair):
    fj, fp = pair["jax"]["frames"], pair["port"]["frames"]
    worst = 0.0
    for a, b, d in zip(fj, fp, travelled(fj)):
        if a["pos"] is None or b["pos"] is None or not d:
            continue
        gap = float(np.linalg.norm(np.asarray(a["pos"]) - np.asarray(b["pos"])))
        worst = max(worst, gap / d)
    print(f"largest position gap over the distance travelled: {worst:.5f}")
    assert worst <= POS_RTOL
