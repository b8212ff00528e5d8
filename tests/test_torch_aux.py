"""PyTorch port: the host-side tools around the device paths, against the
JAX package's on the same inputs (tests/test_aux.py's counterparts).

- `utils/logging.SlamLogger`: the three streams, the JSONL events and the
  stage timers, in both packages.
- `view/visualizer.py`: the three figures, and the map snapshot the viewer
  draws from; `view/viewer.Viewer`: renders at its rate, takes its map
  snapshot under the map lock, honours the stop/release (reset) and finish
  (shutdown) handshakes.
- `System(viewer_dir=)` over tests/test_e2e_synthetic.py's feature-injection
  world: the viewer writes map PNGs and parks while a reset clears the map.
- `evaluation/plots.main` (the comparison CLI) and `runners/prep_kitti`
  give the JAX package's numbers and files.
- `runners/train_vocab` on a tiny corpus: the same harvested documents,
  tree, idf and DBoW2 text as the JAX package's trainer.
- `runners/validation`: the world table of run_validation.py, and its JSON
  and Markdown schema on a short world.
- `runners.datasets.VideoDataset` (cv2) gives the JAX package's frames.
"""

import gzip
import json
import os
import threading
import time

import numpy as np
import pytest

import run_validation
from monoorbslam3_tpu.evaluation import plots as jplots
from monoorbslam3_tpu.runners import prep_kitti as jprep
from monoorbslam3_tpu.utils.logging import SlamLogger as JLogger
from monoorbslam3_tpu_torch.evaluation import plots as tplots
from monoorbslam3_tpu_torch.models.imu import ImuBuffer, ImuCalib
from monoorbslam3_tpu_torch.models.map_state import MapStore
from monoorbslam3_tpu_torch.runners import prep_kitti as tprep
from monoorbslam3_tpu_torch.runners import validation
from monoorbslam3_tpu_torch.utils.logging import NULL_LOGGER, SlamLogger
from monoorbslam3_tpu_torch.view import visualizer
from monoorbslam3_tpu_torch.view.viewer import Viewer

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(17)


def _populated_store():
    store = MapStore(max_kf=16, max_pt=64, n_feat=32, max_obs=8)
    feats = {
        "xy": RNG.uniform(0, 100, (32, 2)).astype(np.float32),
        "level": np.zeros(32, np.int32),
        "angle": np.zeros(32, np.float32),
        "desc": RNG.integers(0, 2**32, (32, 8), dtype=np.uint32),
        "valid": np.ones(32, bool),
    }
    z = np.zeros(3, np.float32)
    k0 = store.add_keyframe(1.0, np.eye(3), z, z, z, z, feats)
    k1 = store.add_keyframe(1.5, np.eye(3), np.array([1, 0, 0], np.float32), z, z, z, feats)
    for i in range(10):
        p = store.add_point(RNG.normal(size=3), feats["desc"][i], k0)
        store.add_observation(p, k0, i)
        store.add_observation(p, k1, i)
    buf = ImuBuffer()
    for _ in range(20):
        buf.add(RNG.normal(size=3), RNG.normal(size=3), 0.005)
    store.kf_imu[k0] = buf
    return store


def _calib():
    return ImuCalib.create(R_bc=np.eye(3), t_bc=np.zeros(3), noise_gyro=1e-4, noise_acc=1e-3,
                           walk_gyro=1e-5, walk_acc=1e-4, device="cpu")


def test_logger_streams_and_timers(tmp_path):
    for cls, d in ((SlamLogger, tmp_path / "port"), (JLogger, tmp_path / "jax")):
        log = cls(str(d))
        log.tick()
        log.write("tracker", "hello", n=3)
        with log.stage("match"):
            pass
        log.close()
        assert "hello" in (d / "tracker.log").read_text()
        assert "match" in (d / "events.jsonl").read_text()
        summary = log.timing_summary()
        assert "match" in summary and summary["match"]["n"] == 1
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in ("initial.log", "mapper.log"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    first = [json.loads(line) for line in (tmp_path / "port" / "events.jsonl").open()][0]
    assert first == {"iter": 1, "stream": "tracker", "msg": "hello", "n": 3}
    assert not NULL_LOGGER.enabled


def test_visualizer_figures(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    store, calib = _populated_store(), _calib()
    img = RNG.uniform(0, 255, (120, 160))
    xy = RNG.uniform(0, 100, (20, 2))
    figs = (visualizer.draw_frame(img, xy, xy[:, 0] > 50, "OK: 10 pts"),
            visualizer.draw_map(store, calib),
            visualizer.draw_trajectory([0, 1], np.array([[0, 0, 0], [1, 0, 0]])))
    for i, fig in enumerate(figs):
        fig.savefig(tmp_path / f"fig{i}.png")
        assert (tmp_path / f"fig{i}.png").stat().st_size > 0
    snap = visualizer.map_snapshot(store, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    np.testing.assert_array_equal(snap["points"], store.pt_xyz[store.pt_valid])
    np.testing.assert_allclose(snap["centers"], [[0, 0, 0], [1, 0, 0]], atol=1e-6)
    assert snap["edges"] == [(0, 1), (1, 0)]


class _CountingLock:
    """An RLock that counts its acquisitions by thread."""

    def __init__(self):
        self._lock = threading.RLock()
        self.threads = set()

    def __enter__(self):
        self._lock.acquire()
        self.threads.add(threading.get_ident())

    def __exit__(self, *exc):
        self._lock.release()


def _wait(cond, timeout):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def test_live_viewer_thread(tmp_path):
    """Renders snapshots at its rate, copies the map under the map lock,
    honours the stop/release (reset) and finish (shutdown) handshakes
    (Viewer.cpp:146-196)."""
    import matplotlib

    matplotlib.use("Agg")
    lock = _CountingLock()
    v = Viewer(_populated_store(), _calib(), str(tmp_path), fps=20.0, map_every=1, map_lock=lock)
    img = RNG.uniform(0, 255, (120, 160))
    xy = RNG.uniform(0, 100, (32, 2)).astype(np.float32)
    tracked = xy[:, 0] > 50
    v.update_frame(img, xy, tracked, "OK")
    assert _wait(lambda: v._n_rendered >= 1, 5.0), "viewer never rendered"
    names = os.listdir(tmp_path)
    assert any(f.startswith("frame_") for f in names) and any(f.startswith("map_") for f in names)
    assert lock.threads == {v._thread.ident} and v.last_error is None

    v.request_stop()
    assert _wait(v.is_stopped, 2.0)
    n0 = v._n_rendered
    v.update_frame(img, xy, tracked, "STOPPED")
    time.sleep(0.2)
    assert v._n_rendered == n0, "viewer rendered while stopped"
    v.release()
    assert _wait(lambda: v._n_rendered > n0, 5.0), "viewer did not resume after release"
    v.join()
    assert v.is_finished() and not v._thread.is_alive()


def test_system_viewer_writes_maps_and_parks_on_reset(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from monoorbslam3_tpu_torch import sim as tsim
    from monoorbslam3_tpu_torch.frontend import tracking as T
    from tests.test_torch_system import _port_system
    from tests.test_torch_tracking import _stream

    out = tmp_path / "view"
    syst = _port_system(viewer_dir=str(out))
    syst.viewer.period = 0.02  # render every frame the test gives it
    states = [syst.track_features(t, feats, imu)
              for t, feats, imu, _ in _stream(tsim, syst.camera, 30)]
    assert (np.asarray(states) == T.OK).any()
    assert _wait(lambda: any(f.startswith("map_") for f in os.listdir(out)), 10.0)
    assert not any(f.startswith("frame_") for f in os.listdir(out))  # no image injected

    parked = []
    inner_reset = syst.store.reset

    def reset():
        parked.append(_wait(syst.viewer.is_stopped, 5.0))
        inner_reset()

    syst.store.reset = reset
    syst.request_reset()
    _, feats, _, _ = next(iter(_stream(tsim, syst.camera, 1)))
    syst.track_features(100.0, feats, None)
    assert parked == [True], "the viewer did not park while the map was cleared"
    assert not syst.viewer._stop_requested
    syst.shutdown()
    assert syst.viewer.is_finished() and syst.viewer.last_error is None


def _write_tum(path, tt, pp):
    rows = np.concatenate([tt[:, None], pp, np.tile([0, 0, 0, 1.0], (len(tt), 1))], 1)
    np.savetxt(path, rows, fmt="%.6f")


def test_plot_comparison_cli(tmp_path):
    """plot_results.py's analog: Sim(3)-aligns each estimate to the truth,
    reports ATE and scale, renders the overlay, saves the aligned
    trajectories; the same numbers as the JAX package's CLI."""
    t = np.arange(0.0, 10.0, 0.1)
    p_gt = np.stack([np.cos(t), np.sin(t), 0.1 * t], -1)
    gt = tmp_path / "gt.txt"
    _write_tum(gt, t, p_gt)
    ang = 0.4
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    p_a = (2.5 * (R @ p_gt.T)).T + np.array([3.0, -1.0, 0.5]) + RNG.normal(0, 1e-3, p_gt.shape)
    est_a = tmp_path / "ours.txt"
    _write_tum(est_a, t, p_a)
    est_b = tmp_path / "other.txt"
    _write_tum(est_b, t, p_gt + RNG.normal(0, 0.05, p_gt.shape))
    args = [str(gt), str(est_a), str(est_b), "--labels", "ours", "other"]
    by = dict(tplots.main(args + ["-o", str(tmp_path / "cmp.png"),
                                  "--save-aligned", str(tmp_path / "aligned")]))
    ref = dict(jplots.main(args + ["-o", str(tmp_path / "cmp_jax.png")]))
    assert by["ours"]["rmse"] < 0.01
    assert abs(by["ours"]["scale"] - 1 / 2.5) < 0.01
    assert 0.02 < by["other"]["rmse"] < 0.1
    for label in ("ours", "other"):
        assert by[label]["rmse"] == ref[label]["rmse"]
        assert by[label]["scale"] == ref[label]["scale"]
    assert (tmp_path / "cmp.png").stat().st_size > 0
    assert (tmp_path / "aligned" / "ours_aligned.txt").stat().st_size > 0


def test_kitti_prep_matches_jax(tmp_path):
    drive = tmp_path / "drive"
    (drive / "oxts" / "data").mkdir(parents=True)
    (drive / "image_00").mkdir(parents=True)
    ts_lines = [f"2011-09-26 13:02:2{i}.{i}00000000\n" for i in range(3)]
    (drive / "oxts" / "timestamps.txt").write_text("".join(ts_lines))
    (drive / "image_00" / "timestamps.txt").write_text("".join(ts_lines))
    for i in range(3):
        vals = [0.0] * 30
        vals[0:3] = [49.0, 8.4, 112.0]
        vals[11:14] = [0.1, 0.2, 9.8]
        vals[17:20] = [0.01, 0.02, 0.03]
        (drive / "oxts" / "data" / ("%010d.txt" % i)).write_text(" ".join(str(v) for v in vals))
    assert tprep.prepare_drive(str(drive), str(tmp_path / "out")) == (3, 3)
    jprep.prepare_drive(str(drive), str(tmp_path / "out_jax"))
    imu = np.loadtxt(tmp_path / "out" / "oxts" / "imu.txt")
    np.testing.assert_allclose(imu[0, 1:4], [0.01, 0.02, 0.03])
    np.testing.assert_allclose(imu[0, 4:7], [0.1, 0.2, 9.8])
    for rel in ("oxts/imu.txt", "oxts/gps.txt", "image_00/times.txt"):
        assert (tmp_path / "out" / rel).read_bytes() == (tmp_path / "out_jax" / rel).read_bytes()


def test_train_vocab_matches_jax(tmp_path, monkeypatch):
    """The trainer's whole CLI on a two-frame corpus (k=4, L=2). The port's
    harvest through its extractor gives the JAX package's documents (the
    same counts; descriptor bits within tests/test_torch_orb.py's 0.1%: a
    BRIEF comparison on its rounding boundary may flip, 1 bit of 49,152
    here); on the port's documents the JAX package's tree, idf and writer
    give the port's vocabulary file to the byte."""
    from monoorbslam3_tpu.ops.vocab import Vocabulary as JVocab
    from monoorbslam3_tpu.ops.vocab import save_dbow2_text as jsave
    from monoorbslam3_tpu.runners import train_vocab as jtrain
    from monoorbslam3_tpu_torch.runners import train_vocab as ttrain

    corpus = [("settings/synthetic.yaml", "circle:t_end=0.5,fps=4")]
    monkeypatch.setattr(ttrain, "CORPUS", corpus)
    out = tmp_path / "voc.txt.gz"
    ttrain.main(["--out", str(out), "--k", "4", "--levels", "2", "--group-level", "1",
                 "--device", "cpu"])
    docs_t = ttrain.harvest(corpus, device="cpu", log=lambda *a: None)
    docs_j = [np.asarray(d) for d in jtrain.harvest(corpus, log=lambda *a: None)]
    assert [len(d) for d in docs_t] == [len(d) for d in docs_j] and len(docs_t) == 2
    bits = lambda d: np.unpackbits(np.ascontiguousarray(d).view(np.uint8), axis=1)
    frac = (bits(np.concatenate(docs_t)) != bits(np.concatenate(docs_j))).mean()
    assert frac <= 1e-3, frac
    vocab = JVocab.train(np.concatenate(docs_t), k=4, levels=2, group_level=1, seed=0)
    vocab = vocab._replace(word_idf=jtrain.corpus_idf(vocab, docs_t, log=lambda *a: None))
    jsave(vocab, str(tmp_path / "voc_jax.txt.gz"))
    with gzip.open(out, "rb") as f, gzip.open(tmp_path / "voc_jax.txt.gz", "rb") as g:
        assert f.read() == g.read()


def test_validation_world_table_is_run_validations():
    assert validation.WORLDS == run_validation.WORLDS


RUN_VALIDATION_ROW = {"est", "gt", "frames", "ok_frames", "lost_events", "lost_at",
                      "n_keyframes", "kf_created_total", "imu_state", "wall_s", "name", "spec",
                      "ate_rmse", "scale_err", "path_len_m", "ate_pct_of_path", "matched",
                      "bound_ate", "bound_scale", "pass"}
# the port's fields beside them (runners/validation.run_world)
BATTERY_ROW = {"device", "warmup_s", "polishes", "kf_slots_recycled", "kf_evicted",
               "pt_evictions", "pts_evicted", "recently_lost_frames", "ref_kf_matches",
               "n_mapper_steps", "frame_ms", "mapper_ms", "memory", "peak_rss_mb", "launches",
               "kernel_builds_after_warmup"}


def test_validation_writes_run_validations_schema(tmp_path, monkeypatch):
    """A 0.3 s world through the battery runner on the CPU: the JSON row
    keys of run_validation.py:184-193 with the port's battery fields beside
    them, and its Markdown table."""
    monkeypatch.setitem(validation.WORLDS, "tiny", ("settings/synthetic.yaml",
                                                    "circle:t_end=0.3,fps=20", 0.8, 0.12))
    rows = validation.main(["--worlds", "tiny", "--device", "cpu", "--out-dir", str(tmp_path),
                            "--out-tag", "t"])
    assert len(rows) == 1 and set(rows[0]) == RUN_VALIDATION_ROW | BATTERY_ROW
    assert rows[0]["frames"] == 6 and rows[0]["pass"] is False
    with open(tmp_path / "VALIDATION_t.json") as f:
        assert set(json.load(f)[0]) == RUN_VALIDATION_ROW | BATTERY_ROW
    md = (tmp_path / "VALIDATION.md").read_text().splitlines()
    assert md[0] == "# Scale-stress validation battery"
    assert md[4].startswith("| world | spec | frames | tracked | lost | KFs (created) | ATE RMSE")
    assert md[6].startswith("| tiny | `circle:t_end=0.3,fps=20` | 6 |")


def test_video_dataset_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from monoorbslam3_tpu.runners.datasets import VideoDataset as JVideo
    from monoorbslam3_tpu_torch.runners.datasets import VideoDataset as TVideo

    w = cv2.VideoWriter(str(tmp_path / "video.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    for i in range(5):
        w.write(np.full((48, 64, 3), 40 * i, np.uint8))
    w.release()
    times = np.arange(5) / 10.0
    (tmp_path / "times.txt").write_text("".join(f"{t:.6f}\n" for t in times))
    ts = np.arange(0.0, 0.45, 0.005)
    (tmp_path / "imu.txt").write_text("".join(f"{t:.6f} 0 0 0 0 0 9.8\n" for t in ts))
    got = list(TVideo(str(tmp_path)).frames())
    want = list(JVideo(str(tmp_path)).frames())
    assert len(got) == len(want) == 5
    for (tt, it, mt), (tj, ij, mj) in zip(got, want):
        assert tt == tj and it.shape == (48, 64) and it.dtype == np.float32
        np.testing.assert_array_equal(it, ij)
        assert (mt is None) == (mj is None)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)
