"""PyTorch port: the public entry points default to the CUDA card, and on a
host without one they raise instead of running on the CPU. The defaults
are read through `inspect.signature`, so nothing here touches CUDA."""

import inspect
import os

import numpy as np
import pytest
import torch

from monoorbslam3_tpu_torch import bench_window, config, convert
from monoorbslam3_tpu_torch.backend.problems import Problems, _identity_edge
from monoorbslam3_tpu_torch.backend.residuals import KfState
from monoorbslam3_tpu_torch.models.camera import Fisheye, Pinhole
from monoorbslam3_tpu_torch.models.imu import ImuCalib
from monoorbslam3_tpu_torch.ops import vocab
from monoorbslam3_tpu_torch.ops.orb import OrbExtractor
from monoorbslam3_tpu_torch.system import System

TUM_VI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "settings", "tum_vi.yaml")
VOCAB_PROFILE = os.path.join(os.path.dirname(TUM_VI), "synthetic_vocab.yaml")
TOY_VOCAB = os.path.join(os.path.dirname(TUM_VI), "synthetic_voc.txt")
ENTRY_POINTS = {
    "OrbExtractor": OrbExtractor.__init__,
    "Pinhole.create": Pinhole.create,
    "Fisheye.create": Fisheye.create,
    "ImuCalib.create": ImuCalib.create,
    "config.build_camera": config.build_camera,
    "config.build_imu_calib": config.build_imu_calib,
    "bench_window.build_problem": bench_window.build_problem,
    "Problems": Problems.__init__,
    "System": System.__init__,
    "config.build_system": config.build_system,
    "config.build_vocabulary": config.build_vocabulary,
    "vocab.load_dbow2_text": vocab.load_dbow2_text,
    "Vocabulary.train": vocab.Vocabulary.train,
    "Vocabulary.from_numpy": vocab.Vocabulary.from_numpy,
    "convert.vocabulary": convert.vocabulary,
    **{f"convert.{n}": getattr(convert, n)
       for n in ("desc_to_torch", "tensor", "pinhole", "kf_state", "preint_edge", "ba_problem")},
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"].default
    assert default is not inspect.Parameter.empty
    assert torch.device(default) == torch.device("cuda")


@pytest.mark.parametrize("helper", [KfState.zeros, _identity_edge],
                         ids=["KfState.zeros", "_identity_edge"])
def test_internal_helpers_take_the_device_without_default(helper):
    assert inspect.signature(helper).parameters["device"].default is inspect.Parameter.empty


def test_entry_points_raise_without_a_card(monkeypatch):
    """Called without `device` where no card is present, each entry point
    raises; with device="cpu" it runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda **kw: OrbExtractor(64, 96, n_features=32, n_levels=2, **kw),
             lambda **kw: Pinhole.create(fx=100.0, fy=100.0, cx=48.0, cy=32.0,
                                         width=96, height=64, **kw),
             lambda **kw: bench_window.build_problem(n_kf=4, n_fixed=1, n_pts=8,
                                                     obs_per_kf=4, **kw),
             lambda **kw: convert.tensor(np.zeros(3, np.float32), **kw),
             lambda **kw: convert.desc_to_torch(np.zeros((2, 8), np.uint32), **kw),
             lambda **kw: Fisheye.create(fx=100.0, fy=100.0, cx=48.0, cy=32.0,
                                         dist=[0.0, 0.0, 0.0, 0.0], width=96, height=64, **kw),
             lambda **kw: ImuCalib.create(np.eye(3), np.zeros(3), 1e-4, 1e-3, 1e-5, 1e-3, **kw),
             lambda **kw: config.build_camera(config.load_settings(TUM_VI), **kw),
             lambda **kw: config.build_imu_calib(config.load_settings(TUM_VI), **kw),
             lambda **kw: Problems(
                 Pinhole.create(fx=100.0, fy=100.0, cx=48.0, cy=32.0, width=96, height=64,
                                device="cpu"),
                 ImuCalib.create(np.eye(3), np.zeros(3), 1e-4, 1e-3, 1e-5, 1e-3, device="cpu"),
                 **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
        call(device="cpu")


def test_tracker_and_mapper_run_on_the_facades_device(monkeypatch):
    """`Tracking` and `LocalMapping` take no device of their own: they run
    on `problems.device`, the card unless the caller built the façade on the
    CPU. Without a card the default façade raises, so neither can be built
    on the card; on a CPU façade both live on the CPU, and the tracker's
    RANSAC draws (from its host key, the JAX package's) go up to it. The
    two-view functions follow their inputs' device."""
    from monoorbslam3_tpu_torch.backend.problems import upload_inputs
    from monoorbslam3_tpu_torch.frontend.local_mapping import LocalMapping
    from monoorbslam3_tpu_torch.frontend.tracking import Tracking
    from monoorbslam3_tpu_torch.models.map_state import MapStore
    from monoorbslam3_tpu_torch.ops import twoview
    from monoorbslam3_tpu_torch.utils import prng

    for cls in (Tracking, LocalMapping):
        assert "device" not in inspect.signature(cls.__init__).parameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Pinhole.create(fx=100.0, fy=100.0, cx=48.0, cy=32.0, width=96, height=64,
                         device="cpu")
    calib = ImuCalib.create(np.eye(3), np.zeros(3), 1e-4, 1e-3, 1e-5, 1e-3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Problems(cam, calib)
    problems = Problems(cam, calib, device="cpu")
    tracker = Tracking(cam, calib, MapStore(max_kf=4, max_pt=16, n_feat=8), problems)
    mapper = LocalMapping(tracker.store, problems, calib, tracker)
    assert tracker.device == mapper.device == problems.device == torch.device("cpu")
    # the RANSAC key is the JAX package's, on the host; the draws go up
    # with the pair to the tracker's device
    assert isinstance(tracker._ransac_key, np.ndarray)
    np.testing.assert_array_equal(tracker._ransac_key, prng.prng_key(0))
    valid = np.ones(16, bool)
    _, sub = prng.split(tracker._ransac_key)
    valid_t, idx_t = upload_inputs((valid, twoview.draw_samples(sub, valid, 4)), tracker.device)
    assert idx_t.device == valid_t.device == tracker.device and idx_t.shape == (4, 8)


def test_system_entry_points_raise_without_a_card(monkeypatch):
    """`System`, `build_system`, `build_vocabulary`, the vocabulary loader
    and `convert.vocabulary` raise without `device` where no card is
    present; with device="cpu" they build on the CPU."""
    from types import SimpleNamespace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Pinhole.create(fx=100.0, fy=100.0, cx=48.0, cy=32.0, width=96, height=64,
                         device="cpu")
    calib = ImuCalib.create(np.eye(3), np.zeros(3), 1e-4, 1e-3, 1e-5, 1e-3, device="cpu")
    toy = vocab.load_dbow2_text(TOY_VOCAB, device="cpu")
    nd, idf = toy.host_tables()
    jax_like = SimpleNamespace(k=toy.k, levels=toy.levels, node_desc=nd,
                               level_offset=toy.level_offset, word_idf=idf,
                               group_level=toy.group_level)
    settings = config.load_settings(VOCAB_PROFILE)
    calls = [lambda **kw: System(cam, calib, config={"n_features": 16}, **kw),
             lambda **kw: config.build_system(VOCAB_PROFILE, use_extractor=False, **kw),
             lambda **kw: config.build_vocabulary(settings, base_dir=os.path.dirname(TUM_VI),
                                                  **kw),
             lambda **kw: vocab.load_dbow2_text(TOY_VOCAB, **kw),
             lambda **kw: convert.vocabulary(jax_like, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
        out = call(device="cpu")
        dev = out.device if hasattr(out, "device") else out.node_desc.device
        assert dev == torch.device("cpu")
