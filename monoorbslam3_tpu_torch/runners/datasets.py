"""Dataset loaders, the sequence runner and the command line (counterpart
of `monoorbslam3_tpu/runners/datasets.py`).

The analog of the reference's demo binaries and loaders
(test/Data.h:14-49, test/eurocDemo.cpp, kittiDemo.cpp, phoneDemo.cpp,
ntuDemo.cpp, rectDemo.cpp, demo.cpp): each dataset's folder layout is
parsed into one stream of (timestamp, image, IMU rows) and fed through a
`System`, with optional real-time pacing (eurocDemo.cpp:60-70) and the
export surface at shutdown. The loaders are host code: images are decoded
by the native loader (`native.ImagePrefetcher`: C++ threads decode ahead
of the tracker), with PIL or cv2 for what it does not decode, and the
System uploads each frame to its device.

IMU text format (all datasets, after the reference's prep scripts):
`t gx gy gz ax ay az` per line; times.txt: one image timestamp per line.

    python -m monoorbslam3_tpu_torch.runners.datasets euroc SETTINGS DATA OUT [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np

from .. import native


def _load_gray(path: str) -> np.ndarray:
    img = native.load_gray(path)  # C++ decoder (zlib PNG / PNM)
    if img is not None:
        return img
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.float32)


def load_times(path: str) -> np.ndarray:
    """times.txt loader (Data.h:14-27)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(float(line.split()[0]))
    return np.asarray(out)


def load_imu(path: str) -> np.ndarray:
    """imu.txt loader (Data.h:29-49): rows (t, gx, gy, gz, ax, ay, az),
    strictly increasing timestamps."""
    rows_native = native.parse_imu(path)
    if rows_native is not None:
        return rows_native
    rows = []
    last_t = -np.inf
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 7:
                t = float(parts[0])
                if t > last_t:
                    last_t = t
                    rows.append([t] + [float(x) for x in parts[1:7]])
    return np.asarray(rows)


def _imu_between(imu: np.ndarray, start: int, t: float):
    """(rows of `imu` from `start` with time <= t, or None; the next start)."""
    j = start
    while j < len(imu) and imu[j, 0] <= t:
        j += 1
    rows = imu[start:j] if len(imu) else None
    return (rows if rows is None or len(rows) else None), j


class ImageFolderDataset:
    """Common layout: <times_file> + numbered images + imu.txt."""

    def __init__(self, root: str, times_rel: str, image_dir_rel: str,
                 image_pattern: str, imu_rel: str = "imu.txt"):
        self.root = root
        self.times = load_times(os.path.join(root, times_rel))
        self.image_dir = os.path.join(root, image_dir_rel)
        self.image_pattern = image_pattern
        self.imu = load_imu(os.path.join(root, imu_rel))
        self.prefetcher = None

    def __len__(self):
        return len(self.times)

    def frames(self):
        """Yields (t, image [H, W] float32, imu_rows [n, 7] in (prev_t, t]
        or None). The images stream through the native prefetcher, so the
        decode overlaps the tracking step (the reference decodes on the
        tracking thread, eurocDemo.cpp:58); `self.prefetcher` is the
        stream's, for its `wait_s`."""
        paths = [os.path.join(self.image_dir, self.image_pattern % i)
                 for i in range(len(self.times))]
        self.prefetcher = native.ImagePrefetcher(paths, _load_gray)
        imu_idx = 0
        for t, img in zip(self.times, self.prefetcher):
            rows, imu_idx = _imu_between(self.imu, imu_idx, t)
            yield t, img, rows


def euroc_dataset(root: str) -> ImageFolderDataset:
    """EuRoC layout (eurocDemo.cpp:14-40): cam0/times.txt,
    cam0/data/%08d.png, imu.txt."""
    return ImageFolderDataset(root, "cam0/times.txt", "cam0/data", "%08d.png")


def kitti_dataset(root: str) -> ImageFolderDataset:
    """KITTI raw layout (kittiDemo.cpp:14-40): image_00/times.txt,
    image_00/data/%010d.png, oxts/imu.txt."""
    return ImageFolderDataset(root, "image_00/times.txt", "image_00/data",
                              "%010d.png", imu_rel="oxts/imu.txt")


def tumvi_dataset(root: str) -> ImageFolderDataset:
    """Rectified TUM-VI layout (rectDemo.cpp): cam0/times.txt,
    cam0/data/%08d.png, imu.txt."""
    return ImageFolderDataset(root, "cam0/times.txt", "cam0/data", "%08d.png")


class VideoDataset:
    """Phone layout (phoneDemo.cpp:14-40): video.mp4 + times.txt + imu.txt,
    decoded by cv2."""

    def __init__(self, root: str):
        import cv2

        self.cap = cv2.VideoCapture(os.path.join(root, "video.mp4"))
        self.times = load_times(os.path.join(root, "times.txt"))
        self.imu = load_imu(os.path.join(root, "imu.txt"))

    def __len__(self):
        return len(self.times)

    def frames(self):
        import cv2

        imu_idx = 0
        for t in self.times:
            ok, frame = self.cap.read()
            if not ok:
                return
            img = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)
            rows, imu_idx = _imu_between(self.imu, imu_idx, t)
            yield t, img, rows


def run_sequence(system, dataset, realtime_fps: float | None = None,
                 max_frames: int | None = None, progress_every: int = 100, log=print):
    """Drive a System over a dataset (the demo main loop,
    eurocDemo.cpp:44-74). Returns the per-frame states."""
    if realtime_fps:
        # real-time pacing cannot absorb a first use mid-stream
        log("warmup: the first call of every device path...")
        system.warmup()
    states = []
    t_start = time.perf_counter()
    for i, (t, img, imu) in enumerate(dataset.frames()):
        if max_frames is not None and i >= max_frames:
            break
        step_start = time.perf_counter()
        state = system.track(t, img, imu)
        states.append(state)
        if realtime_fps:
            budget = 1.0 / realtime_fps
            spent = time.perf_counter() - step_start
            if spent < budget:
                time.sleep(budget - spent)
        if progress_every and i % progress_every == 0:
            log(f"frame {i}: t={t:.2f} state={state} "
                f"kf={system.store.n_keyframes()} pts={system.store.n_points()}")
    wall = time.perf_counter() - t_start
    n = len(states)
    log(f"done: {n} frames in {wall:.1f}s ({n / max(wall, 1e-9):.1f} fps)")
    return np.asarray(states)


def main(argv=None):
    """The command line (the demo binaries): dataset kind, settings, data
    directory, output trajectory; `--device` picks the device (the card by
    default)."""
    import argparse

    from ..config import build_system

    p = argparse.ArgumentParser(description="mono-inertial SLAM runner (PyTorch/CUDA)")
    p.add_argument("kind", choices=["euroc", "kitti", "tumvi", "phone", "synthetic"])
    p.add_argument("settings")
    p.add_argument("data_dir",
                   help="dataset folder; for kind=synthetic a world spec like "
                        "'circle:t_end=60,fps=20' (circle|noisy|fastspin|lowtex|corridor)")
    p.add_argument("out_trajectory")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--gt-out", default=None,
                   help="kind=synthetic: write the ground-truth camera trajectory (TUM) "
                        "here for ATE evaluation")
    p.add_argument("--velocity-out", default=None)
    p.add_argument("--map-out", default=None)
    p.add_argument("--depth-out", default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--realtime", action="store_true")
    p.add_argument("--vocab", default=None,
                   help="DBoW2 text vocabulary (the ORBvoc.txt argument of the reference "
                        "demos); enables BoW-gated matching")
    p.add_argument("--viewer-dir", default=None,
                   help="run the live viewer thread: renders tracked frames and map "
                        "snapshots as PNGs into this directory (the headless analog of "
                        "the reference's Pangolin window)")
    p.add_argument("--save-state", default=None,
                   help="checkpoint the session (map + tracker/mapper state) to this npz "
                        "at shutdown")
    p.add_argument("--load-state", default=None,
                   help="resume from a --save-state checkpoint before streaming frames")
    args = p.parse_args(argv)

    system = build_system(args.settings, vocab_path=args.vocab, viewer_dir=args.viewer_dir,
                          device=args.device)
    if args.load_state:
        system.load_state(args.load_state)
    if args.kind == "synthetic":
        from .synth import SyntheticDataset

        dataset = SyntheticDataset(args.data_dir, system.camera, system.calib)
        if args.gt_out:
            dataset.save_ground_truth(args.gt_out)
    else:
        loaders = {"euroc": euroc_dataset, "kitti": kitti_dataset,
                   "tumvi": tumvi_dataset, "phone": VideoDataset}
        dataset = loaders[args.kind](args.data_dir)
    fps = None
    if args.realtime:
        fps = float(load_settings_fps(args.settings))
    run_sequence(system, dataset, realtime_fps=fps, max_frames=args.max_frames)
    system.shutdown()
    if args.save_state:
        system.save_state(args.save_state)
    system.save_keyframe_trajectory(args.out_trajectory)
    if args.velocity_out:
        system.save_velocity_and_bias(args.velocity_out)
    if args.map_out:
        system.save_point_cloud(args.map_out)
    if args.depth_out:
        system.save_keyframe_depth(args.depth_out)
    return system


def load_settings_fps(settings_path: str) -> float:
    from ..config import load_settings

    return float(load_settings(settings_path)["Camera"].get("fps", 20))


if __name__ == "__main__":
    main()
