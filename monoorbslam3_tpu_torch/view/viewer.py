"""Live viewer thread, the reference Viewer without a window (counterpart
of `monoorbslam3_tpu/view/viewer.py`).

The analog of the reference's Pangolin render thread
(modules/View/Viewer.cpp:13-197): a daemon thread that wakes at the
viewer's rate, takes the latest tracked frame (FrameDrawer::Update,
FrameDrawer.cpp:111-139) and a snapshot of the map, renders both with the
offline drawers and writes PNGs into a directory. The reference's control
protocol:

- `update_frame`                            <- FrameDrawer::Update (mutex snapshot)
- `request_stop` / `is_stopped` / `release` <- the reset handshake
  (Viewer.cpp:165-196; the reset parks the viewer while the map is cleared)
- `request_finish` / `is_finished` / `join`  <- System::ShutDown (Viewer.cpp:146-163)

The thread touches host numpy only: the frame's arrays that the tracker
has already fetched, and the map store's arrays, copied under `map_lock`
(the System's map lock) and drawn outside it, so a render never holds the
tracker or the mapper back and never waits for the device.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import nullcontext

import numpy as np

from .visualizer import draw_frame, draw_map_snapshot, host_extrinsics, map_snapshot


class Viewer:
    def __init__(self, store, calib, out_dir: str, fps: float = 2.0, map_every: int = 5,
                 map_lock=None):
        self.store = store
        self._R_cb, self._t_cb = host_extrinsics(calib)
        self.map_lock = map_lock if map_lock is not None else nullcontext()
        self.out_dir = out_dir
        self.period = 1.0 / max(fps, 0.1)
        self.map_every = max(1, map_every)
        os.makedirs(out_dir, exist_ok=True)

        self._lock = threading.Lock()
        self._snapshot = None  # (image, xy, tracked, text)
        self._dirty = False
        self._stop_requested = False
        self._stopped = False
        self._finish_requested = False
        self._finished = False
        self._n_rendered = 0
        self.last_error: Exception | None = None
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    # -- FrameDrawer::Update analog --------------------------------------

    def update_frame(self, image, xy, tracked, state_text: str = ""):
        """Hands the viewer a frame: host arrays only (`image` may be None)."""
        with self._lock:
            self._snapshot = (None if image is None else np.asarray(image),
                              np.asarray(xy).copy(), np.asarray(tracked).copy(), state_text)
            self._dirty = True

    # -- render loop (Viewer::Run) ----------------------------------------

    def run(self):
        while not self._finish_requested:
            t0 = time.time()
            if self._stop_requested:
                self._stopped = True
                time.sleep(0.005)
                continue
            self._stopped = False
            snap = None
            with self._lock:
                if self._dirty:
                    snap = self._snapshot
                    self._dirty = False
            if snap is not None:
                self._render(snap)
            dt = time.time() - t0
            time.sleep(max(self.period - dt, 0.002))
        self._finished = True

    def _render(self, snap):
        image, xy, tracked, text = snap
        i = self._n_rendered
        try:
            if image is not None:
                fig = draw_frame(image, xy, tracked, text)
                fig.savefig(os.path.join(self.out_dir, f"frame_{i:06d}.png"))
                _close(fig)
            if i % self.map_every == 0:
                with self.map_lock:  # copy under the lock, draw outside it
                    mp = (map_snapshot(self.store, self._R_cb, self._t_cb)
                          if self.store.n_keyframes() >= 2 else None)
                if mp is not None:
                    fig = draw_map_snapshot(mp)
                    fig.savefig(os.path.join(self.out_dir, f"map_{i:06d}.png"))
                    _close(fig)
        except Exception as e:  # noqa: BLE001
            # a render must never take the pipeline down (the reference's GL
            # thread cannot either): drop the frame, keep the error
            self.last_error = e
        # incremented last: callers poll _n_rendered as "files are on disk"
        self._n_rendered = i + 1

    # -- stop/release handshake (reset) -----------------------------------

    def request_stop(self):
        self._stop_requested = True

    def is_stopped(self) -> bool:
        return self._stopped

    def release(self):
        self._stop_requested = False

    # -- finish handshake (shutdown) ---------------------------------------

    def request_finish(self):
        self._finish_requested = True

    def is_finished(self) -> bool:
        return self._finished

    def join(self, timeout: float = 5.0):
        self.request_finish()
        self._thread.join(timeout=timeout)


def _close(fig):
    import matplotlib.pyplot as plt

    plt.close(fig)
