"""Structured per-stage logging, the reference Logger analog (the port's
copy of `monoorbslam3_tpu/utils/logging.py`).

The reference keeps three global file loggers (initial/mapper/tracker)
with a shared frame-iteration counter, writing to a HARDCODED absolute
path (modules/Log/Logger.cpp:12-17 — a portability bug the survey flags;
we use a configurable relative directory instead). Same three streams,
plus machine-readable JSONL for offline analysis and a `stage` timer used
as the profiling hook (SURVEY.md §5 tracing)."""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


class SlamLogger:
    """Three named streams + frame counter + stage timers."""

    STREAMS = ("initial", "tracker", "mapper")

    def __init__(self, log_dir: str | None = None, enabled: bool = True):
        self.enabled = enabled and log_dir is not None
        self.iterate = 0  # the reference's Logger::iterate frame counter
        self._files = {}
        self._timings: dict[str, list] = {}
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            for name in self.STREAMS:
                self._files[name] = open(os.path.join(log_dir, f"{name}.log"), "w")
            self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "w")

    def tick(self):
        self.iterate += 1

    def write(self, stream: str, msg: str, **fields):
        if not self.enabled:
            return
        f = self._files[stream]
        f.write(f"[{self.iterate}] {msg}\n")
        rec = {"iter": self.iterate, "stream": stream, "msg": msg, **fields}
        self._jsonl.write(json.dumps(rec) + "\n")

    @contextmanager
    def stage(self, name: str):
        """Wall-clock stage timer (the profiling hook: wrap device work;
        callers synchronize the device inside for honest numbers)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._timings.setdefault(name, []).append(dt)
            if self.enabled:
                self.write("tracker", f"stage {name}: {dt * 1e3:.2f} ms",
                           stage=name, ms=dt * 1e3)

    def timing_summary(self) -> dict:
        import numpy as np

        return {
            name: {"n": len(v), "mean_ms": float(np.mean(v) * 1e3),
                   "p90_ms": float(np.percentile(v, 90) * 1e3)}
            for name, v in self._timings.items()
        }

    def close(self):
        for f in self._files.values():
            f.close()
        if self.enabled:
            self._jsonl.close()


NULL_LOGGER = SlamLogger(None, enabled=False)
