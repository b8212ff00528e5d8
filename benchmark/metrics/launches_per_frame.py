"""Per-layer metric `launches_per_frame` (count, the tracker): the host's
kernel, cooperative and graph launch calls in the traced part of the
window (the profiler's runtime and driver events), per frame tracked
there, the mapper's steps inside those frames included."""

from __future__ import annotations


def read(record):
    traced = [f for f in record.get("frames", []) if f[3]]
    if record.get("kind") != "stream" or not record.get("trace") or not traced:
        return None
    return record["trace"]["launches"] / len(traced)
