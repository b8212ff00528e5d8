"""Per-layer metric `mapper_ms_per_kf` (ms, the mapper): the benchmark's
host clock around `LocalMapping.process`, summed over the window's steps
(one a keyframe) and divided by their number. None off the card."""

from __future__ import annotations


def read(record):
    if record.get("kind") != "stream" or not record["on_card"] or not record["mapper_ms"]:
        return None
    return sum(record["mapper_ms"]) / len(record["mapper_ms"])
