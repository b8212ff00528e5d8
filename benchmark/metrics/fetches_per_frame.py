"""Per-layer metric `fetches_per_frame` (count, the tracker): the port's
own count of blocking device reads (`System.problems.syncs`, a
`utils/fetch.SyncCounter`) over the window's frames, less those made
inside the mapper's steps, per frame."""

from __future__ import annotations


def read(record):
    if record.get("kind") != "stream" or not record["frames"]:
        return None
    return sum(f[2] for f in record["frames"]) / len(record["frames"])
