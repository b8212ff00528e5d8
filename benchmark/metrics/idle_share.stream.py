"""Per-layer metric `idle_share.stream` (%, the device): the share of the
traced window in which no kernel, copy or fill ran on the card."""

from __future__ import annotations


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "stream" or not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
