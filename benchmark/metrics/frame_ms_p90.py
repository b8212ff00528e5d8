"""Per-layer metric `frame_ms_p90` (ms, the façade `System.track`): the
tail of the same frame times as `frame_ms_p50`: their 90th percentile, or,
where fewer than 100 frames leave fewer than ten beyond it, the highest
percentile with ten frames beyond it. None off the card or below 20
frames."""

from __future__ import annotations

import numpy as np


def read(record):
    if record.get("kind") != "stream" or not record["on_card"]:
        return None
    ms = [f[0] - f[1] for f in record["frames"] if not f[3]]
    if len(ms) < 20:
        return None
    return float(np.percentile(ms, min(90.0, 100.0 * (1.0 - 10.0 / len(ms)))))
