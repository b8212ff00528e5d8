"""Per-layer metric `frame_ms_p50` (ms, the façade `System.track`): the
median over the window's untraced frames of the host clock around
`System.track` less the benchmark's clock around `LocalMapping.process`
inside it. None off the card."""

from __future__ import annotations

import numpy as np


def read(record):
    if record.get("kind") != "stream" or not record["on_card"]:
        return None
    ms = [f[0] - f[1] for f in record["frames"] if not f[3]]
    return float(np.percentile(ms, 50)) if ms else None
