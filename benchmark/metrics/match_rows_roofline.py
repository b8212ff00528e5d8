"""Per-layer metric `match_rows_roofline` (%, the kernels): the least time the
card could take for the traced launches of the hand kernel `match_rows`
(`benchmark/roofline.py`, from the shapes logged at its wrapper) over
their device time in the profiler's trace. None where the trace holds no
such launch."""

from __future__ import annotations

from benchmark import roofline


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    names, bound = roofline.KERNELS["match_rows"]
    device_s = sum(s for n, s in trace["kernels"].items() if any(k in n for k in names))
    shapes = record["shapes"].get("match_rows", [])
    if device_s <= 0 or not shapes:
        return None
    return 100.0 * sum(bound(*dims) for dims in shapes) / device_s
