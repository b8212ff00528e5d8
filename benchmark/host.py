"""The host's condition over a measured window, read from /proc: how much
of the machine's CPU time the hypervisor took (steal), how busy its cores
were, how much CPU time this process had, the load average and the cores'
clock. A run logs it on standard error beside its window, so that a run
that reads slow can be told apart: a host that lent its cores elsewhere,
a busy machine, or a slower clock. Nothing here changes a setting."""

from __future__ import annotations

import os
import time


def _cpu_line() -> list[int]:
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except OSError:
        return []


def _mhz() -> float | None:
    try:
        with open("/proc/cpuinfo") as f:
            v = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        return sum(v) / len(v) if v else None
    except (OSError, ValueError):
        return None


def sample() -> dict:
    try:
        load = os.getloadavg()[0]
    except OSError:
        load = None
    return {"wall": time.perf_counter(), "cpu": time.process_time(), "stat": _cpu_line(),
            "mhz": _mhz(), "load": load}


def describe(a: dict, b: dict, window_s: float) -> str:
    """One line: steal and busy as shares of the machine's CPU time over
    the window, this process's CPU time as a share of the window, the
    1-minute load average and the mean clock at the window's end."""
    parts = []
    if a["stat"] and b["stat"]:
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        total = sum(d[:8]) or 1  # user nice system idle iowait irq softirq steal
        idle = d[3] + d[4]
        steal = d[7] if len(d) > 7 else 0
        parts.append(f"steal {100 * steal / total:.2f}%, machine busy "
                     f"{100 * (total - idle - steal) / total:.1f}% of {os.cpu_count()} cores")
    parts.append(f"this process {100 * (b['cpu'] - a['cpu']) / max(window_s, 1e-9):.1f}% "
                 f"of a core")
    if b["load"] is not None:
        parts.append(f"load {b['load']:.2f}")
    if b["mhz"] is not None:
        parts.append(f"clock {b['mhz']:.0f} MHz")
    return ", ".join(parts)
