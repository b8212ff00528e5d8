"""KITTI raw dataset preparation, the scripts/ analogs (the port's copy of
`monoorbslam3_tpu/runners/prep_kitti.py`; host code).

Converts KITTI raw OXTS per-file data into the flat `imu.txt` / `gps.txt` /
`times.txt` layout the runners consume (the reference does this with
scripts/imu.py:27-44, gps.py, cameraTime.py).

KITTI raw layout:
  <drive>/oxts/data/%010d.txt   30 OXTS fields per file (one per frame)
  <drive>/oxts/timestamps.txt   ISO timestamps
  <drive>/image_00/timestamps.txt

OXTS fields used: [11..13] af/al/au (body accel), [17..19] wf/wl/wu (body
angular rate), [0..2] lat/lon/alt for gps.txt.
"""

from __future__ import annotations

import os
from datetime import datetime


def _parse_ts(line: str) -> float:
    line = line.strip()
    if not line:
        return None
    base, frac = line.split(".")
    t = datetime.strptime(base, "%Y-%m-%d %H:%M:%S")
    return t.timestamp() + float("0." + frac)


def _read_timestamps(path: str):
    out = []
    with open(path) as f:
        for line in f:
            t = _parse_ts(line)
            if t is not None:
                out.append(t)
    return out


def prepare_drive(drive_dir: str, out_dir: str | None = None):
    """Write imu.txt, gps.txt, times.txt next to (or into out_dir of) a
    KITTI raw drive folder."""
    out_dir = out_dir or drive_dir
    os.makedirs(out_dir, exist_ok=True)

    oxts_dir = os.path.join(drive_dir, "oxts")
    ts = _read_timestamps(os.path.join(oxts_dir, "timestamps.txt"))
    data_dir = os.path.join(oxts_dir, "data")
    files = sorted(os.listdir(data_dir))

    imu_lines, gps_lines = [], []
    for t, name in zip(ts, files):
        with open(os.path.join(data_dir, name)) as f:
            v = [float(x) for x in f.read().split()]
        # gyro (wf, wl, wu) then accel (af, al, au): body frame
        gx, gy, gz = v[17], v[18], v[19]
        ax, ay, az = v[11], v[12], v[13]
        imu_lines.append(f"{t:.6f} {gx:.8f} {gy:.8f} {gz:.8f} "
                         f"{ax:.8f} {ay:.8f} {az:.8f}\n")
        gps_lines.append(f"{t:.6f} {v[0]:.9f} {v[1]:.9f} {v[2]:.4f}\n")

    os.makedirs(os.path.join(out_dir, "oxts"), exist_ok=True)
    with open(os.path.join(out_dir, "oxts", "imu.txt"), "w") as f:
        f.writelines(imu_lines)
    with open(os.path.join(out_dir, "oxts", "gps.txt"), "w") as f:
        f.writelines(gps_lines)

    cam_ts = _read_timestamps(os.path.join(drive_dir, "image_00", "timestamps.txt"))
    os.makedirs(os.path.join(out_dir, "image_00"), exist_ok=True)
    with open(os.path.join(out_dir, "image_00", "times.txt"), "w") as f:
        f.writelines(f"{t:.6f}\n" for t in cam_ts)
    return len(imu_lines), len(cam_ts)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="KITTI raw OXTS -> imu/gps/times")
    p.add_argument("drive_dir")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    n_imu, n_cam = prepare_drive(args.drive_dir, args.out)
    print(f"wrote {n_imu} imu rows, {n_cam} camera timestamps")


if __name__ == "__main__":
    main()
