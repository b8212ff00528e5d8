"""K4's large-D route on one CUDA card: what a grid barrier costs, where the
kernel's time goes, and its time over D and G.

Builds the kernels, then prints
- the device time of an empty cooperative kernel of 90 and of 900 grid
  barriers on the route's grid (`chol_grid_sync_probe`), hence the cost of
  one barrier;
- per (D, G): the relative error against float64, whether two runs are
  bit-identical, device and call ms (`chip_smoke._time_kernel`) beside the
  plain version and `torch.linalg.solve_ex`;
- the phase split of one launch from block 0's clock64 spans
  (`chol_solve_grid_clocks_f32`): load, factor, back pass, residual,
  refinement passes, in microseconds at the SM clock nvidia-smi reports.

    python experiments/port_chol_grid_probe.py [--dims 769 1440] [--gs 1 2]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

import chip_smoke as cs
from monoorbslam3_tpu_torch.ops import chol_pallas, cuda_lib

PHASES = ("load", "factor", "back pass", "residual", "refinement passes")


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def phase_split(S, b):
    """{phase: clock64 cycles of block 0} of one launch on S, b."""
    lib = cuda_lib.lib()
    G, D = S.shape[0], S.shape[-1]
    work = torch.empty(lib.chol_grid_work_floats(G, D), dtype=torch.float32, device=S.device)
    x = torch.empty((G, D), dtype=torch.float32, device=S.device)
    clocks = torch.zeros(len(PHASES), dtype=torch.int64, device=S.device)
    err = lib.chol_solve_grid_clocks_f32(S.data_ptr(), b.data_ptr(), G, D, work.data_ptr(),
                                         x.data_ptr(), clocks.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "chol_solve_grid_clocks_f32")
    torch.cuda.synchronize()
    return dict(zip(PHASES, clocks.tolist())), x


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs="+", default=[769, 1000, 1440])
    ap.add_argument("--gs", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_chol_grid_probe: needs a CUDA device")
    dev = torch.device("cuda:0")
    print(_smi("name,power.limit"))
    lib = cuda_lib.lib()
    for line in cuda_lib.BUILD_LOG.read_text().splitlines():
        if "error" in line or "warning" in line or "chol_grid" in line or "registers" in line:
            print("nvcc:", line.strip())
    stream = torch.cuda.current_stream().cuda_stream
    print("grid blocks at D = 1440:", lib.chol_grid_blocks(1440))
    times = {}
    for n in (90, 900):
        def probe():
            cuda_lib.check(lib.chol_grid_sync_probe(n, stream), "chol_grid_sync_probe")
        times[n], _ = cs._time_kernel(probe)
        print(f"{n} grid barriers in an empty kernel: {times[n]:.5f} ms")
    print(f"one grid barrier: {1e3 * (times[900] - times[90]) / 810:.3f} us")

    rng = np.random.default_rng(7)
    mhz = float(_smi("clocks.max.sm").split()[0])
    for D in args.dims:
        for G in args.gs:
            S_np, b_np = cs.seeded_spd(D, rng, G=G)
            S, b = torch.as_tensor(S_np, device=dev), torch.as_tensor(b_np, device=dev)
            x = chol_pallas.chol_solve_l2(S, b)
            x2 = chol_pallas.chol_solve_l2(S, b)
            torch.cuda.synchronize()
            x64 = torch.linalg.solve(S.double(), b.double())
            row = dict(D=D, G=G, rel_err_vs_f64=float(cs._rel(x, x64).max()),
                       bit_identical=bool(torch.equal(x, x2)))
            row["device_ms"], row["call_ms"] = cs._time_kernel(
                lambda: chol_pallas.chol_solve_l2(S, b))
            row["plain_ms"], _ = cs._time_kernel(lambda: chol_pallas.chol_solve_plain(S, b), "plain")
            row["solve_ex_ms"], _ = cs._time_kernel(lambda: torch.linalg.solve_ex(S, b), "solve_ex")
            cycles, xc = phase_split(S, b)
            row["clocks_bit_identical"] = bool(torch.equal(x, xc))
            row["phase_us"] = {k: v / mhz for k, v in cycles.items()}
            print(json.dumps(row))


if __name__ == "__main__":
    main()
