"""Where K2's device time goes, on one CUDA card: variants of
`monoorbslam3_tpu_torch/csrc/match_rows.cu` built side by side.

Each variant is the kernel's source with a few lines replaced, built into
its own library (under `monoorbslam3_tpu_torch/_build/`), swapped in for
the package's by chip_smoke's `_OtherBuild` and timed by chip_smoke's `_time_kernel` at the tracking
step's three shapes (1024 x 1024, 4096 x 1024, 1024 x 4096) on seeded
inputs of the same kind (random descriptors; rows and columns spread over
a 752 x 480 image; a 15 px radius; 60% of the rows valid). Variants that
drop part of the work give wrong results and are timed only; the others are
held bit-exact against the plain version.

    python experiments/port_match_ablate.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

import chip_smoke as cs
from monoorbslam3_tpu_torch.ops import cuda_lib
from monoorbslam3_tpu_torch.ops.match_pallas import _match_rows_cuda, _match_rows_plain

SHAPES = ((1024, 1024), (4096, 1024), (1024, 4096))
_WAIT = 'asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");'
_ARRIVE = 'asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");'
_LOCAL = [(f"cluster.map_shared_rank(&{a}[0][0], 0)", f"&{a}[0][0]")
          for a in ("p_best", "p_second", "p_idx")]
_NO_MERGE = [(_WAIT, ""), (_ARRIVE, ""), *_LOCAL, ("cluster.sync();", "__syncthreads();")]
_ROWS16 = [("constexpr int kRows = 32;", "constexpr int kRows = 16;"),
           ("mt = warp & 1, parity = warp >> 1", "mt = 0, parity = warp"),
           ("constexpr int kParts = kCluster * 2;", "constexpr int kParts = kCluster * 4;"),
           ("nt < cols8 / 8; nt += 2)", "nt < cols8 / 8; nt += 4)"),
           ("(rank * 2 + parity) * kRows", "(rank * 4 + parity) * kRows")]
# name -> (source replacements, exact?)
VARIANTS = {
    "as built": ([], True),
    "8 warps, 64 rows a block": ([("constexpr int kRows = 32;", "constexpr int kRows = 64;"),
                                  ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                                  ("mt = warp & 1, parity = warp >> 1", "mt = warp & 3, parity = warp >> 2")],
                                 True),
    "4 column chunks": ([("constexpr int kCluster = 8;", "constexpr int kCluster = 4;")], True),
    "16 column chunks": ([("constexpr int kCluster = 8;", "constexpr int kCluster = 16;"),
                          ("cudaLaunchConfig_t cfg = {};",
                           "cudaFuncSetAttribute(match_rows_kernel, "
                           "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n  "
                           "cudaLaunchConfig_t cfg = {};")], True),
    "16 rows a block, 4 warps on its n-tiles": (_ROWS16, True),
    "16 rows, 4 warps, 16 column chunks": (_ROWS16 + [
        ("constexpr int kCluster = 8;", "constexpr int kCluster = 16;"),
        ("cudaLaunchConfig_t cfg = {};",
         "cudaFuncSetAttribute(match_rows_kernel, "
         "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n  cudaLaunchConfig_t cfg = {};")],
        True),
    "no vocab-node test (exact here: groups -1)": (
        [("(q < fminf(rr2[h], r2)) && (rany[h] || gc < 0.f || rg[h] == gc)",
          "(q < fminf(rr2[h], r2))")], True),
    "no tensor-core product (timing only)": (
        [("mma_and_popc(af[0], af[1], af[2], af[3], bf, acc);",
          "acc[0] = bf.x; acc[1] = bf.y; acc[2] = af[0]; acc[3] = af[1];")], False),
    "no gate (timing only)": (
        [("const bool gate = (q < fminf(rr2[h], r2)) && (rany[h] || gc < 0.f || rg[h] == gc);",
          "const bool gate = true;")], False),
    "running min, no top-2 (timing only)": (
        [("push(top[h], gate ? ham : kInf, base + j0 + j);",
          "top[h].best = min(top[h].best, gate ? ham : kInf);")], False),
    "no DSMEM merge (timing only)": (_NO_MERGE, False),
    "no cluster (timing only)": (_NO_MERGE + [
        ("const unsigned rank = cluster.block_rank();", "const unsigned rank = blockIdx.x;"),
        ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")], False),
    "no column sweep (timing only)": ([("for (int base = c0; base < c1;", "for (int base = c0; base < c0;")],
                                      False),
    "empty cluster kernel (timing only)": ([(_ARRIVE, "if (n >= 0) return;\n  " + _ARRIVE)], False),
}


def inputs(N, M, rng, dev):
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    d = lambda n: torch.as_tensor(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32),
                                  device=dev)
    pos = lambda n: rng.uniform((0, 0), (752, 480), (n, 2))
    pa, pb = pos(N), pos(M)
    return [d(N), d(M), f(pa[:, 0]), f(pa[:, 1]), f(np.full(N, 15.0 ** 2)),
            f(np.full(N, -1.0)), f(rng.random(N) < 0.6), f(pb[:, 0]), f(pb[:, 1]),
            f(np.full(M, 1e9)), f(np.full(M, -1.0)), f(np.ones(M))]


def main():
    if not torch.cuda.is_available():
        sys.exit("port_match_ablate: needs a CUDA device")
    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0))
    src = (cuda_lib.CSRC / "match_rows.cu").read_text()
    cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    cases = {shape: inputs(*shape, rng, dev) for shape in SHAPES}
    refs = {shape: _match_rows_plain(*a) for shape, a in cases.items()}
    for k, (name, (reps, exact)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in match_rows.cu once")
            text = text.replace(old, new)
        path = cuda_lib.BUILD / f"ablate{k}.cu"
        path.write_text(text)
        row = []
        try:
            with cs._OtherBuild(path):
                for shape, a in cases.items():
                    if exact:
                        cs._same(_match_rows_cuda(*a), refs[shape], f"{name} {shape}")
                    ms, _ = cs._time_kernel(lambda: _match_rows_cuda(*a))
                    row.append(f"{shape[0]}x{shape[1]} {1e3 * ms:7.2f} us")
        except RuntimeError as e:  # a variant that does not build, launch or agree
            row.append(f"failed: {str(e)[-300:]}")
        print(f"{name:44s}" + "   ".join(row) + ("   (bit-exact)" if exact and len(row) == 3 else ""))


if __name__ == "__main__":
    main()
