"""Where K1's device time goes, on one CUDA card: variants of
`monoorbslam3_tpu_torch/csrc/gather_patches.cu` built side by side.

Each variant is the kernel's source with a few lines replaced, built into
its own library (under `monoorbslam3_tpu_torch/_build/`), swapped in for
the package's by chip_smoke's `_OtherBuild` and timed by chip_smoke's
`_time_kernel` at the extractor's shape (a [2274, 1024] atlas, K = 1024
random corners), once on one atlas (it stays in the L2 cache, as on the
tracking path) and once cycling through copies that exceed the L2 twice
over. Variants that drop part of the work give wrong results and are timed
only; the others are held bit-exact against the plain version.

    python experiments/port_gather_ablate.py
"""

from __future__ import annotations

import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

import chip_smoke as cs
from monoorbslam3_tpu_torch.ops import cuda_lib
from monoorbslam3_tpu_torch.ops.pallas_kernels import gather_patches_cuda, gather_patches_plain

_COPY = "dst[it * kRows * kGroups] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));"
_ROWS = "constexpr int kRows = 16;"
# name -> (source replacements, exact?)
VARIANTS = {
    "as built (16 rows a round, 192 threads)": ([], True),
    "48 rows a round, 576 threads": ([(_ROWS, "constexpr int kRows = 48;")], True),
    "8 rows a round, 96 threads": ([(_ROWS, "constexpr int kRows = 8; ")], True),
    "streaming stores (__stcs)": ([(_COPY, "__stcs(dst + it * kRows * kGroups, make_float4("
                                    "__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)));")], True),
    "loads only (timing only)": ([(_COPY, "const float4 v = make_float4(__ldg(p), __ldg(p + 1), "
                                   "__ldg(p + 2), __ldg(p + 3));\n    if (v.x == -12345.0f) "
                                   "dst[it * kRows * kGroups] = v;")], False),
    "stores only (timing only)": ([(_COPY, "dst[it * kRows * kGroups] = make_float4(0.0f, 1.0f, "
                                    "2.0f, static_cast<float>(p - src));")], False),
    "empty kernel, same grid (timing only)": ([("  const int k = blockIdx.x;",
                                                "  if (ha >= 0) return;\n  const int k = blockIdx.x;")],
                                              False),
}


def main():
    if not torch.cuda.is_available():
        sys.exit("port_gather_ablate: needs a CUDA device")
    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0))
    src = (cuda_lib.CSRC / "gather_patches.cu").read_text()
    cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    atlas = torch.as_tensor(rng.uniform(0, 255, (2274, 1024)).astype(np.float32), device=dev)
    ys = torch.as_tensor(rng.integers(0, 2274 - 48, 1024).astype(np.int32), device=dev)
    xs = torch.as_tensor(rng.integers(0, 1024 - 48, 1024).astype(np.int32), device=dev)
    ref = gather_patches_plain(atlas, ys, xs)
    copies = [atlas.clone() for _ in range(2 * 50 * 2 ** 20 // atlas.nbytes + 2)]
    for k, (name, (reps, exact)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in gather_patches.cu once")
            text = text.replace(old, new)
        path = cuda_lib.BUILD / f"gather_ablate{k}.cu"
        path.write_text(text)
        try:
            with cs._OtherBuild(path):
                if exact and not torch.equal(gather_patches_cuda(atlas, ys, xs), ref):
                    raise RuntimeError("disagrees with the plain version")
                warm, call = cs._time_kernel(lambda: gather_patches_cuda(atlas, ys, xs))
                cyc = itertools.cycle(copies)
                cold, _ = cs._time_kernel(lambda: gather_patches_cuda(next(cyc), ys, xs))
            row = (f"atlas in L2 {1e3 * warm:6.2f} us   L2 exceeded {1e3 * cold:6.2f} us   "
                   f"call {1e3 * call:6.2f} us" + ("   (bit-exact)" if exact else ""))
        except RuntimeError as e:  # a variant that does not build, launch or agree
            row = f"failed: {str(e)[-300:]}"
        print(f"{name:42s}{row}")


if __name__ == "__main__":
    main()
