"""Full-f32 matmuls for accuracy-critical geometry code.

Counterpart of `monoorbslam3_tpu/utils/precision.py` (`f32_matmuls`): the
pose LM and the camera projections need true float32 products. On the card
a float32 matmul may run in TF32 (`torch.backends.cuda.matmul.allow_tf32`)
and a float32 convolution does by default (`torch.backends.cudnn.allow_tf32`);
TF32 keeps about three decimal digits, i.e. ~0.1 px of error on a 300 px
projection. Both stay off. Deliberate low precision is written out where it
is used (the BRIEF sampler's bf16 patch operand, `ops/orb.py`).
"""

from __future__ import annotations

import torch


def f32_matmuls() -> None:
    """Turn TF32 off for matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
