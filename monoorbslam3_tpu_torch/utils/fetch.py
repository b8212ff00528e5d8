"""The one host read per pipeline stage (counterpart of the sync counter in
`monoorbslam3_tpu/utils/fetch.py`).

PyTorch runs eagerly and every `.item()`, `.cpu()` or `bool(tensor)` on a
CUDA tensor waits for the device. The tracking stages return device
tensors; the caller brings a stage's whole result to the host with ONE
`fetch`, which starts every device->host copy on the current stream and
then waits once. `SyncCounter.n` counts those waits.
"""

from __future__ import annotations

import torch


class SyncCounter:
    """Counts blocking device->host reads made through `fetch`."""

    def __init__(self):
        self.n = 0


def fetch(tree, counter: SyncCounter):
    """Tensors (possibly nested in plain tuples, lists and dicts) -> numpy,
    with a single stream synchronisation when any of them lies on the card."""
    on_card = []

    def start(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                on_card.append(True)
                return x.to("cpu", non_blocking=True)
            return x
        if isinstance(x, dict):
            return {k: start(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(start(v) for v in x)
        return x

    staged = start(tree)
    if on_card:
        torch.cuda.current_stream().synchronize()
        counter.n += 1

    def finish(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, dict):
            return {k: finish(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(finish(v) for v in x)
        return x

    return finish(staged)
