"""The vocabulary's tree descent (DBoW2's `transform`), in plain torch,
from the vocabulary's text file as it ships: the benchmark parses the file
itself, so nothing the port loaded is reused. Imports nothing of the port.

A descriptor descends the complete k-ary tree level by level to the child
at the least Hamming distance (the first one on a tie); its word is the
leaf, its group the node at `group_level` (-1 for an invalid row).
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

from .match import popcount32


class TreeVocabulary:
    def __init__(self, path: str, group_level: int, device):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            header = f.readline().split()
            body = np.array(f.read().split(), dtype=np.float64)
        self.k, self.levels = int(header[0]), int(header[1])
        rows = body.reshape(-1, 35)
        k = self.k
        sizes = [k**lev for lev in range(1, self.levels + 1)]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        node_desc = np.zeros((sum(sizes), 8), np.uint32)
        # rows are nodes in creation order, each naming its parent's file id
        # (0 = the root): a child's slot is its parent's times k plus its
        # rank among the parent's children
        level = np.zeros(len(rows) + 1, np.int64)
        slot = np.zeros(len(rows) + 1, np.int64)
        rank = np.zeros(len(rows) + 1, np.int64)
        parents = rows[:, 0].astype(np.int64)
        desc_u8 = rows[:, 2:34].astype(np.uint8)
        for i, p in enumerate(parents.tolist(), start=1):
            level[i] = level[p] + 1
            slot[i] = slot[p] * k + rank[p]
            rank[p] += 1
            if level[i] <= self.levels:
                node_desc[self.offsets[level[i] - 1] + slot[i]] = desc_u8[i - 1].view(np.uint32)
        self.node_desc = torch.as_tensor(node_desc.view(np.int32), device=device)
        self.group_level = int(group_level)

    def transform(self, desc: torch.Tensor, valid: torch.Tensor):
        """[N, 8] int32 words, [N] bool -> (word [N] int32, group [N] int32)."""
        k = self.k
        desc = desc.to(torch.int32)
        kids = torch.arange(k, dtype=torch.int64, device=desc.device)
        node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
        group = node
        for lev in range(1, self.levels + 1):
            child = self.node_desc[int(self.offsets[lev - 1]) + node[:, None] * k + kids[None]]
            d = popcount32(desc[:, None, :] ^ child).sum(-1)
            node = node * k + torch.argmin(d, dim=-1)
            if lev == self.group_level:
                group = node
        minus = torch.full_like(node, -1)
        valid = valid.to(torch.bool)
        return (torch.where(valid, node, minus).to(torch.int32),
                torch.where(valid, group, minus).to(torch.int32))
