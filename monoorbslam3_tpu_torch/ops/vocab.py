"""Bag-of-binary-words vocabulary (counterpart of
`monoorbslam3_tpu/ops/vocab.py`).

The analog of the vendored DBoW2 (thirdParty/DBoW2/TemplatedVocabulary.h):
a hierarchical k-means tree over 256-bit ORB descriptors, flattened into
dense level-major node tables.

- `transform` is the per-frame part: every descriptor descends the tree in
  lockstep, one batched step a level (gather the k children, XOR +
  popcount, argmin), then the tf-idf histogram. Plain torch with shapes
  fixed by N and k and no host read, so the group ids stay on the device
  until the tracker's one read of the frame. The JAX package contracts
  +-1 planes in float32 instead of counting bits: the same integers, so
  the same argmins (both take the lowest index on a tie).
- `train`, the DBoW2 text loader and writer and their helpers are host
  numpy, bit for bit the JAX package's. A vocabulary's tables are uploaded
  once, when it is built, onto one device (the card unless the caller
  names another, `utils/device.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import CARD, resolve
from .pallas_kernels import popcount32

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_to_centers(descs: np.ndarray, centers: np.ndarray,
                        chunk: int = 16384) -> np.ndarray:
    """[n, 8] x [k, 8] uint32 -> [n, k] int32 Hamming, chunked byte-LUT
    popcount (stays at chunk * k * 32 bytes)."""
    n, k = len(descs), len(centers)
    out = np.empty((n, k), np.int32)
    cb = centers.view(np.uint8).reshape(1, k, 32)
    for s in range(0, n, chunk):
        db = descs[s:s + chunk].view(np.uint8).reshape(-1, 1, 32)
        out[s:s + chunk] = _POPCNT8[db ^ cb].sum(-1, dtype=np.int32)
    return out


def _majority_centroid(descs: np.ndarray) -> np.ndarray:
    """Binary centroid: per-bit majority vote over [n, 8] uint32 rows."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # [n, 256]
    maj = (bits.sum(0) * 2 >= len(bits)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _binary_kmeans(descs: np.ndarray, k: int, rng, iters: int = 8):
    """k-means over binary descriptors with Hamming distance."""
    n = len(descs)
    if n <= k:
        return descs.copy(), np.arange(n) % max(len(descs), 1)
    centers = descs[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_to_centers(descs, centers)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            sel = descs[assign == c]
            if len(sel):
                centers[c] = _majority_centroid(sel)
            else:
                centers[c] = descs[rng.integers(0, n)]
    return centers, assign


def _level_offsets(k: int, levels: int) -> tuple:
    return tuple(sum(k**j for j in range(1, l)) for l in range(1, levels + 1))


class Vocabulary(NamedTuple):
    """Flattened vocabulary tree. Nodes are stored level-major; level l has
    k^l nodes (a complete tree, missing branches padded with their
    parent's descriptor); the word layer is the last level. `node_desc`
    ([n_nodes, 8] int32, the bits of the uint32 words) and `word_idf`
    ([k^levels] float32) lie on one device."""

    k: int  # branching factor
    levels: int  # tree depth (word level = levels)
    node_desc: torch.Tensor  # [n_nodes, 8] int32 (all levels, level-major)
    level_offset: tuple  # start index of each level
    word_idf: torch.Tensor  # [k**levels] idf weight per word
    group_level: int  # node level used for match bucketing (BoW groups)

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    @property
    def device(self) -> torch.device:
        return self.node_desc.device

    @staticmethod
    def from_numpy(k, levels, node_desc, level_offset, word_idf, group_level,
                   device=CARD) -> "Vocabulary":
        """Host tables ([n_nodes, 8] uint32 words, [k^levels] idf) -> a
        Vocabulary on `device` (one upload each)."""
        dev = resolve(device)
        words = np.ascontiguousarray(np.asarray(node_desc, np.uint32)).view(np.int32)
        return Vocabulary(
            k=int(k), levels=int(levels),
            node_desc=torch.from_numpy(words.copy()).to(dev),
            level_offset=tuple(int(o) for o in level_offset),
            word_idf=torch.from_numpy(np.asarray(word_idf, np.float32).copy()).to(dev),
            group_level=int(group_level))

    def host_tables(self):
        """(node_desc [n_nodes, 8] uint32, word_idf [k^levels] float32) on
        the host."""
        words = self.node_desc.cpu().numpy().astype(np.int32)
        return words.view(np.uint32), self.word_idf.cpu().numpy().astype(np.float32)

    @staticmethod
    def train(descs: np.ndarray, k: int = 8, levels: int = 3, group_level: int = 1,
              seed: int = 0, device=CARD) -> "Vocabulary":
        """Hierarchical binary k-means (the DBoW2 build, done in-process)."""
        rng = np.random.default_rng(seed)
        descs = np.asarray(descs, np.uint32).reshape(-1, 8)
        n_nodes = sum(k**l for l in range(1, levels + 1))
        node_desc = np.zeros((n_nodes, 8), np.uint32)
        level_offset = []
        off = 0
        groups = {0: descs}  # parent slot -> member descriptors
        for l in range(1, levels + 1):
            level_offset.append(off)
            next_groups = {}
            n_level = k**l
            for parent, members in groups.items():
                if len(members) == 0:
                    # starved branch: pad every child with the parent's
                    # descriptor, as the loader does for missing branches
                    pdesc = (node_desc[level_offset[l - 2] + parent]
                             if l >= 2 else np.zeros(8, np.uint32))
                    for c in range(k):
                        node_desc[off + parent * k + c] = pdesc
                        next_groups[parent * k + c] = members
                    continue
                centers, assign = _binary_kmeans(members, k, rng)
                for c in range(k):
                    slot = parent * k + c
                    if c < len(centers):
                        node_desc[off + slot] = centers[c]
                        next_groups[slot] = members[assign == c] if len(members) > k else members[:0]
                    else:
                        node_desc[off + slot] = centers[c % max(len(centers), 1)]
                        next_groups[slot] = members[:0]
            groups = next_groups
            off += n_level
        # uniform idf until corpus statistics exist
        idf = np.ones(k**levels, np.float32)
        return Vocabulary.from_numpy(k, levels, node_desc, level_offset, idf, group_level,
                                     device)

    def transform(self, desc: torch.Tensor, valid: torch.Tensor):
        """[N, 8] int32 descriptors (uint32 bits) and [N] valid ->
        (word_id [N] int32, group_id [N] int32, bow [n_words] float32):
        the leaf, the ancestor node at `group_level` (the FeatureVector
        node that gates SearchByBow), -1 for padding, and the
        tf-idf-weighted normalized word histogram (BowVector). No host
        read."""
        return _transform_impl(self.node_desc, self.word_idf, desc, valid, self.k,
                               self.levels, self.level_offset, self.group_level)

    def score(self, bow_a: torch.Tensor, bow_b: torch.Tensor) -> torch.Tensor:
        """L1 BowVector similarity in [0, 1] (DBoW2 L1Scoring)."""
        return 1.0 - 0.5 * torch.sum(torch.abs(bow_a - bow_b))


def _transform_impl(node_desc, word_idf, desc, valid, k: int, levels: int,
                    level_offset: tuple, group_level: int):
    N = desc.shape[0]
    dev = desc.device
    desc = desc.to(torch.int32)
    valid = valid.to(torch.bool)
    kids = torch.arange(k, dtype=torch.int64, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)  # slot within the level
    group = node
    for l in range(1, levels + 1):
        # the children of `node` occupy slots node*k .. node*k+k-1
        child = node_desc[level_offset[l - 1] + node[:, None] * k + kids[None, :]]  # [N, k, 8]
        d = popcount32(desc[:, None, :] ^ child).sum(dim=-1)  # [N, k] Hamming
        node = node * k + torch.argmin(d, dim=-1)  # the first minimum on a tie
        if l == group_level:
            group = node
    word_m = torch.where(valid, node, torch.zeros_like(node))
    hist = torch.zeros(k**levels, dtype=torch.float32, device=dev)
    hist.index_add_(0, word_m, valid.to(torch.float32))
    bow = hist * word_idf
    bow = bow / torch.clamp(torch.sum(bow), min=1e-9)
    minus = torch.full_like(node, -1)
    word = torch.where(valid, node, minus).to(torch.int32)
    group = torch.where(valid, group, minus).to(torch.int32)
    return word, group, bow


def _open_text(path: str, mode: str):
    """Text open with transparent gzip by extension (the reference-scale
    vocabulary ships as a .gz file)."""
    if str(path).endswith(".gz"):
        import gzip

        return gzip.open(path, mode + "t")
    return open(path, mode)


def save_dbow2_text(vocab: Vocabulary, path: str):
    """Write a vocabulary in the DBoW2 text format (the layout
    `load_dbow2_text` parses): header `k L scoring weighting`, then one line
    per node `parent_id is_leaf b0..b31 weight`, level-major in slot order.
    The same bytes as the JAX package's writer."""
    k, L = vocab.k, vocab.levels
    node_desc, idf = vocab.host_tables()

    def file_id(l: int, s: int) -> int:
        return sum(k**j for j in range(1, l)) + s + 1

    with _open_text(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for l in range(1, L + 1):
            off = vocab.level_offset[l - 1]
            for s in range(k**l):
                pid = 0 if l == 1 else file_id(l - 1, s // k)
                b = node_desc[off + s].view(np.uint8)
                w = float(idf[s]) if l == L else 0.0
                is_leaf = 1 if l == L else 0
                f.write(f"{pid} {is_leaf} "
                        + " ".join(str(int(x)) for x in b) + f" {w:.6f}\n")


def load_dbow2_text(path: str, group_level: int = 1, device=CARD) -> Vocabulary:
    """Load a DBoW2 text vocabulary (the ORBvoc.txt format: header `k L
    scoring weighting`, then per node: parent is_leaf 32 bytes weight) onto
    `device`. Rebuilds the dense complete-tree layout; missing branches are
    padded with their parent's descriptor."""
    dev = resolve(device)
    with _open_text(path, "r") as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        n_nodes = sum(k**l for l in range(1, levels + 1))
        node_desc = np.zeros((n_nodes, 8), np.uint32)
        level_offset = _level_offsets(k, levels)
        # DBoW2 text lists nodes in creation order with parent ids; rebuild
        parents = {0: (0, 0)}  # file node id -> (level, slot); root = level 0
        child_count = {0: 0}
        idf = np.ones(k**levels, np.float32)
        for file_id, line in enumerate(f, start=1):
            parts = line.split()
            if len(parts) < 35:
                continue
            pid = int(parts[0])
            bytes_ = np.array([int(x) for x in parts[2:34]], np.uint8)
            weight = float(parts[34])
            p_level, p_slot = parents[pid]
            c = child_count.get(pid, 0)
            child_count[pid] = c + 1
            level = p_level + 1
            slot = p_slot * k + c
            parents[file_id] = (level, slot)
            if 1 <= level <= levels:
                node_desc[level_offset[level - 1] + slot] = bytes_.view(np.uint32)
                if level == levels:
                    idf[slot] = weight
    return Vocabulary.from_numpy(k, levels, node_desc, level_offset, idf, group_level, dev)
