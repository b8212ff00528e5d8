"""Carry state into the port from plain arrays.

Every function takes numpy arrays (or anything `np.asarray` accepts, such
as the fields of the JAX package's records) and returns the port's
objects on a given device, the card unless the caller names another
(`utils/device.py`). Descriptors arrive as uint32 words and are
held as the int32 view of the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend.residuals import KfState, PreintEdge
from .backend.solver import BAProblem
from .models.camera import Pinhole
from .utils.device import CARD, resolve


def desc_to_torch(desc, device=CARD) -> torch.Tensor:
    """[K, 8] uint32 words -> [K, 8] int32 tensor with the same bits."""
    words = np.ascontiguousarray(np.asarray(desc, np.uint32))
    return torch.from_numpy(words.view(np.int32).copy()).to(resolve(device))


def desc_to_numpy(desc) -> np.ndarray:
    """[K, 8] int32 tensor or array -> [K, 8] uint32 words (same bits)."""
    if isinstance(desc, torch.Tensor):
        desc = desc.cpu().numpy()
    return np.ascontiguousarray(np.asarray(desc, np.int32)).view(np.uint32)


def tensor(x, device=CARD) -> torch.Tensor:
    """numpy -> tensor; float64 becomes float32, uint32 descriptors become
    their int32 view, bool and integer types are kept."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return desc_to_torch(a, device)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    # np.array, not np.ascontiguousarray: the latter turns a 0-d array (a
    # record's scalar field, such as a PreintEdge's dt) into shape (1,)
    return torch.from_numpy(np.array(a, order="C")).to(resolve(device))


def pinhole(cam, device=CARD) -> Pinhole:
    """A Pinhole's fields (fx, fy, cx, cy, dist, width, height, min_x,
    min_y, max_x, max_y) -> the port's camera, bounds taken as given."""
    device = resolve(device)
    f = lambda v: torch.tensor(float(np.asarray(v)), dtype=torch.float32, device=device)
    # the whole vector, padded to five terms (Pinhole.create's rule)
    d = np.asarray(cam.dist, np.float32).reshape(-1)
    dist = np.concatenate([d, np.zeros(max(0, 5 - d.shape[0]), np.float32)])
    return Pinhole(f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy),
                   torch.as_tensor(dist, device=device), int(cam.width), int(cam.height),
                   min_x=f(cam.min_x), min_y=f(cam.min_y),
                   max_x=f(cam.max_x), max_y=f(cam.max_y))


def kf_state(s, device=CARD) -> KfState:
    """(R_wb, t_wb, v, bg, ba) arrays, single or batched over leading axes
    -> KfState of float32 tensors."""
    return KfState(*(tensor(np.asarray(a, np.float32), device) for a in s))


def preint_edge(e, device=CARD) -> PreintEdge:
    """A PreintEdge's twelve fields (single or batched) -> the port's
    record of float32 tensors."""
    return PreintEdge(*(tensor(np.asarray(a, np.float32), device) for a in e))


def ba_problem(p, device=CARD) -> BAProblem:
    """A BAProblem's fields (the JAX record, or numpy arrays in its field
    order) -> the port's BAProblem. Index arrays become int64, masks bool,
    the rest float32."""
    device = resolve(device)
    idx = lambda a: torch.as_tensor(np.array(a, np.int64), device=device)
    mask = lambda a: torch.as_tensor(np.array(a, bool), device=device)
    f32 = lambda a: tensor(np.asarray(a, np.float32), device)
    return BAProblem(
        kf=kf_state(p.kf, device), kf_dof=f32(p.kf_dof), points=f32(p.points),
        pt_active=mask(p.pt_active), obs_kf=idx(p.obs_kf), obs_pt=idx(p.obs_pt),
        obs_uv=f32(p.obs_uv), obs_inv_sigma2=f32(p.obs_inv_sigma2),
        obs_valid=mask(p.obs_valid), ie_i=idx(p.ie_i), ie_j=idx(p.ie_j),
        ie_edge=preint_edge(p.ie_edge, device), ie_valid=mask(p.ie_valid),
        walk_inv_sigma=f32(p.walk_inv_sigma), walk_valid=mask(p.walk_valid),
        prior_inv_sigma=f32(p.prior_inv_sigma), prior_ref=kf_state(p.prior_ref, device))


def vocabulary(v, device=CARD):
    """A Vocabulary's fields (the JAX package's record: uint32 node words,
    float32 idf) -> the port's Vocabulary on `device`."""
    from .ops.vocab import Vocabulary

    return Vocabulary.from_numpy(v.k, v.levels, np.asarray(v.node_desc, np.uint32),
                                 v.level_offset, np.asarray(v.word_idf, np.float32),
                                 v.group_level, device)
