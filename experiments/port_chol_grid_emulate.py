"""A numpy emulation of K4's large-D schedule (`csrc/chol_solve.cu`, the
grid route), in float32, checked against `np.linalg.solve`.

It models what the cooperative kernel does between its grid barriers: the
packed lower triangle in 16 x 16 tiles of a work buffer that every block
reads and writes through L2; phase k = -1 .. T - 1 with one barrier each,
in which every block factors diagonal tile k + 1 for itself (look-ahead:
the tile plus panel k's update, so every block holds the same non-SPD
flag), the trailing tiles (i, j), k + 2 <= j <= i, take panel k's update,
the right-hand side blocks take y_k out (the first solve's forward pass
rides along), and, after the block's own barrier, column k + 1 is updated
and solved against the fresh Li; then the leader block's substitutions,
the residual in float64 over all blocks, and the refinement's two passes.

Every task (a tile update, a column solve, a right-hand side block, a
block's factor, the leader's passes) is an actor of its own, whichever
warp the kernel gives it to. Every access goes through `Ledger`, which
fails when, inside one barrier interval, a location written by one actor
is read or written by another: either order would race on the card.

    python experiments/port_chol_grid_emulate.py
    python experiments/port_chol_grid_emulate.py --store

Prints, per D: the relative error against float64, the barriers, the tile
tasks, the work buffer's size, and whether non-SPD systems come out
all-NaN. A tile update sums a panel's 16 products first and subtracts the
sum once, as the kernel does. `--store` instead builds the last reduced
system of the full polish on chip_smoke's seeded 96-keyframe map store
(the port on the CPU, ~20 s; D = 1440, condition ~9e4) and solves it as the
kernel does now and as it did before PR 7, when each product left the
entry on its own (`one_by_one`: products below half an ulp of the entry
round away, always upward on the diagonal); for each it prints the
relative error against float64, the plain version's beside it, and the
mean of diag(L L^T - S), the bias the rounding leaves in the factor.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

NB = 16
BLOCKS = 3  # blocks whose redundant factors are emulated (the card runs one per SM)


def work_floats(T: int) -> int:
    """Floats of one system's work area (`grid_work_floats` in
    csrc/chol_solve.cu): the packed tiles, Li^T of every diagonal tile and
    four vectors."""
    return (T * (T + 1) // 2 + T) * NB * NB + 4 * T * NB


def factor_diag(A):
    """One warp's factor of a 16 x 16 tile: (Li^T, ok), Li = L^-1, with the
    pivot test `d > 0` (NaN fails it)."""
    a = A.astype(np.float32).copy()
    ok = True
    invd = np.zeros(NB, np.float32)
    for c in range(NB):
        d = a[c, c]
        ok = ok and bool(d > 0)
        with np.errstate(invalid="ignore", divide="ignore"):
            inv = np.float32(1.0) / np.sqrt(d)
        invd[c] = inv
        col = np.where(np.arange(NB) > c, a[:, c] * inv, np.float32(0))
        col[c] = d * inv
        a[:, c] = col
        a[:, c + 1:] -= np.outer(col, col[c + 1:]).astype(np.float32)
    L = np.tril(a)
    Li = np.zeros((NB, NB), np.float32)
    x = np.eye(NB, dtype=np.float32)
    for c in range(NB):
        x[c] *= invd[c]
        Li[c] = x[c]
        x[c + 1:] -= np.outer(L[c + 1:, c], x[c]).astype(np.float32)
    return Li.T.copy(), ok


class Ledger:
    """The work buffer's locations, with who touched each in the current
    barrier interval."""

    def __init__(self):
        self.data = {}
        self.writer = {}  # key -> (interval, actor) of the last write
        self.readers = {}  # key -> (interval, set of actors) of the reads
        self.interval = 0
        self.barriers = 0
        self.tasks = 0

    def read(self, actor, key):
        t, w = self.writer.get(key, (-1, None))
        assert not (t == self.interval and w != actor), f"{actor} reads {key} that {w} writes"
        it, who = self.readers.get(key, (-1, set()))
        if it != self.interval:
            who = set()
        who.add(actor)
        self.readers[key] = (self.interval, who)
        return self.data[key]

    def write(self, actor, key, value):
        t, w = self.writer.get(key, (-1, None))
        assert not (t == self.interval and w != actor), f"{actor} and {w} both write {key}"
        it, who = self.readers.get(key, (-1, set()))
        assert not (it == self.interval and who - {actor}), f"{actor} writes {key} read by {who}"
        self.data[key] = value
        self.writer[key] = (self.interval, actor)

    def sync(self):
        self.interval += 1
        self.barriers += 1


def tile_update(a, LTi, LTj, one_by_one=False):
    """a - L_i L_j^T in float32 from the transposed tiles: the 16 products
    summed, then one subtraction (the kernel's `rank_update`), or with
    `one_by_one` each product subtracted and rounded on its own (an FMA
    into the entry: exact product and difference, one rounding)."""
    if not one_by_one:
        return np.asarray(a - LTi.T @ LTj, np.float32)
    a = a.astype(np.float64)
    for m in range(NB):
        a = (a - np.outer(LTi[m].astype(np.float64), LTj[m].astype(np.float64))).astype(np.float32)
        a = a.astype(np.float64)
    return a.astype(np.float32)


def grid_solve(S, b, one_by_one=False):
    """Solve S x = b (float32, [D, D], [D]) as the grid route does (see
    `tile_update` for `one_by_one`). Returns (x, ledger, ok)."""
    D = S.shape[0]
    T = -(-D // NB)
    Dp = NB * T
    Sp = np.eye(Dp, dtype=np.float32)
    Sp[:D, :D] = S
    bp = np.zeros(Dp, np.float32)
    bp[:D] = b
    g = Ledger()
    f32 = lambda a: np.asarray(a, np.float32)
    for i in range(T):  # load: a warp per tile, the right-hand side by threads
        for j in range(i + 1):
            g.write(("load", i, j), ("A", i, j), Sp[NB * i:NB * i + NB, NB * j:NB * j + NB].copy())
        g.write(("load", i), ("b", i), bp[NB * i:NB * i + NB].copy())
    g.sync()
    ok = [True] * BLOCKS
    DB = [[None, None] for _ in range(BLOCKS)]  # each block's two Li^T buffers
    for k in range(-1, T):
        k1 = k + 1
        # warp 0 of every block: factor diagonal tile k + 1 (look-ahead)
        if k1 < T:
            for blk in range(BLOCKS):
                a = g.read(("F", blk), ("A", k1, k1))
                if k >= 0:
                    LT = g.read(("F", blk), ("A", k1, k))
                    a = tile_update(a, LT, LT, one_by_one)
                DB[blk][k1 & 1], o = factor_diag(a)
                ok[blk] = ok[blk] and o
                if blk == 0:  # the leader keeps Li^T for the solves
                    g.write(("F", 0), ("Li", k1), DB[0][k1 & 1].copy())
            assert all(np.array_equal(DB[0][k1 & 1], DB[blk][k1 & 1], equal_nan=True)
                       for blk in range(BLOCKS)), "blocks disagree on Li"
        if k >= 0:
            # trailing tiles (i, j), k + 2 <= j <= i
            for i in range(k + 2, T):
                for j in range(k + 2, i + 1):
                    me = ("A", i, j)
                    LTi = g.read(me, ("A", i, k))
                    LTj = g.read(me, ("A", j, k))
                    g.write(me, ("A", i, j), tile_update(g.read(me, ("A", i, j)), LTi, LTj, one_by_one))
                    g.tasks += 1
            # right-hand side blocks: y_k written, panel k taken out of the rest
            Dk = DB[0][k & 1]
            for i in range(k, T):
                me = ("V", i)
                y = f32(Dk.T @ g.read(me, ("b", k)))
                if i == k:
                    g.write(me, ("y", k), y)
                else:
                    LT = g.read(me, ("A", i, k))
                    g.write(me, ("b", i), f32(g.read(me, ("b", i)) - LT.T @ y))
        # (the block's own barrier: Li^T of tile k + 1 is ready) column k + 1
        if k1 < T:
            Dn = DB[0][k1 & 1]
            for i in range(k + 2, T):
                me = ("C", i)
                a = g.read(me, ("A", i, k1))
                if k >= 0:
                    a = tile_update(a, g.read(me, ("A", i, k)), g.read(me, ("A", k1, k)), one_by_one)
                g.write(me, ("A", i, k1), f32(a @ Dn).T.copy())  # stored transposed
                g.tasks += 1
        g.sync()
    assert len(set(ok)) == 1, "blocks disagree on the flag"

    lead = ("leader",)

    def solve(v, forward):
        y = v.astype(np.float32).copy()
        for k in range(T if forward else 0):
            s = y[NB * k:NB * k + NB].copy()
            for j in range(k):
                s -= g.read(lead, ("A", k, j)).T @ y[NB * j:NB * j + NB]
            y[NB * k:NB * k + NB] = g.read(lead, ("Li", k)).T @ s
        for k in range(T - 1, -1, -1):
            t = y[NB * k:NB * k + NB].copy()
            for i in range(k + 1, T):
                t -= g.read(lead, ("A", i, k)) @ y[NB * i:NB * i + NB]
            y[NB * k:NB * k + NB] = g.read(lead, ("Li", k)) @ t
        return y

    x1 = solve(np.concatenate([g.read(lead, ("y", k)) for k in range(T)]), forward=False)
    g.write(lead, ("x",), x1.copy())
    g.sync()
    for blk in range(BLOCKS):  # every block: its rows of the residual, in float64
        xs = g.read(("R", blk), ("x",)).astype(np.float64)
        rows = slice(blk, Dp, BLOCKS)
        g.write(("R", blk), ("r", blk), f32(bp[rows].astype(np.float64) - Sp[rows].astype(np.float64) @ xs))
    g.sync()
    r = np.zeros(Dp, np.float32)
    for blk in range(BLOCKS):
        r[blk::BLOCKS] = g.read(lead, ("r", blk))
    x = x1 + solve(r, forward=True)
    if not ok[0]:
        x = np.full_like(x, np.nan)
    return x[:D], g, ok[0]


def factor_of(g, T):
    """The emulated factor L [T*16, T*16] (float64): the off-diagonal tiles
    as stored (transposed), the diagonal blocks as the inverse of Li."""
    L = np.zeros((T * NB, T * NB))
    for i in range(T):
        L[NB * i:NB * i + NB, NB * i:NB * i + NB] = np.linalg.inv(
            g.data[("Li", i)].T.astype(np.float64))
        for j in range(i):
            L[NB * i:NB * i + NB, NB * j:NB * j + NB] = g.data[("A", i, j)].T
    return L


def store_polish_system():
    """The last reduced system K4 solves in the full polish of
    chip_smoke.store_ba, built by the port on the CPU."""
    import copy

    import torch

    import chip_smoke as cs
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.backend.problems import Problems
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer, ImuCalib
    from monoorbslam3_tpu_torch.models.map_state import MapStore
    from monoorbslam3_tpu_torch.ops import chol_pallas

    cpu = torch.device("cpu")
    cam = config.build_camera(config.load_settings(cs.SETTINGS / cs.EUROC_PROFILE), device=cpu)
    pr = Problems(cam, cs.store_calibration(ImuCalib, device=cpu), device=cpu)
    store, _ = cs.seeded_store(MapStore, ImuBuffer)
    with cs._Capture(chol_pallas, "chol_solve_plain", maxlen=1) as cap:
        pr.full_inertial_optimize(copy.deepcopy(store))
    S, b = cap.calls[-1]
    return S[0].numpy(), b[0].numpy()


def store_main():
    import torch

    from monoorbslam3_tpu_torch.ops.chol_pallas import chol_solve_plain

    S, b = store_polish_system()
    D = S.shape[0]
    S64 = S.astype(np.float64)
    x64 = np.linalg.solve(S64, b.astype(np.float64))
    rel = lambda x: float(np.linalg.norm(x - x64) / np.linalg.norm(x64))
    xp = chol_solve_plain(torch.as_tensor(S)[None], torch.as_tensor(b)[None])[0].numpy()
    lower = np.tril(S64) + np.tril(S64, -1).T
    print(json.dumps(dict(D=D, cond=float(np.linalg.cond(S64)), plain_rel_err_vs_f64=rel(xp))))
    for one_by_one in (False, True):
        x, g, ok = grid_solve(S, b, one_by_one)
        E = factor_of(g, -(-D // NB))[:D, :D]
        E = E @ E.T - lower
        print(json.dumps(dict(update="one product at a time (before PR 7)" if one_by_one
                              else "products summed, then subtracted (the kernel)",
                              rel_err_vs_f64=rel(x), mean_diag_bias=float(np.diag(E).mean()),
                              mean_abs_diag=float(np.abs(np.diag(E)).mean()))), flush=True)


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    if "--store" in sys.argv[1:]:
        return store_main()
    from chip_smoke import seeded_not_spd, seeded_spd

    rng = np.random.default_rng(0)
    worst = 0.0
    for D in list(range(1, 41)) + [465, 769, 1000, 1440]:
        S, b = (a[0] for a in seeded_spd(D, rng))
        x, g, ok = grid_solve(S, b)
        ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
        rel = float(np.linalg.norm(x - ref) / np.linalg.norm(ref))
        worst = max(worst, rel)
        assert ok and rel < 1e-5, (D, rel)
        T = -(-D // NB)
        assert g.barriers == T + 4, (D, g.barriers)
        if D in (16, 17, 465, 769, 1000, 1440):
            print(json.dumps(dict(D=D, rel_err_vs_f64=rel, barriers=g.barriers, tile_tasks=g.tasks,
                                  work_mb=4 * work_floats(T) / 2 ** 20)))
    print(f"SPD D = 1..40, 465, 769, 1000, 1440: worst relative error {worst:.3e} (bound 1e-5)")
    for D in (1000, 20):
        for kind in ("indefinite", "negative definite"):
            x, _, ok = grid_solve(seeded_not_spd(D, rng, kind), np.ones(D, np.float32))
            assert not ok and np.isnan(x).all(), (D, kind)
            print(f"D = {D} {kind}: flag raised, x all NaN")


if __name__ == "__main__":
    main()
