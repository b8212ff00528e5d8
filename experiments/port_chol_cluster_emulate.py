"""A numpy emulation of K4's cluster schedule (`csrc/chol_solve.cu`, the
cluster route), in float32, checked against `np.linalg.solve`.

It models what the CUDA kernel does, rank by rank: the row-block-cyclic
ownership of the padded lower triangle (row block i of 16 rows on rank
i mod C), the panel order with its one cluster barrier per panel and the
look-ahead update of the next diagonal tile, the first solve's forward
pass folded into the panels (right-hand side blocks owned like rows), the
redundant factor of each diagonal tile on every rank (so every rank holds
the same non-SPD flag),
the column gather, the rank-0 substitutions that read the other ranks'
tiles, and the f64 residual of the refinement step. Every access to
another rank's tiles goes through `Cluster.remote`, which checks that the
tile was last written before the most recent cluster barrier, and every
write checks that no peer read the tile since that barrier (either order
in one barrier interval would race on the card); `remote` also
counts the bytes each rank reads from each peer.

    python experiments/port_chol_cluster_emulate.py

Prints, per D: the relative error against float64, the bytes read
remotely, the barriers, the shared memory each rank needs, and whether the
non-SPD systems come out all-NaN.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

NB = 16
CLUSTER = 8  # blocks per cluster of the kernel (kCluster in csrc/chol_solve.cu)
VEC = -1  # key of a row block's right-hand side block beside its tiles (i, j)
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into on an H100
MAX_T = 48  # 16 warps x 3 tiles


def smem_bytes(T: int, C: int) -> int:
    """Dynamic shared memory of one block of the cluster route (the same
    layout as `cluster_smem_bytes` in csrc/chol_solve.cu): the largest
    rank's row strips, the gathered panel column (T - 1 tiles, at least
    one: after the factor it holds the solves' scratch), two diagonal
    buffers, the right-hand side and residual vectors of 16 T floats each,
    and the pivot flag."""
    tiles = max(sum(i + 1 for i in range(r, T, C)) for r in range(min(C, T)))
    return 4 * (NB * NB * (tiles + max(T - 1, 1) + 2) + 2 * NB * T) + 16


def max_cluster_d(C: int, limit: int = SMEM_LIMIT) -> int:
    """The cluster route's capacity: shared memory, and at most MAX_T row
    blocks (the substitutions keep 3 tiles per warp in registers)."""
    T = 1
    while T < MAX_T and smem_bytes(T + 1, C) <= limit:
        T += 1
    return NB * T


def factor_diag(A):
    """One warp's factor of a 16 x 16 tile: returns (Li^T, ok), Li = L^-1,
    with the pivot test `d > 0` (NaN fails it)."""
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


class Cluster:
    """Ranks, their tiles, barrier intervals and the remote-read ledger."""

    def __init__(self, T, C):
        self.T, self.C = T, C
        self.tiles = [dict() for _ in range(C)]  # (i, j) -> [16, 16]
        self.stamp = [dict() for _ in range(C)]  # (i, j) -> interval last written
        self.read = [dict() for _ in range(C)]  # (i, j) -> interval last read by a peer
        self.interval = 0
        self.barriers = 0
        self.remote_bytes = np.zeros((C, C), np.int64)

    def owner(self, i):
        return i % self.C

    def write(self, i, j, tile):
        r = self.owner(i)
        assert self.read[r].get((i, j), -1) < self.interval, f"peer still reads tile {(i, j)}"
        self.tiles[r][i, j] = tile
        self.stamp[r][i, j] = self.interval

    def local(self, rank, i, j):
        assert self.owner(i) == rank
        return self.tiles[rank][i, j]

    def remote(self, rank, i, j):
        """Rank `rank` reads tile (i, j) from its owner."""
        o = self.owner(i)
        if o != rank:
            assert self.stamp[o][i, j] < self.interval, f"race on tile {(i, j)}"
            self.read[o][i, j] = self.interval
            self.remote_bytes[rank, o] += self.tiles[o][i, j].nbytes
        return self.tiles[o][i, j]

    def sync(self):
        self.interval += 1
        self.barriers += 1


def cluster_solve(S, b, C):
    """Solve S x = b (float32, [D, D], [D]) as the cluster route does.
    Returns (x, cluster, ok)."""
    D = S.shape[0]
    T = -(-D // NB)
    Dp = NB * T
    Sp = np.eye(Dp, dtype=np.float32)
    Sp[:D, :D] = S
    bp = np.zeros(Dp, np.float32)
    bp[:D] = b
    cl = Cluster(T, C)
    blk = lambda M, i, j: M[NB * i:NB * i + NB, NB * j:NB * j + NB]
    for i in range(T):  # each rank loads its row strips and right-hand side blocks
        for j in range(i + 1):
            cl.write(i, j, blk(Sp, i, j).copy())
        cl.write(i, VEC, bp[NB * i:NB * i + NB].copy())
    cl.sync()
    ok = [True] * C
    DB = [None] * C
    for r in range(C):  # warp 0 of every rank: diagonal tile 0
        DB[r], o = factor_diag(cl.remote(r, 0, 0))
        ok[r] = ok[r] and o
    for k in range(T):
        mine = lambda r: [i for i in range(k + 1, T) if cl.owner(i) == r]
        for r in range(C):
            # (b) solve the own tiles of column k, store them transposed
            for i in mine(r):
                A = cl.local(r, i, k)
                cl.write(i, k, (A @ DB[r]).T.astype(np.float32).copy())
            # the first solve's forward pass: the owner of k turns b_k into y_k
            if cl.owner(k) == r:
                cl.write(k, VEC, (DB[r].T @ cl.local(r, k, VEC)).astype(np.float32))
            # (c) look-ahead: the owner of k + 1 updates its diagonal tile
            if k + 1 < T and cl.owner(k + 1) == r:
                LT = cl.local(r, k + 1, k)
                cl.write(k + 1, k + 1, (cl.local(r, k + 1, k + 1) - LT.T @ LT).astype(np.float32))
        cl.sync()
        P = [dict() for _ in range(C)]
        for r in range(C):
            # (e) gather column k; the owner of k stores Li_kk^T in the diagonal slot
            top = max(mine(r), default=k)
            for j in range(k + 1, top + 1):
                P[r][j] = cl.remote(r, j, k).copy()
            if cl.owner(k) == r:
                cl.write(k, k, DB[r].copy())
        for r in range(C):
            # (f) warp 0: factor the next diagonal tile (final since the barrier)
            if k + 1 < T:
                DB[r], o = factor_diag(cl.remote(r, k + 1, k + 1))
                ok[r] = ok[r] and o
            # warps 4, 8, 12: take y_k out of the own right-hand side blocks
            if mine(r):
                yk = cl.remote(r, k, VEC)
                for i in mine(r):
                    cl.write(i, VEC, (cl.local(r, i, VEC) - cl.local(r, i, k).T @ yk).astype(np.float32))
            # the other warps: trailing update of the own tiles
            for i in mine(r):
                for j in range(k + 1, i + 1):
                    if i == j == k + 1:
                        continue
                    upd = P[r][i].T @ P[r][j]
                    cl.write(i, j, (cl.local(r, i, j) - upd).astype(np.float32))
    cl.sync()
    assert len(set(ok)) == 1, "ranks disagree on the flag"

    def solve(v, forward=True):  # rank 0: forward, then back substitution
        y = v.astype(np.float32).copy()
        for k in range(T if forward else 0):
            s = y[NB * k:NB * k + NB].copy()
            for j in range(k):
                s -= cl.remote(0, k, j).T @ y[NB * j:NB * j + NB]
            y[NB * k:NB * k + NB] = cl.remote(0, k, k).T @ s
        for k in range(T - 1, -1, -1):
            t = y[NB * k:NB * k + NB].copy()
            for i in range(k + 1, T):
                t -= cl.remote(0, i, k) @ y[NB * i:NB * i + NB]
            y[NB * k:NB * k + NB] = cl.remote(0, k, k) @ t
        return y

    y = np.concatenate([cl.remote(0, k, VEC) for k in range(T)])  # rank 0 gathers y
    x1 = solve(y, forward=False)
    cl.sync()  # every rank reads x from rank 0, residual rows of its own strips
    r64 = bp.astype(np.float64) - Sp.astype(np.float64) @ x1.astype(np.float64)
    cl.sync()  # residual rows written into rank 0
    x = x1 + solve(r64.astype(np.float32))
    cl.sync()  # no rank leaves while rank 0 reads its tiles
    if not ok[0]:
        x = np.full_like(x, np.nan)
    return x[:D], cl, ok[0]


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from chip_smoke import seeded_not_spd, seeded_spd

    C = CLUSTER
    rng = np.random.default_rng(0)
    worst = 0.0
    for D in list(range(1, 101)) + [465, 480, 1440]:
        S, b = (a[0] for a in seeded_spd(D, rng))
        x, cl, ok = cluster_solve(S, b, C)
        ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
        rel = float(np.linalg.norm(x - ref) / np.linalg.norm(ref))
        worst = max(worst, rel)
        assert ok and rel < 1e-5, (D, rel)
        if D in (16, 17, 100, 465, 480, 1440):
            T = -(-D // NB)
            print(json.dumps(dict(D=D, rel_err_vs_f64=rel, cluster=C, barriers=cl.barriers,
                                  remote_kb_per_rank=(cl.remote_bytes.sum(1) / 1024).tolist(),
                                  smem_bytes=smem_bytes(T, C),
                                  fits=smem_bytes(T, C) <= SMEM_LIMIT and T <= MAX_T)))
    print(f"SPD D = 1..100, 465, 480, 1440: worst relative error {worst:.3e} (bound 1e-5)")
    for D in (480, 20):
        for kind in ("indefinite", "negative definite"):
            x, _, ok = cluster_solve(seeded_not_spd(D, rng, kind), np.ones(D, np.float32), C)
            assert not ok and np.isnan(x).all(), (D, kind)
            print(f"D = {D} {kind}: flag raised, x all NaN")
    for c in (4, 8, 16):
        print(f"cluster {c}: largest D of the cluster route {max_cluster_d(c)}")


if __name__ == "__main__":
    main()
