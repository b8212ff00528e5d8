"""IMU calibration and on-manifold preintegration (counterpart of
`monoorbslam3_tpu/models/imu.py`).

Forster-style preintegrated dR/dV/dP with a 15x15 covariance (the 9x9
propagated navigation block and the accumulated 6x6 bias random walk) and
the first-order bias-correction Jacobians JRg/JVg/JVa/JPg/JPa
(Imu.cpp:101-205).

- `preintegrate_tree` is the live path: adjacent segments compose in
  closed form, so a window reduces as a binary tree of log2(N) batched
  levels of small matmuls, with one Newton polar step per composition and
  no SVD (nothing reads back to the host). A window padded to 64 samples
  takes 6 levels. `preintegrate_tree_batch` reduces E windows in the same
  levels (the window BA's edges).
- `preintegrate` is the per-sample recursion as a Python loop, one SVD
  re-orthonormalization a sample: the parity reference of the tree, on no
  live path.
- `ImuBuffer` keeps the raw samples on the host (numpy), as the JAX
  package does; `integrate` runs the tree on the calibration's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import lie
from ..utils.device import CARD, resolve

GRAVITY_VALUE = 9.80  # reference: Imu.h:15
# world gravity (z up)
GRAVITY_W = np.array([0.0, 0.0, -GRAVITY_VALUE], np.float32)


class ImuCalib(NamedTuple):
    """Extrinsics + noise model (reference: Imu.cpp:16-56)."""

    R_bc: torch.Tensor  # [3, 3] camera->body rotation
    t_bc: torch.Tensor  # [3]
    R_cb: torch.Tensor  # [3, 3]
    t_cb: torch.Tensor  # [3]
    cov_noise: torch.Tensor  # [6] diagonal: gyro^2 x3, acc^2 x3 (discrete, per sample)
    cov_walk: torch.Tensor  # [6] diagonal bias random walk per sample
    bg0: torch.Tensor  # [3] initial gyro bias
    ba0: torch.Tensor  # [3] initial acc bias
    freq: float

    @staticmethod
    def create(R_bc, t_bc, noise_gyro, noise_acc, walk_gyro, walk_acc,
               bg0=None, ba0=None, freq=200.0, device=CARD) -> "ImuCalib":
        """The noise and walk parameters are CONTINUOUS densities (the
        EuRoC yaml convention); the preintegration consumes DISCRETE
        per-sample covariances, so they are discretized at the sample rate
        (the reference's sf = sqrt(freq), Imu.cpp:39-50): noise variance
        times freq, walk variance over freq."""
        f32 = dict(dtype=torch.float32, device=resolve(device))
        R_bc_h = np.asarray(R_bc, np.float32)
        t_bc_h = np.asarray(t_bc, np.float32)
        # t_cb = -R_cb t_bc as XLA's CPU dot forms it, a running FMA over
        # the columns (the float64 product is exact; one rounding a step),
        # so the calibration holds the JAX package's bits
        acc = np.zeros(3, np.float32)
        for k in range(3):
            acc = (-R_bc_h[k].astype(np.float64) * t_bc_h[k] + acc).astype(np.float32)
        R_bc = torch.as_tensor(R_bc_h, **f32)
        t_bc = torch.as_tensor(t_bc_h, **f32)
        R_cb = R_bc.T.contiguous()
        t_cb = torch.as_tensor(acc, **f32)
        cov_noise = torch.tensor([noise_gyro**2 * freq] * 3 + [noise_acc**2 * freq] * 3, **f32)
        cov_walk = torch.tensor([walk_gyro**2 / freq] * 3 + [walk_acc**2 / freq] * 3, **f32)
        bias = lambda b: torch.zeros(3, **f32) if b is None else torch.as_tensor(
            np.asarray(b, np.float32), **f32)
        return ImuCalib(R_bc, t_bc, R_cb, t_cb, cov_noise, cov_walk, bias(bg0), bias(ba0),
                        float(freq))


def _mv(M, x):
    return torch.einsum("...ij,...j->...i", M, x)


class Preintegrated(NamedTuple):
    """Result of preintegrating one sample window at a fixed linearization bias."""

    dR: torch.Tensor  # [3, 3]
    dV: torch.Tensor  # [3]
    dP: torch.Tensor  # [3]
    C: torch.Tensor  # [15, 15] covariance (r, v, p, bg, ba)
    JRg: torch.Tensor  # [3, 3] d(dR)/d(bg)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dt: torch.Tensor  # [] total time
    bg: torch.Tensor  # [3] linearization gyro bias
    ba: torch.Tensor  # [3] linearization acc bias

    # --- first-order bias-corrected deltas (reference: Imu.cpp:182-204) ---

    def delta_rotation(self, bg_new: torch.Tensor) -> torch.Tensor:
        """dR Exp(JRg (bg_new - bg)), re-orthonormalized. The JAX package
        projects with an SVD (`lie.normalize_rotation`); the product of two
        rotations is off SO(3) by rounding only, and there the converged
        polar factor (`lie.polar_rotation`) is the same U V^T without the
        SVD's host-side status check."""
        return lie.polar_rotation(self.dR @ lie.exp_so3(_mv(self.JRg, bg_new - self.bg)))

    def delta_velocity(self, bg_new: torch.Tensor, ba_new: torch.Tensor) -> torch.Tensor:
        return self.dV + _mv(self.JVg, bg_new - self.bg) + _mv(self.JVa, ba_new - self.ba)

    def delta_position(self, bg_new: torch.Tensor, ba_new: torch.Tensor) -> torch.Tensor:
        return self.dP + _mv(self.JPg, bg_new - self.bg) + _mv(self.JPa, ba_new - self.ba)


def _empty_state(bg, ba) -> Preintegrated:
    f32 = dict(dtype=torch.float32, device=bg.device)
    z33 = torch.zeros((3, 3), **f32)
    return Preintegrated(
        dR=torch.eye(3, **f32), dV=torch.zeros(3, **f32), dP=torch.zeros(3, **f32),
        C=torch.zeros((15, 15), **f32), JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        dt=torch.zeros((), **f32), bg=bg, ba=ba)


def _as_f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=device)


def preintegrate(gyro, acc, dts, mask, bg, ba, calib: ImuCalib) -> Preintegrated:
    """PreIntegrator::IntegrateNewMeasurement (Imu.cpp:101-148), one sample
    at a time. gyro, acc [N, 3], dts [N], mask [N] (padded samples are a
    strict no-op), bg, ba [3]: the linearization biases."""
    dev = calib.cov_noise.device
    gyro, acc, dts, maskf = (_as_f32(x, dev) for x in (gyro, acc, dts, mask))
    bg, ba = _as_f32(bg, dev), _as_f32(ba, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cov_noise = torch.diag(calib.cov_noise)
    cov_walk15 = torch.zeros((15, 15), **f32)
    cov_walk15[9:, 9:] = torch.diag(calib.cov_walk)
    eye3, eye9 = torch.eye(3, **f32), torch.eye(9, **f32)

    s = _empty_state(bg, ba)
    for k in range(gyro.shape[0]):
        g, a_raw, dt, m = gyro[k], acc[k], dts[k], maskf[k]
        w = g - bg
        a = a_raw - ba
        dt2 = dt * dt

        dP = s.dP + s.dV * dt + 0.5 * dt2 * (s.dR @ a)
        dV = s.dV + dt * (s.dR @ a)
        dR_ahat = s.dR @ lie.hat(a)

        # A [9, 9], B [9, 6] exactly as Imu.cpp:105-138 (state order r, v, p)
        A = eye9.clone()
        A[3:6, 0:3] = -dR_ahat * dt
        A[6:9, 0:3] = -0.5 * dR_ahat * dt2
        A[6:9, 3:6] = eye3 * dt
        B = torch.zeros((9, 6), **f32)
        B[3:6, 3:6] = s.dR * dt
        B[6:9, 3:6] = 0.5 * s.dR * dt2

        JPg = s.JPg + s.JVg * dt - 0.5 * dt2 * (dR_ahat @ s.JRg)
        JPa = s.JPa + s.JVa * dt - 0.5 * dt2 * s.dR
        JVg = s.JVg - dt * (dR_ahat @ s.JRg)
        JVa = s.JVa - dt * s.dR

        delta_w = w * dt
        deltaR = lie.exp_so3(delta_w)
        rightJ = lie.right_jacobian_so3(delta_w)
        dR = lie.normalize_rotation(s.dR @ deltaR)

        A[0:3, 0:3] = deltaR.T
        B[0:3, 0:3] = rightJ * dt

        C = s.C.clone()
        C[:9, :9] = A @ s.C[:9, :9] @ A.T + B @ cov_noise @ B.T
        C = C + cov_walk15
        JRg = deltaR.T @ s.JRg - rightJ * dt

        new = Preintegrated(dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa,
                            JPg=JPg, JPa=JPa, dt=s.dt + dt, bg=s.bg, ba=s.ba)
        s = Preintegrated(*(m * n + (1.0 - m) * o for n, o in zip(new, s)))
    return s


# ---------------------------------------------------------------------------
# Tree (associative) preintegration: the live path.
#
# Preintegrated segments form a monoid: two adjacent segments compose in
# closed form (state deltas, the 9x9 error transition A, the accumulated
# covariance and the five bias Jacobians), derived from the per-sample
# recursion, so the window reduces as a binary tree. Segment 2's transition
# is re-expressed in segment 1's start frame by conjugating with
# Gamma(dR1) = blockdiag(I, dR1, dR1): A_ctx = Gamma(dR1) A2 Gamma(dR1)^T.
# ---------------------------------------------------------------------------


class _Seg(NamedTuple):
    dR: torch.Tensor   # [..., 3, 3]
    dV: torch.Tensor   # [..., 3]
    dP: torch.Tensor   # [..., 3]
    dt: torch.Tensor   # [...]
    A: torch.Tensor    # [..., 9, 9] standalone error transition (r, v, p)
    C9: torch.Tensor   # [..., 9, 9] accumulated measurement-noise covariance
    JRg: torch.Tensor  # [..., 3, 3]
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    n: torch.Tensor    # [...] number of (real) samples: scales the bias walk


def _blocks(rows) -> torch.Tensor:
    """[[N, 3, 3] blocks] rows -> [N, 3 * len(rows), 3 * len(row)]."""
    return torch.cat([torch.cat(row, dim=-1) for row in rows], dim=-2)


def _leaf_segments(gyro, acc, dts, maskf, bg, ba, calib: ImuCalib) -> _Seg:
    """Single-sample segments; a masked sample is the exact identity
    element (dt = 0: dR = I, A = I, C = 0, J = 0)."""
    dt = dts * maskf  # [N]
    w = (gyro - bg) * maskf[:, None]
    a = (acc - ba) * maskf[:, None]
    dt_ = dt[:, None, None]
    dt2_ = (dt * dt)[:, None, None]

    # exp and Jr of the same increment share theta, hat and hat^2
    wdt = w * dt[:, None]
    Aw, Bw, Cw = lie.exp_jr_coeffs(wdt)
    Wh = lie.hat(wdt)
    W2h = Wh @ Wh
    N = gyro.shape[0]
    eye3 = torch.eye(3, dtype=torch.float32, device=gyro.device).expand(N, 3, 3)
    z33 = torch.zeros((N, 3, 3), dtype=torch.float32, device=gyro.device)
    dR = eye3 + Aw[:, None, None] * Wh + Bw[:, None, None] * W2h
    Jr = eye3 - Bw[:, None, None] * Wh + Cw[:, None, None] * W2h
    a_hat = lie.hat(a)

    A = _blocks([[dR.transpose(-1, -2), z33, z33],
                 [-a_hat * dt_, eye3, z33],
                 [-0.5 * a_hat * dt2_, eye3 * dt_, eye3]])

    # C9 = B Sigma_noise B^T with B = [[Jr dt, 0], [0, I dt], [0, 0.5 I dt^2]]
    sg = calib.cov_noise[:3]
    diag_a = torch.diag(calib.cov_noise[3:]).expand(N, 3, 3)
    JrD = Jr * dt_
    C9 = _blocks([[torch.einsum("nij,j,nkj->nik", JrD, sg, JrD), z33, z33],
                  [z33, diag_a * dt2_, diag_a * 0.5 * dt_ * dt2_],
                  [z33, diag_a * 0.5 * dt_ * dt2_, diag_a * 0.25 * dt2_ * dt2_]])

    return _Seg(dR=dR, dV=a * dt[:, None], dP=0.5 * a * (dt * dt)[:, None], dt=dt,
                A=A, C9=C9, JRg=-JrD, JVg=z33, JVa=-eye3 * dt_, JPg=z33,
                JPa=-0.5 * eye3 * dt2_, n=maskf)


def _compose_segments(s1: _Seg, s2: _Seg) -> _Seg:
    """Batched monoid op: s1 (earlier) then s2 (later)."""
    dR1, dR2 = s1.dR, s2.dR
    dR1T = dR1.transpose(-1, -2)
    dt2 = s2.dt[..., None]

    # the product of two rotations is near-SO(3): one Newton polar step
    # (eps -> O(eps^2)) in place of a batched SVD
    dR = dR1 @ dR2
    eye3 = torch.eye(3, dtype=torch.float32, device=dR.device).expand(dR.shape)
    dR = dR @ (1.5 * eye3 - 0.5 * (dR.transpose(-1, -2) @ dR))
    dV = s1.dV + _mv(dR1, s2.dV)
    dP = s1.dP + s1.dV * dt2 + _mv(dR1, s2.dP)

    def gamma_left(M):  # Gamma(dR1) @ M: v/p block-rows times dR1
        return torch.cat([M[:, 0:3, :], dR1 @ M[:, 3:6, :], dR1 @ M[:, 6:9, :]], dim=1)

    def gamma_right_T(M):  # M @ Gamma(dR1)^T: v/p block-columns times dR1^T
        return torch.cat([M[:, :, 0:3], M[:, :, 3:6] @ dR1T, M[:, :, 6:9] @ dR1T], dim=2)

    A2 = s2.A
    A_ctx = gamma_right_T(gamma_left(A2))
    A = A_ctx @ s1.A
    C9 = (A_ctx @ s1.C9) @ A_ctx.transpose(-1, -2) + gamma_right_T(gamma_left(s2.C9))

    A2_vt = A2[:, 3:6, 0:3]
    A2_pt = A2[:, 6:9, 0:3]
    JRg = dR2.transpose(-1, -2) @ s1.JRg + s2.JRg
    JVg = s1.JVg + dR1 @ (s2.JVg + A2_vt @ s1.JRg)
    JVa = s1.JVa + dR1 @ s2.JVa
    JPg = s1.JPg + s1.JVg * dt2[..., None] + dR1 @ (s2.JPg + A2_pt @ s1.JRg)
    JPa = s1.JPa + s1.JVa * dt2[..., None] + dR1 @ s2.JPa

    return _Seg(dR=dR, dV=dV, dP=dP, dt=s1.dt + s2.dt, A=A, C9=C9,
                JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, n=s1.n + s2.n)


def _pad_samples(n, *xs):
    """Pad the sample axis (the second to last of gyro/acc, the last of
    dts/mask) to the next power of two; padded samples are masked."""
    n_pad = max(1, 1 << (n - 1).bit_length())
    if n_pad == n:
        return xs
    pad = n_pad - n
    gyro, acc, dts, maskf = xs
    return (torch.nn.functional.pad(gyro, (0, 0, 0, pad)),
            torch.nn.functional.pad(acc, (0, 0, 0, pad)),
            torch.nn.functional.pad(dts, (0, pad)),
            torch.nn.functional.pad(maskf, (0, pad)))


def _reduce(seg: _Seg, n_out: int) -> _Seg:
    """Compose adjacent pairs of a flat segment batch until `n_out` remain:
    the windows are contiguous runs of a power-of-two length, so every pair
    lies inside one window and all windows reduce in the same levels."""
    while seg.dt.shape[0] > n_out:
        seg = _compose_segments(_Seg(*(x[0::2] for x in seg)), _Seg(*(x[1::2] for x in seg)))
    return seg


def preintegrate_tree(gyro, acc, dts, mask, bg, ba, calib: ImuCalib) -> Preintegrated:
    """The tree reduction of `preintegrate`: the same result to f32
    rounding in log2(N) batched levels. Inputs as `preintegrate`'s (numpy
    or tensors); the work runs on the calibration's device."""
    dev = calib.cov_noise.device
    gyro, acc, dts, maskf = (_as_f32(x, dev) for x in (gyro, acc, dts, mask))
    bg, ba = _as_f32(bg, dev), _as_f32(ba, dev)
    gyro, acc, dts, maskf = _pad_samples(gyro.shape[0], gyro, acc, dts, maskf)

    seg = _reduce(_leaf_segments(gyro, acc, dts, maskf, bg, ba, calib), 1)
    seg = _Seg(*(x[0] for x in seg))

    C = torch.nn.functional.pad(seg.C9, (0, 6, 0, 6)) + torch.diag(
        torch.nn.functional.pad(seg.n * calib.cov_walk, (9, 0)))
    return Preintegrated(dR=seg.dR, dV=seg.dV, dP=seg.dP, C=C, JRg=seg.JRg, JVg=seg.JVg,
                         JVa=seg.JVa, JPg=seg.JPg, JPa=seg.JPa, dt=seg.dt, bg=bg, ba=ba)


def preintegrate_tree_batch(gyro, acc, dts, mask, bg, ba, calib: ImuCalib) -> Preintegrated:
    """`preintegrate_tree` over a leading axis of E windows, each at its own
    linearization bias (the JAX package's `Problems._preint_batch`, a vmap
    of the tree): gyro, acc [E, N, 3], dts, mask [E, N], bg, ba [E, 3] ->
    a Preintegrated with a leading E axis. The E x N samples form one flat
    segment batch, so all windows reduce together in log2(N) levels (the
    launches do not grow with E)."""
    dev = calib.cov_noise.device
    gyro, acc, dts, maskf = (_as_f32(x, dev) for x in (gyro, acc, dts, mask))
    bg, ba = _as_f32(bg, dev), _as_f32(ba, dev)
    E = gyro.shape[0]
    gyro, acc, dts, maskf = _pad_samples(gyro.shape[1], gyro, acc, dts, maskf)
    N = gyro.shape[1]

    seg = _leaf_segments(gyro.reshape(E * N, 3), acc.reshape(E * N, 3), dts.reshape(E * N),
                         maskf.reshape(E * N), bg.repeat_interleave(N, 0),
                         ba.repeat_interleave(N, 0), calib)
    seg = _reduce(seg, E)

    C = torch.nn.functional.pad(seg.C9, (0, 6, 0, 6)) + torch.diag_embed(
        torch.nn.functional.pad(seg.n[:, None] * calib.cov_walk, (9, 0)))
    return Preintegrated(dR=seg.dR, dV=seg.dV, dP=seg.dP, C=C, JRg=seg.JRg, JVg=seg.JVg,
                         JVa=seg.JVa, JPg=seg.JPg, JPa=seg.JPa, dt=seg.dt, bg=bg, ba=ba)


class ImuBuffer:
    """Host-side raw-sample store backing one preintegration window
    (PreIntegrator::measurements, Imu.h:134): raw (gyro, acc, dt) kept so
    the window can be re-integrated at a new bias or merged into a
    neighbour by re-running the reduction."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self.gyro = np.zeros((capacity, 3), np.float32)
        self.acc = np.zeros((capacity, 3), np.float32)
        self.dts = np.zeros(capacity, np.float32)
        self.n = 0

    def add(self, gyro, acc, dt):
        if self.n >= self.capacity:
            self._grow()
        self.gyro[self.n] = gyro
        self.acc[self.n] = acc
        self.dts[self.n] = dt
        self.n += 1

    def _grow(self):
        new_cap = self.capacity * 2
        for name in ("gyro", "acc"):
            arr = np.zeros((new_cap, 3), np.float32)
            arr[: self.n] = getattr(self, name)[: self.n]
            setattr(self, name, arr)
        dts = np.zeros(new_cap, np.float32)
        dts[: self.n] = self.dts[: self.n]
        self.dts = dts
        self.capacity = new_cap

    def extend(self, other: "ImuBuffer"):
        for i in range(other.n):
            self.add(other.gyro[i], other.acc[i], other.dts[i])

    def clear(self):
        self.n = 0

    def decimated(self, cap: int) -> "ImuBuffer":
        """Time-weighted pairwise merge until n <= cap: a merged window keeps
        its whole time span (`padded` would truncate it), at the cost of
        bandwidth that the edge's integration-noise floor models."""
        if self.n <= cap:
            return self
        out = ImuBuffer(self.capacity)
        g, a, d, n = self.gyro, self.acc, self.dts, self.n
        while n > cap:
            m = n // 2
            dt2 = d[: 2 * m : 2] + d[1 : 2 * m : 2]
            w = np.maximum(dt2, 1e-9)[:, None]
            g2 = (g[: 2 * m : 2] * d[: 2 * m : 2, None]
                  + g[1 : 2 * m : 2] * d[1 : 2 * m : 2, None]) / w
            a2 = (a[: 2 * m : 2] * d[: 2 * m : 2, None]
                  + a[1 : 2 * m : 2] * d[1 : 2 * m : 2, None]) / w
            if n % 2:
                g = np.concatenate([g2, g[n - 1 : n]])
                a = np.concatenate([a2, a[n - 1 : n]])
                d = np.concatenate([dt2, d[n - 1 : n]])
                n = m + 1
            else:
                g, a, d, n = g2, a2, dt2, m
        out.gyro[:n], out.acc[:n], out.dts[:n] = g[:n], a[:n], d[:n]
        out.n = n
        return out

    def padded(self, capacity: int | None = None):
        """(gyro, acc, dts, mask) padded to a power-of-two capacity of at
        least 64, as the JAX package pads them."""
        cap = capacity or max(64, 1 << (max(1, self.n - 1)).bit_length())
        g = np.zeros((cap, 3), np.float32)
        a = np.zeros((cap, 3), np.float32)
        d = np.zeros(cap, np.float32)
        m = np.zeros(cap, np.float32)
        k = min(self.n, cap)
        g[:k] = self.gyro[:k]
        a[:k] = self.acc[:k]
        d[:k] = self.dts[:k]
        m[:k] = 1.0
        return g, a, d, m

    def integrate(self, bg, ba, calib: ImuCalib, capacity: int | None = None) -> Preintegrated:
        """`preintegrate_tree` of the padded window on the calibration's
        device. On the card the samples go up through pinned memory without
        a host wait; bg and ba may be tensors already there."""
        dev = calib.cov_noise.device
        g, a, d, m = (_upload(x, dev) for x in self.padded(capacity))
        bg, ba = (b if isinstance(b, torch.Tensor) else _upload(np.asarray(b, np.float32), dev)
                  for b in (bg, ba))
        return preintegrate_tree(g, a, d, m, bg, ba, calib)


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; to the card through pinned memory
    with a non-blocking copy (a copy from pageable memory waits for the
    device's queue)."""
    t = torch.from_numpy(np.array(x, order="C"))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
