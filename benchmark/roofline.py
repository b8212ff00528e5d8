"""The yardstick's roofline arithmetic: the published peaks of one NVIDIA
H100 SXM (NVIDIA's data sheet, dense rates, at the full power limit of
700 W) and each hand kernel's operations and bytes from its shapes (a copy
of the port's `measure/timing.bound`, `k2_bound` and `k4_bound`).

A kernel's roofline share is the least time the card could take for the
work of its launches (the larger of their bytes over the HBM rate and
their operations over the peak rate of their type) over the device time
those launches took. Each input byte counts once and each output byte
once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

# K2's float32 work a pair: q = dx*dx + dy*dy (5), q against both r^2 (2),
# the group compare (1), the select of the gated distance (1) and the two
# compares of the running top-2 (2)
K2_GATE_OPS = 11


def bound_s(n_bytes, ops=()) -> float:
    """The least seconds: bytes over the HBM rate, or the largest of the
    (count, peak) operation terms (the types run on separate units)."""
    return max([n_bytes / HBM_BYTES_PER_S] + [count / peak for count, peak in ops])


def match_rows(N: int, M: int) -> float:
    """K2 (`csrc/match_rows.cu`), N rows against M columns: both sides'
    descriptors (32 bytes) and five per-side float32 vectors read, best,
    second and idx written; the Hamming distances as a depth-256 binary
    product (2 x 256 operations a pair) at the int8 tensor peak, and the
    gate and running top-2 at the float32 peak."""
    return bound_s((N + M) * (32 + 5 * 4) + 12 * N,
                   [(2 * 256 * N * M, INT8_OPS_PER_S), (K2_GATE_OPS * N * M, F32_OPS_PER_S)])


def chol_solve(G: int, D: int) -> float:
    """K4 (`csrc/chol_solve.cu`, both routes), G systems of size D: S and b
    read and x written; the factor (D^3/3 multiply-adds), four triangular
    solves and the refinement's residual (6 D^2) at the float32 peak."""
    return bound_s(4 * G * (D * D + 2 * D), [(G * (2 * D ** 3 / 3 + 6 * D * D), F32_OPS_PER_S)])


def hamming(N: int, M: int) -> float:
    """K3 (`csrc/hamming.cu`): both sides' descriptors read, the [N, M]
    int32 block written; the distances at the int8 peak."""
    return bound_s((N + M) * 32 + 4 * N * M, [(2 * 256 * N * M, INT8_OPS_PER_S)])


# the kernels' names in a device trace, and the bound of one launch from
# the shapes the harness logs at the kernel's wrapper
KERNELS = {
    "match_rows": (("match_rows_kernel",), match_rows),
    "chol_solve": (("chol_cluster_kernel", "chol_grid_kernel"), chol_solve),
    "hamming": (("hamming_kernel",), hamming),
}
