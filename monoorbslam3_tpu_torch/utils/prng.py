"""The JAX package's RANSAC draws, reproduced bit for bit in numpy.

The JAX package seeds its tracker with `jax.random.PRNGKey(seed)`, splits
the key once per bootstrap attempt and draws the two-view RANSAC's
`[200, 8]` sample indices with
`jax.random.choice(key, N, (200, 8), p=valid / n_valid)`. This module
computes the same keys and the same indices on the host, with numpy only,
so that the port's seed s bootstraps from the samples of the JAX
package's seed s. It follows JAX 0.9's default threefry implementation
with `jax_threefry_partitionable=True`:

- `prng_key`: `jax/_src/prng.py` `_threefry_seed` (x64 off: the seed's low
  32 bits in the second word, 0 in the first);
- `threefry2x32`: `jax/_src/prng.py` `_threefry2x32_lowering` (20 rounds,
  rotations 13/15/26/6 and 17/29/16/24, key schedule with 0x1BD11BDA);
- `split`: `jax/_src/prng.py` `_threefry_split_foldlike` (counters
  `iota_2x32_shape((2,))`: high words 0, low words 0 and 1);
- `uniform`: `jax/_src/prng.py` `_threefry_random_bits_partitionable`
  (`bits1 ^ bits2` over the counters 0..n-1) and `jax/_src/random.py`
  `_uniform` (23 mantissa bits under the exponent of 1.0, minus 1);
- `choice_with_p`: `jax/_src/random.py` `choice` with `replace=True`
  (`r = cumsum(p)[-1] * (1 - u)`, `searchsorted(cumsum(p), r)`), the
  probabilities as `monoorbslam3_tpu/ops/twoview.py` builds them;
- `xla_cumsum`: the order of XLA's CPU rewrite of the `reduce_window` that
  `jnp.cumsum` lowers to (`jax/_src/lax/control_flow/loops.py`
  `_cumulative_reduction_primitive`): sequential sums inside blocks of 16,
  the block totals prefix-summed the same way, each block offset by the
  exclusive prefix of the blocks before it. The draws hang on this order: a
  sequential float32 cumsum, or float64 rounded once, misses some;
- `searchsorted_left`: `jax/_src/numpy/lax_numpy.py`
  `_searchsorted_via_scan` (the binary search of `method="scan"`).
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_BLOCK = 16  # XLA's base length for the cumsum rewrite


def prng_key(seed) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` (x64 off) as a uint32 [2] array:
    `[0, seed mod 2**32]` for any integer in [-2**63, 2**63)."""
    if isinstance(seed, (float, np.floating)) or not isinstance(seed, (int, np.integer)):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    s = int(seed)
    if not -(2 ** 63) <= s < 2 ** 63:
        raise OverflowError(f"seed {s} does not fit 64 bits")
    return np.array([0, s & 0xFFFFFFFF], _U32)


def _rotl(x, d):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) (uint32 arrays
    of one shape) under the key (k1, k2). Returns the two uint32 words."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, _U32) + ks[0]
        x1 = np.asarray(x1, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def split(key):
    """`jax.random.split(key)`: the two new keys, each a uint32 [2]."""
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(2, _U32), np.arange(2, dtype=_U32))
    return np.array([b1[0], b2[0]], _U32), np.array([b1[1], b2[1]], _U32)


def uniform(key, shape) -> np.ndarray:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    n = int(np.prod(shape))
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(n, _U32), np.arange(n, dtype=_U32))
    bits = ((b1 ^ b2) >> _U32(9)) | _U32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


def xla_cumsum(x) -> np.ndarray:
    """The float32 inclusive prefix sum of the 1-D `x` in the order of
    XLA's CPU lowering of `jnp.cumsum` (module docstring)."""
    x = np.asarray(x, np.float32)
    n = len(x)
    if n <= _BLOCK:
        return np.cumsum(x, dtype=np.float32)
    nb = -(-n // _BLOCK)
    blocks = np.zeros((nb, _BLOCK), np.float32)
    blocks.reshape(-1)[:n] = x
    local = np.cumsum(blocks, axis=1, dtype=np.float32)  # sequential per row
    incl = xla_cumsum(local[:, -1])  # the block totals, the same way
    offset = np.concatenate([np.zeros(1, np.float32), incl[:-1]])
    return (local + offset[:, None]).reshape(-1)[:n]


def searchsorted_left(a, v) -> np.ndarray:
    """`jnp.searchsorted(a, v)` (side "left", method "scan"): for each
    query, the binary search's index of the first element not below it."""
    a = np.asarray(a)
    v = np.asarray(v)
    n = len(a)
    low = np.zeros(v.shape, np.int64)
    high = np.full(v.shape, n, np.int64)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = v <= a[np.minimum(mid, n - 1)]
        low, high = np.where(go_left, low, mid), np.where(go_left, mid, high)
    return high


def choice_probs(valid) -> np.ndarray:
    """The float32 probabilities of the JAX package's RANSAC draw:
    `valid / max(n_valid, 1)` (`monoorbslam3_tpu/ops/twoview.py`)."""
    w = np.asarray(valid).astype(np.float32)
    return w / np.maximum(np.sum(w, dtype=np.float32), np.float32(1.0))


def choice_with_p(key, valid, shape=(200, 8)) -> np.ndarray:
    """`jax.random.choice(key, N, shape, p=valid / n_valid)` as the JAX
    package draws its RANSAC samples: int64 indices into the N matches.
    With no valid match every index is 0, as JAX's."""
    c = xla_cumsum(choice_probs(valid))
    r = c[-1] * (np.float32(1.0) - uniform(key, shape))
    return searchsorted_left(c, r)
