"""PyTorch port: the JAX package's RANSAC draws (`utils/prng.py`) against
`jax.random` on the CPU, to the bit.

- `prng_key` against `jax.random.PRNGKey` for seeds 0-19, -1 and
  2**31-1, and a chain of 50 `split`s.
- `choice_with_p` against `jax.random.choice(key, N, (200, 8),
  p=valid / n_valid)`, jitted as the JAX package's bootstrap computes it
  (`monoorbslam3_tpu/ops/twoview.py`), to the index, on 250 masks: N of 64,
  512, 768, 1,024 and 1,536; valid prefixes as `Tracking._initialize`
  builds them, prefixes with holes (a match whose ideal pixel is behind a
  camera), one valid row, and none (every index 0).
- `xla_cumsum` bit-equal to a jitted `jnp.cumsum` on every mask, and on
  one mask where a sequential float32 cumsum misses draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monoorbslam3_tpu_torch.utils import prng

SIZES = (64, 512, 768, 1024, 1536)
MASKS_A_SIZE = 50


@jax.jit
def _jax_draw(key, valid):
    """The JAX package's draw (twoview.py:334-338) from `key` over `valid`."""
    w = valid.astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    return jax.random.choice(key, valid.shape[0], shape=(200, 8), p=probs)


_jax_cumsum = jax.jit(jnp.cumsum)


def _masks(N, rng):
    """MASKS_A_SIZE masks of N rows: valid prefixes of random length (the
    matched pairs first, as `_initialize` packs them), half of them with
    30% holes inside the prefix, one with a single valid row and one with
    none."""
    out = [np.zeros(N, bool), np.eye(1, N, int(rng.integers(N)), dtype=bool)[0]]
    while len(out) < MASKS_A_SIZE:
        v = np.zeros(N, bool)
        n = int(rng.integers(1, N + 1))
        v[:n] = rng.random(n) > 0.3 if len(out) % 2 else True
        out.append(v)
    return out


def test_prng_key_is_jax_s():
    for seed in list(range(20)) + [-1, 2 ** 31 - 1]:
        key = prng.prng_key(seed)
        assert key.dtype == np.uint32
        np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)), err_msg=seed)
    np.testing.assert_array_equal(prng.prng_key(-1), [0, 4294967295])
    with pytest.raises(TypeError):
        prng.prng_key(1.5)


def test_split_chain_is_jax_s():
    jkey, key = jax.random.PRNGKey(0), prng.prng_key(0)
    for i in range(50):
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key)
        np.testing.assert_array_equal(key, np.asarray(jkey), err_msg=f"split {i}")
        np.testing.assert_array_equal(sub, np.asarray(jsub), err_msg=f"split {i}")


def test_uniform_is_jax_s():
    key = prng.prng_key(11)
    got = prng.uniform(key, (200, 8))
    ref = np.asarray(jax.random.uniform(jnp.asarray(key), (200, 8)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("N", SIZES)
def test_choice_with_p_draws_jax_s_indices(N):
    """Every mask's [200, 8] draw equals JAX's to the index, under a chain
    of split keys as the tracker takes them; with no valid row every index
    is 0; the cumsum is bit-equal to the jitted `jnp.cumsum`."""
    rng = np.random.default_rng(N)
    key = prng.prng_key(N)
    for m, valid in enumerate(_masks(N, rng)):
        key, sub = prng.split(key)
        got = prng.choice_with_p(sub, valid)
        ref = np.asarray(_jax_draw(jnp.asarray(sub), jnp.asarray(valid)))
        assert got.shape == (200, 8) and got.dtype == np.int64
        np.testing.assert_array_equal(got, ref, err_msg=f"mask {m}")
        if valid.any():
            assert valid[got].all()
        else:
            assert not got.any()
        p = prng.choice_probs(valid)
        c = np.asarray(_jax_cumsum(jnp.asarray(p)))
        np.testing.assert_array_equal(prng.xla_cumsum(p).view(np.uint32), c.view(np.uint32),
                                      err_msg=f"mask {m}")


def test_xla_cumsum_on_ragged_lengths():
    """The blocked order on lengths that are not multiples of 16, and on
    one past 16**3 (three levels of blocks)."""
    rng = np.random.default_rng(3)
    for n in (1, 15, 16, 17, 100, 257, 1000, 4097):
        x = rng.random(n).astype(np.float32)
        np.testing.assert_array_equal(prng.xla_cumsum(x).view(np.uint32),
                                      np.asarray(_jax_cumsum(x)).view(np.uint32), err_msg=n)


def test_the_cumsum_order_decides_the_draws():
    """On a prefix of 1,359 valid rows of 1,536 under the key of seed 3, a
    sequential float32 cumsum misses draws that the blocked order gets."""
    valid = np.zeros(1536, bool)
    valid[:1359] = True
    key = prng.prng_key(3)
    ref = np.asarray(_jax_draw(jnp.asarray(key), jnp.asarray(valid)))
    np.testing.assert_array_equal(prng.choice_with_p(key, valid), ref)
    p = prng.choice_probs(valid)
    seq = np.cumsum(p, dtype=np.float32)
    assert (seq != prng.xla_cumsum(p)).any()
    r = seq[-1] * (np.float32(1.0) - prng.uniform(key, (200, 8)))
    assert (prng.searchsorted_left(seq, r) != ref).sum() > 0
