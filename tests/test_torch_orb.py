"""PyTorch port, ORB extractor (`monoorbslam3_tpu_torch/ops/`) against the
JAX package on the CPU, stage by stage and as a whole. Each stage gets the
same numpy input on both sides; each tolerance is stated where it is
asserted."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.ops import fast as jfast
from monoorbslam3_tpu.ops import image as jimg
from monoorbslam3_tpu.ops import orb as jorb
from monoorbslam3_tpu.ops import pallas_kernels as jpk
from monoorbslam3_tpu.sim import ImageWorld as JImageWorld
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.ops import fast as tfast
from monoorbslam3_tpu_torch.ops import image as timg
from monoorbslam3_tpu_torch.ops import orb as torb
from monoorbslam3_tpu_torch.ops import pallas_kernels as tpk

H, W = 160, 240
R_BC = np.array([[-0.70710678, 0.0, 0.70710678],
                 [-0.70710678, 0.0, -0.70710678],
                 [0.0, -1.0, 0.0]])
T_BC = np.array([0.03, 0.01, -0.02])


def _bits(desc_u32):
    return np.unpackbits(np.ascontiguousarray(desc_u32).view(np.uint8), axis=1)


@pytest.fixture(scope="module")
def image():
    """A rendered 160x240 frame of the synthetic world (real corners)."""
    cam = JPinhole.create(fx=120.0, fy=120.0, cx=120.0, cy=80.0, width=W, height=H)
    return JImageWorld().render(0.3, cam, R_BC, T_BC, noise=1.0,
                                rng=np.random.default_rng(1))


@pytest.fixture(scope="module")
def level1(image):
    return np.array(jimg.build_pyramid(jnp.asarray(image), 2, 1.2)[1])


@pytest.fixture(scope="module")
def patches(image):
    """Raw 48x48 patches around the JAX extractor's level-0 keypoints."""
    out = jorb.OrbExtractor(H, W, n_features=256, n_levels=4)(image)
    xy = np.asarray(out["xy"])[np.asarray(out["valid"]) & (np.asarray(out["level"]) == 0)]
    return np.array(jorb.gather_patches(jnp.asarray(image), jnp.asarray(xy)))


def test_brief_constants_equal():
    for a, b in zip(jorb.brief_pattern(), torb.brief_pattern()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jorb._ic_angle_weights(), torb._ic_angle_weights()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jorb._blur_matrix(), torb._blur_matrix())
    assert jorb.level_quotas(1024, 8, 1.2) == torb.level_quotas(1024, 8, 1.2)


def test_build_pyramid_close(image):
    """Tolerance 1e-3 (0..255 image). The explicit triangle-filter weights
    measured 6e-5 here; F.interpolate(antialias=True) would be ~2.4e-3."""
    jl = jimg.build_pyramid(jnp.asarray(image), 4, 1.2)
    tl = timg.build_pyramid(torch.as_tensor(image), 4, 1.2)
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]
    err = max(float(np.abs(np.asarray(a) - b.numpy()).max()) for a, b in zip(jl, tl))
    assert err <= 1e-3, err


def test_fast_score_and_nms_bit_exact(level1):
    raw_j = np.asarray(jfast.fast_score_raw(jnp.asarray(level1)))
    raw_t = tfast.fast_score_raw(torch.as_tensor(level1)).numpy()
    np.testing.assert_array_equal(raw_t, raw_j)  # tolerance: bit-exact
    thr = np.where(raw_j > 7.0, raw_j, 0.0).astype(np.float32)
    np.testing.assert_array_equal(tfast.nms3(torch.as_tensor(thr)).numpy(),
                                  np.asarray(jfast.nms3(jnp.asarray(thr))))


@pytest.mark.parametrize("ties", [False, True])
def test_select_keypoints_exact(level1, ties):
    raw = np.asarray(jfast.fast_score_raw(jnp.asarray(level1)))
    score = np.array(jfast.nms3(jnp.where(raw > 7.0, raw, 0.0)))
    if ties:
        # equal scores inside cells and across cells: lax.top_k keeps the
        # lower index first, so must the port
        score = np.zeros_like(score)
        score[30:100:3, 30:180:4] = 40.0
        score[50:60:2, 60:70:2] = 55.0
    for quota in (64, 150):
        ref = jfast.select_keypoints(jnp.asarray(score), quota)
        out = tfast.select_keypoints(torch.as_tensor(score), quota)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_gather_plain_bit_exact_to_jax():
    """K1's plain version against JAX gather_patches_dyn (CPU path)."""
    rng = np.random.default_rng(2)
    atlas = rng.uniform(0, 255, (300, 384)).astype(np.float32)
    ys = rng.integers(0, 300 - 56, 77).astype(np.int32)
    xs = rng.integers(0, 384 - 256, 77).astype(np.int32)
    ys[:3] = [0, 300 - 56, 5]
    xs[:3] = [0, 384 - 256, 127]
    ref = np.asarray(jpk.gather_patches_dyn(jnp.asarray(atlas), jnp.asarray(ys), jnp.asarray(xs)))
    out = tpk.gather_patches_dyn(torch.as_tensor(atlas), torch.as_tensor(ys), torch.as_tensor(xs))
    np.testing.assert_array_equal(out.numpy(), ref)  # tolerance: bit-exact


def test_ic_angles_close(patches):
    """Tolerance 1e-4 rad; measured 1.5e-6 rad on these 84 patches."""
    ref = np.asarray(jorb.ic_angles(jnp.asarray(patches)))
    out = torb.ic_angles(torch.as_tensor(patches)).numpy()
    d = np.abs(np.angle(np.exp(1j * (out.astype(np.float64) - ref))))
    assert d.max() <= 1e-4, d.max()


def test_blur_patches_close(patches):
    """Tolerance rtol 1e-5; measured 2.4e-7 relative (3.1e-5 absolute)."""
    ref = np.asarray(jorb.blur_patches(jnp.asarray(patches)))
    out = torb.blur_patches(torch.as_tensor(patches)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_brief_descriptors_bits(patches):
    """Tolerance 0.1% of bits (one-ulp cos/sin differences can move a
    rotated sample across a rounding boundary); measured 0 bits here."""
    blur = np.asarray(jorb.blur_patches(jnp.asarray(patches)))
    ang = np.asarray(jorb.ic_angles(jnp.asarray(patches)))
    ref = np.asarray(jorb.brief_descriptors(jnp.asarray(blur), jnp.asarray(ang)))
    out = torb.brief_descriptors(torch.as_tensor(blur), torch.as_tensor(ang))
    frac = (_bits(convert.desc_to_numpy(out)) != _bits(ref)).mean()
    assert frac <= 1e-3, frac


def test_pack_bits_matches_uint32_packing():
    """int32 words carry the JAX package's uint32 bit pattern, bit 31 too."""
    rng = np.random.default_rng(4)
    bits = rng.random((9, 256)) > 0.5
    bits[0] = True  # every word 0xFFFFFFFF
    ref = (bits.reshape(9, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    words = torb.pack_bits(torch.as_tensor(bits))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(convert.desc_to_numpy(words), ref.astype(np.uint32))
    assert (convert.desc_to_numpy(words)[0] == 0xFFFFFFFF).all()


def test_extractor_matches_jax(image):
    """Whole extractor, 160x240, 4 levels, 256 features. Measured on this
    frame: 100% of JAX's valid keypoints at the same (x, y, level), 0.0% of
    descriptor bits differ. Bounds: >= 95% overlap, <= 2% bits."""
    ref = {k: np.asarray(v) for k, v in
           jorb.OrbExtractor(H, W, n_features=256, n_levels=4)(image).items()}
    out = torb.OrbExtractor(H, W, n_features=256, n_levels=4)(image)
    assert out["desc"].dtype == torch.int32 and out["desc"].shape == (256, 8)
    key_j = {(float(x), float(y), int(l)): i for i, ((x, y), l, v) in
             enumerate(zip(ref["xy"], ref["level"], ref["valid"])) if v}
    xy_t, lv_t, va_t = out["xy"].numpy(), out["level"].numpy(), out["valid"].numpy()
    pairs = [(key_j[k], i) for i, k in enumerate(
        (float(x), float(y), int(l)) for (x, y), l in zip(xy_t, lv_t)) if va_t[i] and k in key_j]
    overlap = len(pairs) / max(len(key_j), 1)
    assert len(key_j) > 150 and overlap >= 0.95, overlap
    ij, it = map(np.asarray, zip(*pairs))
    frac = (_bits(convert.desc_to_numpy(out["desc"])[it]) != _bits(ref["desc"][ij])).mean()
    assert frac <= 0.02, frac
