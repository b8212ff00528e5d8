"""PyTorch port: the native dataset loader (`monoorbslam3_tpu_torch/native`:
`load_gray`, `parse_imu`, `ImagePrefetcher`, built from the port's own
`src/dataloader.cpp`) and the loaders of `runners/datasets.py`, against the
JAX package's native loader and Python parsers on the same files.

- `load_gray` gives the same float32 array as the JAX package's on every
  PNG mode of tests/test_native_loader.py, on 16-bit PNG and on PGM and
  PPM; a broken or missing file gives None in both.
- `parse_imu`, `load_imu` (both branches) and `load_times` match JAX's.
- The prefetcher keeps the path order, and a frame the native decoder
  refuses goes through the fallback, as JAX's does.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from monoorbslam3_tpu import native as jnative
from monoorbslam3_tpu.runners import datasets as jdatasets
from monoorbslam3_tpu_torch import native as tnative
from monoorbslam3_tpu_torch.runners import datasets as tdatasets

RNG = np.random.default_rng(11)


@pytest.fixture(scope="module", autouse=True)
def both_loaders_built():
    """Both packages' loaders must build here (g++ and zlib are present)."""
    assert jnative.get_ext("dataloader") is not None
    assert tnative.get_ext("dataloader") is not None, tnative.build_errors.get("dataloader")


def _save(tmp_path, name, img: Image.Image, **kw):
    p = os.path.join(tmp_path, name)
    img.save(p, **kw)
    return p


def _both(path):
    got, ref = tnative.load_gray(path), jnative.load_gray(path)
    assert got is not None and ref is not None
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32
    return got


@pytest.mark.parametrize("mode,size", [
    ("L", (64, 48)),
    ("L", (753, 31)),  # odd width exercises filter bpp offsets
    ("RGB", (40, 40)),
    ("RGBA", (33, 17)),
    ("LA", (20, 20)),
    ("P", (48, 32)),
    ("1", (64, 24)),  # 1-bit gray
])
def test_png_modes_match_jax(tmp_path, mode, size):
    w, h = size
    base = RNG.integers(0, 256, (h, w, 4), dtype=np.uint8)
    base[: h // 2] = base[: h // 2] // 4 + 100  # smooth rows: varied scanline filters
    img = Image.fromarray(base, "RGBA").convert(mode)
    got = _both(_save(tmp_path, f"img_{mode}.png", img))
    assert got.shape == (h, w)
    # and within PIL's truncated integer luma, as the JAX test holds it
    assert np.abs(got - np.asarray(img.convert("L"), np.float32)).max() <= 1.0 + 1e-5


def test_png_16bit_matches_jax(tmp_path):
    arr = RNG.integers(0, 65536, (25, 37), dtype=np.uint16)
    got = _both(_save(tmp_path, "img16.png", Image.fromarray(arr, "I;16")))
    np.testing.assert_array_equal(got, (arr >> 8).astype(np.float32))


def test_pgm_ppm_match_jax(tmp_path):
    arr = RNG.integers(0, 256, (21, 33), dtype=np.uint8)
    got = _both(_save(tmp_path, "img.pgm", Image.fromarray(arr, "L")))
    np.testing.assert_array_equal(got, arr.astype(np.float32))
    rgb = RNG.integers(0, 256, (14, 19, 3), dtype=np.uint8)
    _both(_save(tmp_path, "img.ppm", Image.fromarray(rgb, "RGB")))


def test_decode_failures_return_none(tmp_path):
    bad = os.path.join(tmp_path, "bad.png")
    with open(bad, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really a png at all")
    for path in (bad, os.path.join(tmp_path, "missing.png")):
        assert tnative.load_gray(path) is None
        assert jnative.load_gray(path) is None


def test_prefetcher_in_order_with_fallback(tmp_path):
    paths, refs = [], []
    for i in range(12):
        arr = np.full((8, 16), i * 20, np.uint8)
        paths.append(_save(tmp_path, f"f{i:03d}.png", Image.fromarray(arr, "L")))
        refs.append(arr.astype(np.float32))
    # frame 5 is a BMP under a .png name: the native decoder refuses it
    arr5 = np.arange(128, dtype=np.uint8).reshape(8, 16)
    bmp = io.BytesIO()
    Image.fromarray(arr5, "L").save(bmp, "BMP")
    with open(paths[5], "wb") as f:
        f.write(bmp.getvalue())
    refs[5] = arr5.astype(np.float32)
    assert tnative.load_gray(paths[5]) is None
    fell_back = []

    def fallback(p):
        fell_back.append(p)
        return np.asarray(Image.open(p).convert("L"), np.float32)

    pf = tnative.ImagePrefetcher(paths, fallback, workers=3, depth=4)
    out = list(pf)
    want = list(jnative.ImagePrefetcher(paths, fallback, workers=3, depth=4))
    assert len(out) == 12 and fell_back == [paths[5], paths[5]]
    for got, ref, j in zip(out, refs, want):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, j)
    assert pf.wait_s >= 0.0


def test_prefetcher_without_the_module_decodes_through_the_fallback(tmp_path, monkeypatch):
    paths = [_save(tmp_path, f"g{i}.png", Image.fromarray(np.full((4, 6), i, np.uint8), "L"))
             for i in range(3)]
    monkeypatch.setattr(tnative, "get_ext", lambda name="map_ops": None)
    out = list(tnative.ImagePrefetcher(paths, tdatasets._load_gray))
    assert [int(o[0, 0]) for o in out] == [0, 1, 2]
    assert tnative.load_gray(paths[0]) is None and tnative.branch("dataloader") == "fallback"


IMU_TEXT = ("0.0 1 2 3 4 5 6\n"
            "# comment line\n"
            "0.005 .1 -2e-3 3.5 4 5 6\n"
            "0.004 9 9 9 9 9 9\n"  # decreasing t: dropped
            "0.005 9 9 9 9 9 9\n"  # equal t: dropped
            "0.010 1 2 3 4 5\n"  # short line: dropped
            "0.015 1 2 3 4 5 6 7 8\n"  # extra columns: the first 7 kept
            "\n")


def test_parse_imu_and_load_imu_match_jax(tmp_path, monkeypatch):
    path = os.path.join(tmp_path, "imu.txt")
    with open(path, "w") as f:
        f.write(IMU_TEXT)
    got = tnative.parse_imu(path)
    np.testing.assert_array_equal(got, jnative.parse_imu(path))
    assert got.shape == (3, 7)
    np.testing.assert_array_equal(tdatasets.load_imu(path), jdatasets.load_imu(path))
    # the Python parser (no native module) gives the same rows
    monkeypatch.setattr(tnative, "get_ext", lambda name="map_ops": None)
    assert tnative.parse_imu(path) is None
    np.testing.assert_allclose(tdatasets.load_imu(path), got)


def test_load_times_matches_jax(tmp_path):
    path = os.path.join(tmp_path, "times.txt")
    with open(path, "w") as f:
        f.write("0.000000\n\n0.050000 extra\n  0.100000  \n1403636579.763555\n")
    got = tdatasets.load_times(path)
    np.testing.assert_array_equal(got, jdatasets.load_times(path))
    assert got.tolist() == [0.0, 0.05, 0.1, 1403636579.763555]
