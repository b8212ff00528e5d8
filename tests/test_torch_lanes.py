"""chip_smoke.py's helpers for its last three paths, on the CPU: the
lanes that run paths 13-15 side by side (`Lane`, `to_device`), the PNG
reader that counts a host's differing pixels (`png_gray_pixels` against
`png_gray`), the copy of differing PNGs (`profile_digest_check`), the gate
on K2's launches at KITTI's 1,536 features and at path 15's 1,024
(`profile_k2_checks`), and path 15's shape gate (`profile_shape_checks`:
the camera, the extractor's atlas, K1's windows against each profile's
settings and the port's extractor)."""

import collections
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs

Pair = collections.namedtuple("Pair", "a b")


@pytest.mark.parametrize("depth", [8, 16])
def test_png_pixels_round_trip(depth):
    img = np.random.default_rng(depth).integers(0, 256, (37, 53), dtype=np.uint8)
    px = cs.png_gray_pixels(cs.png_gray(img, depth))
    want = img if depth == 8 else img.astype(np.uint16) * 257
    assert px.dtype == want.dtype and np.array_equal(px, want)


def test_to_device_walks_containers():
    t = torch.arange(6).reshape(2, 3)
    obj = {"k": [(t, 1), Pair(t, "x")], "n": None}
    got = cs.to_device(obj, "cpu")
    assert isinstance(got["k"][1], Pair) and got["k"][1].b == "x"
    assert torch.equal(got["k"][0][0], t) and got["k"][0][1] == 1 and got["n"] is None


def test_lane_returns_the_call(tmp_path):
    lane = cs.Lane(tmp_path / "r.pkl", "profile_k2_checks", [(cs.PROFILE_SEARCH, 5)] * 2)
    got = lane.result("cpu", timeout=120)
    assert len(got) == 1 and "K2's last KITTI frame" in got[0]


def test_lane_raises_when_the_call_fails(tmp_path):
    lane = cs.Lane(tmp_path / "r.pkl", "_wait_file", str(tmp_path / "never"), 0.0)
    with pytest.raises(RuntimeError, match="exited"):
        lane.result("cpu", timeout=120)
    assert not (tmp_path / "r.pkl").exists()


K2_OK = [(1536, 1536)] * 4 + [(4096, 1536), (1536, 4096)] * 2


@pytest.mark.parametrize("shapes, ok", [
    (K2_OK, True),
    (K2_OK[:7], False),                                          # a launch missing
    ([(1024, 1536)] + K2_OK[1:], False),                         # coarse rows not the frame's
    (K2_OK[:5] + [(4096, 1536)] + K2_OK[6:], False),             # transposed rows not 1,536
    (K2_OK[:4] + [(4096, 1024)] + K2_OK[5:], False),             # "rows" columns not 1,536
])
def test_profile_k2_gate(shapes, ok):
    assert (cs.profile_k2_checks(shapes) == []) == ok


def test_digest_check_copies_differing_pngs(tmp_path, monkeypatch):
    root = tmp_path / "tumvi"
    cs.write_dataset(root, "tumvi", 2)
    digest, pngs = cs.dataset_digest(root, "tumvi")
    ref = {n: h[:16] for n, h in pngs.items()}
    first = sorted(ref)[0]
    ref[first] = "0" * 16
    monkeypatch.setattr(cs, "PROFILE_DIGESTS", tmp_path / "digests.json")
    monkeypatch.setattr(cs, "PROFILE_PNGS_OUT", tmp_path / "out")
    cs.PROFILE_DIGESTS.write_text(json.dumps({"tumvi": {"digest": digest, "pngs": ref}}))
    same, differ = cs.profile_digest_check(root, "tumvi")
    assert same and differ == [first]
    copied = cs.png_gray_pixels((tmp_path / "out" / "tumvi" / first).read_bytes())
    assert copied.dtype == np.uint16 and copied.shape == (512, 512)


K2_1024 = [(1024, 1024)] * 4 + [(4096, 1024), (1024, 4096)] * 2


@pytest.mark.parametrize("shapes, ok", [(K2_1024, True), (K2_OK, False)])
def test_profile_k2_gate_at_the_profiles_feature_count(shapes, ok):
    assert (cs.profile_k2_checks(shapes, 1024, "phone") == []) == ok


def _shape_run(profile, atlas=None, k=None):
    """A `profiles` run's fields that `profile_shape_checks` reads, at the
    shapes the profile's settings and the port's extractor give."""
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.ops.orb import OrbExtractor

    s = config.load_settings(str(cs.SETTINGS / cs.DATASET_PROFILES[profile]["settings"]))
    w, h, n = (int(s["Camera"]["Width"]), int(s["Camera"]["Height"]),
               int(s["ORB"]["Features"]))
    ext = OrbExtractor(h, w, n_features=n, device="cpu")
    atlas = atlas or (ext.atlas_h, ext.atlas_w)
    k = k or n
    return dict(summary=dict(width=w, height=h, extractor=dict(
                    width=ext.width, height=ext.height, n_features=ext.n_features,
                    atlas=[ext.atlas_h, ext.atlas_w])),
                k1=[(torch.zeros(atlas), torch.zeros(k, dtype=torch.int32),
                     torch.zeros(k, dtype=torch.int32))],
                k2=[(torch.zeros((r, 8)), torch.zeros((c, 8))) for r, c in
                    [(n, n)] * 4 + [(4096, n), (n, 4096)] * 2])


@pytest.mark.parametrize("profile", cs.VIO_PROFILES)
def test_profile_shape_gate(profile):
    assert cs.profile_shape_checks(profile, _shape_run(profile)) == []
    assert cs.profile_shape_checks(profile, _shape_run(profile, atlas=(64, 64)))
    assert cs.profile_shape_checks(profile, _shape_run(profile, k=1536))
    if profile == "phone":  # the largest atlas: 3379x1536 f32, 20.8 MB
        assert _shape_run(profile)["summary"]["extractor"]["atlas"] == [3379, 1536]
