"""PyTorch port: the vocabulary (`monoorbslam3_tpu_torch/ops/vocab.py`)
against the JAX package's (`monoorbslam3_tpu/ops/vocab.py`) on the CPU.

- Both shipped vocabularies load bit for bit (node words, idf, level
  offsets), and the writer gives the JAX package's bytes and round-trips.
- `transform` on seeded descriptors with padding and on a rendered frame's
  extractor descriptors (the 100k-leaf vocabulary, the system world's
  camera): word and group ids exact, the BoW vector within 1e-7, padding
  masked; `score` alike.
- `train` with one seed builds the same nodes in both packages.
- `convert.vocabulary` carries a JAX vocabulary across unchanged.
- The node gate's sentinel semantics (the twin of tests/test_vocab.py).
"""

import gzip
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoorbslam3_tpu.ops import vocab as jv
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.ops import matching as tmatch
from monoorbslam3_tpu_torch.ops import vocab as tv

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

SETTINGS = Path(__file__).resolve().parents[1] / "settings"
VOCABS = {"toy": SETTINGS / "synthetic_voc.txt", "100k": SETTINGS / "synthetic_voc_100k.txt.gz"}
BOW_ATOL = 1e-7


@pytest.fixture(scope="module")
def vocabs():
    return {name: (jv.load_dbow2_text(str(p)), tv.load_dbow2_text(str(p), device="cpu"))
            for name, p in VOCABS.items()}


def _same_vocab(j, t):
    nd, idf = t.host_tables()
    assert (t.k, t.levels, t.level_offset, t.group_level) == (
        j.k, j.levels, tuple(j.level_offset), j.group_level)
    assert nd.dtype == np.uint32 and np.array_equal(nd, np.asarray(j.node_desc))
    assert idf.dtype == np.float32 and np.array_equal(idf, np.asarray(j.word_idf))


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_load_dbow2_text_bit_for_bit(vocabs, name):
    j, t = vocabs[name]
    _same_vocab(j, t)
    assert t.node_desc.dtype == torch.int32 and t.node_desc.device.type == "cpu"


def _transform_both(j, t, desc, valid):
    wj, gj, bj = (np.asarray(a) for a in j.transform(jnp.asarray(desc), jnp.asarray(valid)))
    wt, gt, bt = t.transform(torch.from_numpy(desc.view(np.int32).copy()),
                             torch.from_numpy(valid.copy()))
    return (wj, gj, bj), (wt.numpy(), gt.numpy(), bt.numpy())


def _check_transform(j, t, desc, valid):
    (wj, gj, bj), (wt, gt, bt) = _transform_both(j, t, desc, valid)
    assert wt.dtype == np.int32 and gt.dtype == np.int32
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=BOW_ATOL)
    assert (wt[~valid] == -1).all() and (gt[~valid] == -1).all()
    assert (wt[valid] >= 0).all() and (wt[valid] < t.n_words).all()
    assert (gt[valid] >= 0).all() and (gt[valid] < t.k ** t.group_level).all()
    np.testing.assert_allclose(bt.sum(), 1.0, atol=1e-5)
    return bt


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_transform_seeded_descriptors(vocabs, name):
    """1,000 seeded descriptors, the last 200 padding, and clustered copies
    of a few (ties between children are where argmin orders matter)."""
    j, t = vocabs[name]
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2**32, size=(1000, 8), dtype=np.uint32)
    nd = np.asarray(j.node_desc)
    desc[:100] = nd[rng.integers(0, len(nd), 100)]  # exact node words
    valid = np.ones(1000, bool)
    valid[800:] = False
    _check_transform(j, t, desc, valid)


def test_transform_rendered_frame():
    """The extractor's descriptors of a rendered frame of the system world
    (settings/synthetic_vocab.yaml: 512x384, 768 features) through the
    100k-leaf vocabulary of that profile."""
    from monoorbslam3_tpu_torch import config as tc
    from monoorbslam3_tpu_torch.ops.orb import OrbExtractor
    from monoorbslam3_tpu_torch.sim import ImageWorld

    settings = tc.load_settings(str(SETTINGS / "synthetic_vocab.yaml"))
    cam = tc.build_camera(settings, "cpu")
    calib = tc.build_imu_calib(settings, "cpu")
    img = ImageWorld().render(1.0, cam, calib.R_bc.numpy().astype(np.float64),
                              calib.t_bc.numpy().astype(np.float64),
                              rng=np.random.default_rng(1))
    ext = OrbExtractor(cam.height, cam.width, n_features=768, device="cpu")
    out = ext(img)
    desc = convert.desc_to_numpy(out["desc"])
    valid = out["valid"].numpy()
    assert valid.sum() > 500
    j = jv.load_dbow2_text(str(VOCABS["100k"]))
    t = tc.build_vocabulary(settings, base_dir=str(SETTINGS), device="cpu")
    _same_vocab(j, t)
    _check_transform(j, t, desc, valid)


def test_score(vocabs):
    j, t = vocabs["100k"]
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint32)
    b = a.copy()
    b[150:] = rng.integers(0, 2**32, size=(150, 8), dtype=np.uint32)
    v = np.ones(300, bool)
    (_, _, ja), (_, _, ta) = _transform_both(j, t, a, v)
    (_, _, jb), (_, _, tb) = _transform_both(j, t, b, v)
    sj = float(j.score(jnp.asarray(ja), jnp.asarray(jb)))
    st = float(t.score(torch.from_numpy(ta), torch.from_numpy(tb)))
    assert abs(st - sj) < 1e-6
    assert float(t.score(torch.from_numpy(ta), torch.from_numpy(ta))) == 1.0


def _clustered(rng, n_clusters=40, per_cluster=30, flip=6):
    centers = rng.integers(0, 2**32, (n_clusters, 8), dtype=np.uint32)
    out = []
    for c in centers:
        for _ in range(per_cluster):
            d = c.copy()
            for _ in range(flip):
                d[rng.integers(0, 8)] ^= np.uint32(1) << np.uint32(rng.integers(0, 32))
            out.append(d)
    return np.stack(out)


@pytest.mark.parametrize("k,levels", [(8, 2), (4, 3)])
def test_train_same_nodes(k, levels):
    descs = _clustered(np.random.default_rng(31))
    j = jv.Vocabulary.train(descs, k=k, levels=levels, group_level=1, seed=5)
    t = tv.Vocabulary.train(descs, k=k, levels=levels, group_level=1, seed=5, device="cpu")
    _same_vocab(j, t)
    valid = np.ones(len(descs), bool)
    valid[-7:] = False
    _check_transform(j, t, descs, valid)


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz"])
def test_save_dbow2_text_same_bytes(tmp_path, suffix):
    descs = _clustered(np.random.default_rng(8), n_clusters=12, per_cluster=10)
    j = jv.Vocabulary.train(descs, k=4, levels=3, seed=1)
    t = tv.Vocabulary.train(descs, k=4, levels=3, seed=1, device="cpu")
    pj, pt = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
    jv.save_dbow2_text(j, str(pj))
    tv.save_dbow2_text(t, str(pt))
    read = (lambda p: gzip.open(p, "rb").read()) if suffix.endswith(".gz") else (
        lambda p: p.read_bytes())
    assert read(pt) == read(pj)
    _same_vocab(j, tv.load_dbow2_text(str(pt), device="cpu"))


def test_save_roundtrip_shipped(tmp_path, vocabs):
    """The toy vocabulary written by the port reads back identical."""
    j, t = vocabs["toy"]
    p = tmp_path / "voc.txt"
    tv.save_dbow2_text(t, str(p))
    jv.save_dbow2_text(j, str(tmp_path / "jvoc.txt"))
    assert p.read_bytes() == (tmp_path / "jvoc.txt").read_bytes()
    _same_vocab(j, tv.load_dbow2_text(str(p), device="cpu"))


def test_convert_vocabulary(vocabs):
    j, _ = vocabs["toy"]
    t = convert.vocabulary(j, device="cpu")
    _same_vocab(j, t)
    rng = np.random.default_rng(9)
    desc = rng.integers(0, 2**32, size=(64, 8), dtype=np.uint32)
    _check_transform(j, t, desc, np.ones(64, bool))


def test_node_gate_sentinel_semantics():
    ga = torch.tensor([0, 1, -1], dtype=torch.int32)
    gb = torch.tensor([0, 2, 5], dtype=torch.int32)
    m = tmatch.node_gate(ga, gb).numpy()
    # row 0 (group 0): only column 0 (group 0)
    assert m[0, 0] and not m[0, 1] and not m[0, 2]
    # row 1 (group 1): no same-group column, all blocked
    assert not m[1].any()
    # row 2 (no BoW information): passes everything
    assert m[2].all()
    from monoorbslam3_tpu.ops.matching import node_gate

    np.testing.assert_array_equal(m, np.asarray(node_gate(jnp.asarray(ga.numpy()),
                                                          jnp.asarray(gb.numpy()))))
