"""Train a reference-scale DBoW2-format ORB vocabulary (CLI; counterpart of
`monoorbslam3_tpu/runners/train_vocab.py`).

The reference ships the ~1M-leaf ORBvoc.txt (k=10, L=6) trained offline on
real imagery and loads it at startup (ORBVocabulary.cpp:13,
thirdParty/DBoW2/DBoW2/TemplatedVocabulary.h:241). No real imagery ships
here, so this trainer builds the same artifact shape (k=10 / L=5 = 100k
leaves by default) from descriptors harvested through the public
extractor on the synthetic battery worlds, on the card unless `--device`
names another; the tree is trained on the host (`ops/vocab.Vocabulary.train`,
bit for bit the JAX package's); the corpus tf-idf weights (DBoW2 TF_IDF:
idf = log(N_docs / n_docs_with_word), unseen words 0) come from each
document's `transform` on the device; the DBoW2 text format (.gz
transparently) is written by `ops.vocab.save_dbow2_text`, which
`load_dbow2_text` and the reference's own loader read.

Usage:
  python -m monoorbslam3_tpu_torch.runners.train_vocab \\
      --out settings/synthetic_voc_100k.txt.gz --k 10 --levels 5
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils.device import CARD

# (settings, world spec) pairs: descriptor diversity needs every texture /
# motion regime the battery exercises
CORPUS = [
    ("settings/synthetic.yaml", "circle:t_end=30,fps=4"),
    ("settings/synthetic.yaml", "noisy:t_end=30,fps=4"),
    ("settings/synthetic.yaml", "lowtex:t_end=30,fps=4"),
    ("settings/synthetic.yaml", "fastspin:t_end=30,fps=4"),
    ("settings/synthetic_forward.yaml", "corridor:t_end=60,fps=2"),
]


def harvest(corpus, device=CARD, log=print):
    """Per-frame descriptor documents through the public extractor on
    `device`: one [n_valid, 8] uint32 array a frame (one read a frame)."""
    from ..config import build_system
    from ..runners.synth import SyntheticDataset

    docs = []
    for settings, spec in corpus:
        system = build_system(settings, device=device)
        dataset = SyntheticDataset(spec, system.camera, system.calib)
        t0 = time.perf_counter()
        for t, img, imu in dataset.frames():
            out = system.extractor(np.asarray(img, np.float32))
            desc = out["desc"].cpu().numpy().view(np.uint32)
            valid = out["valid"].cpu().numpy()
            docs.append(desc[valid])
        log(f"  {spec}: {len(dataset)} frames, "
            f"{sum(len(d) for d in docs)} descriptors total "
            f"({time.perf_counter() - t0:.0f}s)")
    return docs


def corpus_idf(vocab, docs, log=print):
    """DBoW2 TF_IDF word weights from the training corpus: each document
    through `vocab.transform` on the vocabulary's device, the document
    frequency of each word counted on the host (TemplatedVocabulary.h
    setNodeWeights)."""
    n_docs = len(docs)
    df = np.zeros(vocab.n_words, np.int64)
    cap = max(len(d) for d in docs)
    for d in docs:
        pad = np.zeros((cap, 8), np.uint32)
        pad[: len(d)] = d
        valid = np.arange(cap) < len(d)
        word, _, _ = vocab.transform(torch.from_numpy(pad.view(np.int32)).to(vocab.device),
                                     torch.from_numpy(valid).to(vocab.device))
        word = word.cpu().numpy()
        df[np.unique(word[word >= 0])] += 1
    idf = np.zeros(vocab.n_words, np.float32)
    seen = df > 0
    idf[seen] = np.log(n_docs / df[seen])
    log(f"  idf: {int(seen.sum())} of {vocab.n_words} words seen "
        f"({100.0 * seen.mean():.1f}%), idf range "
        f"[{idf[seen].min():.2f}, {idf[seen].max():.2f}]")
    return idf


def main(argv=None):
    from ..ops.vocab import Vocabulary, save_dbow2_text

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="settings/synthetic_voc_100k.txt.gz")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--group-level", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the extractor and the transform (default: the card)")
    args = ap.parse_args(argv)

    print(f"harvesting descriptors from {len(CORPUS)} worlds...", flush=True)
    docs = harvest(CORPUS, device=args.device)
    descs = np.concatenate(docs)
    print(f"training k={args.k} L={args.levels} "
          f"({args.k ** args.levels} leaves) on {len(descs)} descriptors...", flush=True)
    t0 = time.perf_counter()
    vocab = Vocabulary.train(descs, k=args.k, levels=args.levels,
                             group_level=args.group_level, seed=args.seed, device=args.device)
    print(f"  trained in {time.perf_counter() - t0:.0f}s", flush=True)
    idf = corpus_idf(vocab, docs)
    vocab = vocab._replace(word_idf=torch.from_numpy(idf).to(vocab.device))
    save_dbow2_text(vocab, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
