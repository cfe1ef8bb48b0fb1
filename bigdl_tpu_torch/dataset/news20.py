"""20 Newsgroups and GloVe ingestion (counterpart of
bigdl_tpu/dataset/news20.py; ref dl/src/main/python/dataset/news20.py
get_news20 :38, get_glove_w2v).  numpy only.

Reads already-extracted local copies, with the reference's directory
layouts; nothing is fetched:

- ``20_newsgroups/<group>/<doc-id>``: one file per post, label = 1-based
  group index in sorted order;
- ``glove.6B/glove.6B.<dim>d.txt``: space-separated word vectors.

``embed_samples`` turns (text, label) pairs into the padded embedded
``Sample``s the text classifiers take (the reference's prepare_data:
tokens -> GloVe vectors -> pad).
"""
from __future__ import annotations

import os
import re

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample


def get_news20(source_dir):
    """[(text, 1-based label)] from an extracted 20_newsgroups tree."""
    news_dir = os.path.join(source_dir, "20_newsgroups")
    if not os.path.isdir(news_dir):
        news_dir = source_dir  # already pointing at the class folders
    # a glove.6B/ folder beside the groups is not a class
    groups = sorted(d for d in os.listdir(news_dir)
                    if os.path.isdir(os.path.join(news_dir, d))
                    and not d.startswith((".", "glove")))
    if not groups:
        raise FileNotFoundError(
            f"no newsgroup class folders under {news_dir}; extract "
            f"20news-19997.tar.gz there (this loader reads local copies "
            f"only)")
    texts = []
    for label, name in enumerate(groups, start=1):
        d = os.path.join(news_dir, name)
        for fn in sorted(os.listdir(d)):
            path = os.path.join(d, fn)
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    texts.append((f.read().decode("latin-1"), float(label)))
    if not texts:
        raise FileNotFoundError(
            f"newsgroup folders under {news_dir} contain no documents "
            f"({', '.join(groups[:3])}...): incomplete extraction?")
    return texts


def get_glove_w2v(source_dir, dim: int = 100):
    """{word: np.float32[dim]} from an extracted glove.6B directory."""
    path = os.path.join(source_dir, f"glove.6B.{dim}d.txt")
    if not os.path.isfile(path):
        alt = os.path.join(source_dir, "glove.6B", f"glove.6B.{dim}d.txt")
        if not os.path.isfile(alt):
            raise FileNotFoundError(
                f"no glove.6B.{dim}d.txt under {source_dir}; extract "
                f"glove.6B.zip there (this loader reads local copies only)")
        path = alt
    w2v = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            w2v[parts[0]] = np.asarray(parts[1:], np.float32)
    return w2v


_TOKEN = re.compile(r"[a-z]+")


def tokenize(text: str):
    """Lowercase word tokens (the reference's analyzer: text_to_words)."""
    return _TOKEN.findall(text.lower())


def embed_samples(texts, w2v, seq_len: int = 1000, embed_dim: int = 100):
    """(text, label) pairs -> Samples of (seq_len, embed_dim) float32
    features, zero padded or truncated, and a (1,) float32 label."""
    samples = []
    for text, label in texts:
        vecs = [w2v[t] for t in tokenize(text) if t in w2v][:seq_len]
        feat = np.zeros((seq_len, embed_dim), np.float32)
        if vecs:
            feat[:len(vecs)] = np.stack(vecs)
        samples.append(Sample(feat, np.asarray([label], np.float32)))
    return samples
