"""Language-model datasets (`incubator_mxnet_tpu/gluon/contrib/data/text.py`,
the JAX package's module as it is: numpy only): a tokenized corpus cut
into (seq_len,) data / label pairs shifted by one.

Nothing is downloaded: a local `root` holding `wiki.{train,valid,test}.
tokens` is read when given (a missing file raises), and otherwise a
synthetic token stream with a Zipf unigram distribution stands in,
drawn from a numpy `RandomState` seeded with the crc32 of the corpus and
segment names, so its token ids are bit-identical to the JAX package's.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from ....contrib.text import Vocabulary
from ...data.dataset import Dataset

__all__ = ["WikiText2", "WikiText103"]


def _synthetic_tokens(n_tokens, vocab_size, seed):
    """Zipf-distributed pseudo-corpus: token ids as whitespace words."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1)
    p = 1.0 / ranks
    p /= p.sum()
    ids = rng.choice(vocab_size, size=n_tokens, p=p)
    return [f"w{i}" for i in ids]


class _WikiText(Dataset):
    _namespace = None
    _synthetic_sizes = {"train": 60000, "val": 6000, "test": 6000}
    _synthetic_vocab = 800

    def __init__(self, root=None, segment="train", vocab=None, seq_len=35):
        self._seq_len = int(seq_len)
        tokens = self._load(root, segment)
        self._vocab = vocab or Vocabulary(
            self._count(tokens), reserved_tokens=["<eos>"])
        ids = np.asarray(self._vocab.to_indices(tokens), np.int32)
        n = (len(ids) - 1) // self._seq_len * self._seq_len
        self._data = ids[:n].reshape(-1, self._seq_len)
        self._label = ids[1:n + 1].reshape(-1, self._seq_len)

    @staticmethod
    def _count(tokens):
        from collections import Counter

        return Counter(tokens)

    def _load(self, root, segment):
        seg_file = {"train": "wiki.train.tokens", "val": "wiki.valid.tokens",
                    "validation": "wiki.valid.tokens",
                    "test": "wiki.test.tokens"}[segment]
        if root:
            path = os.path.join(root, seg_file)
            if not os.path.exists(path):
                # an explicit root must never silently train on fake data
                raise FileNotFoundError(
                    f"{path} not found; pass root=None for the synthetic "
                    "stand-in corpus")
            with open(path, encoding="utf-8") as f:
                out = []
                for line in f:
                    out.extend(line.split())
                    out.append("<eos>")
                return out
        key = "val" if segment in ("val", "validation") else segment
        # crc32, not hash(): the synthetic corpus must be identical across
        # processes (hash() is salted per interpreter)
        seed = zlib.crc32(f"{self._namespace}/{key}".encode()) % (2 ** 31)
        return _synthetic_tokens(
            self._synthetic_sizes[key], self._synthetic_vocab, seed)

    @property
    def vocab(self):
        return self._vocab

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]

    def __len__(self):
        return self._data.shape[0]


class WikiText2(_WikiText):
    """WikiText-2 (or its stand-in: 800 words, 60000 training tokens)."""

    _namespace = "wikitext-2"


class WikiText103(_WikiText):
    """WikiText-103 (or its stand-in: 2000 words, 200000 training
    tokens)."""

    _namespace = "wikitext-103"
    _synthetic_sizes = {"train": 200000, "val": 8000, "test": 8000}
    _synthetic_vocab = 2000
