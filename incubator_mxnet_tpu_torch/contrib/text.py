"""Text utilities (`incubator_mxnet_tpu/contrib/text.py`): token counting,
a frequency-ordered `Vocabulary` with the same index order, and
`TokenEmbedding` read from a local file in the GloVe / fastText text
format (`token v1 ... vD` per line); nothing is downloaded. The numpy
parts are the JAX package's own; the tables come back as NDArrays on the
current context (the card unless a `with cpu():` scope says otherwise).
"""
from __future__ import annotations

import collections

import numpy as np

from ..ndarray.ndarray import NDArray, array

__all__ = ["Vocabulary", "TokenEmbedding", "count_tokens_from_str"]


def count_tokens_from_str(source, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Token frequency counter over `source` split into sequences and
    tokens."""
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    if to_lower:
        source = source.lower()
    for seq in source.split(seq_delim):
        counter.update(t for t in seq.split(token_delim) if t)
    return counter


class Vocabulary:
    """Frequency-ordered indexed vocabulary.

    Index 0 is the unknown token; reserved tokens follow; the remaining
    tokens are ordered by descending frequency (ties broken
    lexicographically, like the reference).
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise ValueError("unknown_token must not be in reserved_tokens")
        if len(set(reserved_tokens)) != len(reserved_tokens):
            raise ValueError("reserved_tokens must be unique")
        self._unknown_token = unknown_token
        self._idx_to_token = [unknown_token] + reserved_tokens
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for tok, freq in pairs:
                if freq < min_freq:
                    break
                if tok != unknown_token and tok not in reserved_tokens:
                    self._idx_to_token.append(tok)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def idx_to_token(self):
        return list(self._idx_to_token)

    @property
    def token_to_idx(self):
        return dict(self._token_to_idx)

    def to_indices(self, tokens):
        """Indices of `tokens`; unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = not isinstance(indices, (list, tuple))
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError(f"index {i} out of vocabulary range")
        out = [self._idx_to_token[i] for i in idxs]
        return out[0] if single else out


class TokenEmbedding:
    """Pretrained embedding table over a vocabulary, read from a file of
    `token v1 ... vD` lines; unknown and missing tokens get
    `init_unknown_vec`."""

    def __init__(self, file_path=None, vocabulary=None, vec_len=None,
                 init_unknown_vec=np.zeros, encoding="utf-8"):
        vectors = {}
        if file_path is not None:
            with open(file_path, encoding=encoding) as f:
                for lineno, line in enumerate(f):
                    parts = line.rstrip().split(" ")
                    if len(parts) < 2:
                        continue
                    tok, vals = parts[0], parts[1:]
                    if vec_len is None:
                        vec_len = len(vals)
                    elif len(vals) != vec_len:
                        # a fastText header line: skipped
                        if lineno == 0:
                            continue
                        raise ValueError(
                            f"{file_path}:{lineno + 1}: expected {vec_len} "
                            f"values, got {len(vals)}")
                    vectors[tok] = np.asarray(vals, np.float32)
        if vec_len is None:
            raise ValueError("vec_len is required without a file")
        self._vec_len = vec_len
        self._vectors = vectors
        self._init_unknown = init_unknown_vec
        if vocabulary is None:
            vocabulary = Vocabulary(
                collections.Counter({t: 1 for t in vectors}))
        self._vocab = vocabulary
        table = np.stack([
            vectors.get(tok, init_unknown_vec(vec_len).astype(np.float32))
            for tok in vocabulary.idx_to_token])
        self._table = table.astype(np.float32)

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def vocabulary(self):
        return self._vocab

    @property
    def idx_to_vec(self):
        """The dense (V, D) table, the input for `nd.Embedding` /
        `gluon.nn.Embedding.weight.set_data`."""
        return array(self._table)

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        rows = []
        for t in toks:
            idx = self._vocab.token_to_idx.get(t)
            if idx is None and lower_case_backup:
                idx = self._vocab.token_to_idx.get(t.lower())
            rows.append(self._table[idx if idx is not None else 0])
        out = array(np.stack(rows))
        return out[0] if single else out

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite the vectors of `tokens` (all in the vocabulary)."""
        toks = [tokens] if isinstance(tokens, str) else tokens
        vecs = np.asarray(new_vectors.asnumpy()
                          if isinstance(new_vectors, NDArray)
                          else new_vectors, np.float32).reshape(len(toks), -1)
        for t, v in zip(toks, vecs):
            if t not in self._vocab.token_to_idx:
                raise ValueError(f"token {t!r} not in the vocabulary")
            self._table[self._vocab.token_to_idx[t]] = v
