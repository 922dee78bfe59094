"""Caption vocabulary + token-frequency builders (legacy GloVe-era path).

The port's own copy of ``vlp3d/data/vocab.py`` (numpy and json; the same
annotations give the same ids). Ports `lib/joint/dataset.py:294-358` (_build_vocabulary /
_build_frequency): a word vocabulary for the CapNet-style captioner with
special tokens ["pad_", "unk", "sos", "eos"] at indices 0-3 (note the
reference's deliberate "pad_" spelling, distinguishing the padding token
from the actual word "pad"), remaining words ordered by descending
training-corpus frequency; and per-token loss weights, which the
reference leaves UNIFORM (its log-frequency weighting is commented out,
dataset.py:345-349).

The joint 3DVLP path tokenizes with BERT instead; these builders serve
the CapNet/Scan2Cap legacy pipeline and the reference's json cache
contract ({"word2idx", "idx2word"}).
"""

from __future__ import annotations

import json
import os
from collections import Counter

import numpy as np

SPECIAL_WORDS = ["pad_", "unk", "sos", "eos"]


def build_caption_vocabulary(
    annotations: list,
    *,
    max_des_len: int = 30,
    known_words: set | None = None,
    vocab_path: str | None = None,
) -> dict:
    """annotations: ScanRefer-style dicts with a "token" word list.

    known_words stands in for the reference's GloVe-key filter
    (dataset.py:303-305): words outside it are dropped. Returns
    {"word2idx", "idx2word"}; caches to vocab_path when given (and loads
    an existing cache first, mirroring dataset.py:296-298).
    """
    if vocab_path and os.path.exists(vocab_path):
        with open(vocab_path) as f:
            return json.load(f)

    counter = Counter()
    for data in annotations:
        counter.update(data["token"][:max_des_len])
    items = [
        (w, c)
        for w, c in counter.items()
        if known_words is None or w in known_words
    ]
    items.sort(key=lambda kv: kv[1], reverse=True)
    word_list = [w for w, _ in items]

    word2idx, idx2word = {}, {}
    for i, w in enumerate(word_list):
        shifted = i + len(SPECIAL_WORDS)
        word2idx[w] = shifted
        idx2word[shifted] = w
    for i, w in enumerate(SPECIAL_WORDS):
        word2idx[w] = i
        idx2word[i] = w

    vocab = {
        "word2idx": word2idx,
        "idx2word": {str(k): v for k, v in idx2word.items()},
    }
    if vocab_path:
        with open(vocab_path, "w") as f:
            json.dump(vocab, f, indent=4)
    return vocab


def build_caption_frequency(
    vocab: dict, *, weights_path: str | None = None
) -> np.ndarray:
    """Per-token loss weights — uniform ones, as in the reference (the
    log-frequency scheme at dataset.py:345-349 is commented out there).
    Caches the reference's {index: weight} json when weights_path given."""
    if weights_path and os.path.exists(weights_path):
        with open(weights_path) as f:
            weights = json.load(f)
        return np.array([v for _, v in weights.items()])

    n = len(vocab["word2idx"])
    weights = np.ones((n,))
    if weights_path:
        with open(weights_path, "w") as f:
            json.dump({k: v for k, v in enumerate(weights)}, f, indent=4)
    return weights
