"""BERT WordPiece tokenizer (self-contained, HF-compatible).

The port's own copy of ``vlp3d/data/tokenizer.py``: the same ids for
the same text and vocabulary.

Replaces the vendored `models/lang_bert_module/bert/tokenization_bert.py`
(and the reference's dependence on a downloaded bert-base-uncased
tokenizer): basic tokenization (lowercase, accent-strip, punctuation
split) + greedy longest-match WordPiece against a user-supplied vocab.txt.
Special-token ids follow bert-base-uncased: PAD=0, UNK=100, CLS=101,
SEP=102, MASK=103.

When no vocab file is available (zero-egress CI), `HashTokenizer` provides
a deterministic stand-in with the same interface and id space so the full
pipeline runs end-to-end.
"""

from __future__ import annotations

import unicodedata

import numpy as np

PAD, UNK, CLS, SEP, MASK = 0, 100, 101, 102, 103


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (
        33 <= cp <= 47
        or 58 <= cp <= 64
        or 91 <= cp <= 96
        or 123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out, buf = [], []
    for ch in text:
        if ch.isspace():
            if buf:
                out.append("".join(buf))
                buf = []
        elif _is_punctuation(ch):
            if buf:
                out.append("".join(buf))
                buf = []
            out.append(ch)
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


class BertWordPieceTokenizer:
    """Greedy longest-match WordPiece, matching HF BertTokenizer output."""

    pad_token_id = PAD
    unk_token_id = UNK
    cls_token_id = CLS
    sep_token_id = SEP
    mask_token_id = MASK

    def __init__(self, vocab_path: str, max_word_chars: int = 100):
        self.vocab: dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.vocab_size = len(self.vocab)
        self.max_word_chars = max_word_chars
        # special ids resolved from the vocab (bert-base-uncased positions
        # are the defaults; custom vocabs may place them elsewhere)
        self.pad_token_id = self.vocab.get("[PAD]", PAD)
        self.unk_token_id = self.vocab.get("[UNK]", UNK)
        self.cls_token_id = self.vocab.get("[CLS]", CLS)
        self.sep_token_id = self.vocab.get("[SEP]", SEP)
        self.mask_token_id = self.vocab.get("[MASK]", MASK)

    def wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_token_id]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_token_id]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize_ids(self, text: str) -> list[int]:
        ids = []
        for w in basic_tokenize(text):
            ids.extend(self.wordpiece(w))
        return ids

    def __call__(self, texts, max_length: int = 50):
        """Batch encode -> dict of (N, max_length) int32 arrays with CLS/SEP
        framing, truncation, and PAD padding (HF padding='max_length')."""
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        input_ids = np.zeros((n, max_length), np.int32)
        attention = np.zeros((n, max_length), np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenize_ids(t)[: max_length - 2]
            seq = [self.cls_token_id] + ids + [self.sep_token_id]
            input_ids[i, : len(seq)] = seq
            attention[i, : len(seq)] = 1
        return {"input_ids": input_ids, "attention_mask": attention}

    def decode(self, ids) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in (self.pad_token_id, self.cls_token_id):
                continue
            if i == self.sep_token_id:
                break
            tok = self.inv_vocab.get(i, "[UNK]")
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)


class HashTokenizer:
    """Deterministic vocab-free fallback with the BERT id layout."""

    pad_token_id = PAD
    unk_token_id = UNK
    cls_token_id = CLS
    sep_token_id = SEP
    mask_token_id = MASK
    vocab_size = 30522

    def tokenize_ids(self, text: str) -> list[int]:
        ids = []
        for w in basic_tokenize(text):
            h = 1000 + (hash(w) % (self.vocab_size - 1004))
            ids.append(h)
        return ids

    def __call__(self, texts, max_length: int = 50):
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        input_ids = np.zeros((n, max_length), np.int32)
        attention = np.zeros((n, max_length), np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenize_ids(t)[: max_length - 2]
            seq = [CLS] + ids + [SEP]
            input_ids[i, : len(seq)] = seq
            attention[i, : len(seq)] = 1
        return {"input_ids": input_ids, "attention_mask": attention}

    def decode(self, ids) -> str:
        # truncate at the first SEP like BertWordPieceTokenizer.decode
        # (decode_caption relies on it; a non-stopping decode leaked
        # post-SEP tokens into caption candidates on the hash-vocab path)
        words = []
        for i in ids:
            i = int(i)
            if i in (PAD, CLS):
                continue
            if i == SEP:
                break
            words.append(f"tok{i}")
        return " ".join(words)


def load_tokenizer(vocab_path: str | None = None):
    if vocab_path:
        return BertWordPieceTokenizer(vocab_path)
    return HashTokenizer()
