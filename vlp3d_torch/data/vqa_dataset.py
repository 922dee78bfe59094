"""ScanQA dataset (question answering over ScanNet scenes).

The port's own copy of ``vlp3d/data/vqa_dataset.py`` (the reference's
``lib/vqa/dataset.py:79-500``, ScannetQADataset) reduced to the
fields the JointNet/ScanQA training paths consume: per-question BERT
token ids, multi-answer labels against a training answer vocabulary
(answer_cat / answer_cats multi-hot / answer_cat_scores), plus the same
scene GT tensors as the joint dataset. The answer vocabulary is built from
training answers (train_qa.py:32-45).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from vlp3d_torch.data.dataset import ScanReferJointDataset


def answer_score(freq: int) -> float:
    """Soft BCE target per answer frequency (lib/vqa/dataset.py:36-46):
    0->0, 1->0.3, 2->0.6, 3->0.9, >=4->1.0."""
    return 1.0 if freq >= 4 else (0.0, 0.3, 0.6, 0.9)[freq]


def build_answer_vocab(
    qa_annotations: list, min_count: int = 1, max_size: int = -1
):
    """Alphabetically-ordered answer candidates + the frequency counter
    (train_qa.py:32-45: Counter.most_common() capped at answer_max_size,
    filtered by answer_min_freq, then sorted keys).

    Returns (vocab: answer -> index, counter: answer -> train frequency).
    """
    # Counter over the SORTED answer list (train.py:113-114): ties in
    # most_common() then break alphabetically, which decides what the
    # answer_max_size cutoff keeps
    counts = Counter(
        sorted(a for q in qa_annotations for a in q.get("answers", []))
    )
    items = counts.most_common()
    if max_size >= 0:
        items = items[:max_size]
    kept = {a: c for a, c in items if c >= min_count}
    vocab = {a: i for i, a in enumerate(sorted(kept))}
    return vocab, kept


class ScanQADataset(ScanReferJointDataset):
    """Each chunk entry is a question; ref labels point at the question's
    linked object(s) when provided (ScanQA-style annotations carry
    object_ids/object_names lists)."""

    def __init__(self, qa_annotations, scene_source, tokenizer, *,
                 answer_vocab: dict | None = None, num_answers: int | None = None,
                 use_unanswerable: bool = False,
                 **kwargs):
        """Pass glove=<dict> (see ScanReferJointDataset) to also carry the
        GloVe-era LSTM language fields the standalone ScanQA model
        consumes (lib/vqa/dataset.py's lang path).

        use_unanswerable: keep questions with no answer in the vocabulary
        (lib/vqa/dataset.py:102-124 drops them from train AND val by
        default, which sets the EM metric denominators)."""
        anns = []
        for q in qa_annotations:
            object_ids = q.get("object_ids") or [0]
            object_names = q.get("object_names") or ["others"]
            anns.append(
                {
                    "scene_id": q["scene_id"],
                    "object_id": str(object_ids[0]),
                    "object_name": "_".join(object_names[0].split()),
                    # ann_id must be numeric for the joint dataset's
                    # ann_id_list; the ScanQA question_id (a string like
                    # "train-scene0000-0") rides along separately
                    "ann_id": str(len(anns)),
                    "question_id": str(q.get("question_id", len(anns))),
                    "token": q["question"].split(),
                    "answers": q.get("answers", []),
                }
            )
        answer_counter = kwargs.pop("answer_counter", None)
        if answer_vocab is None:
            answer_vocab, answer_counter = build_answer_vocab(anns)
        else:
            answer_counter = answer_counter or {}
        self.answer_vocab = answer_vocab
        self.answer_counter = answer_counter
        self.num_answers = num_answers or max(len(self.answer_vocab), 1)
        self.all_data_size = len(anns)
        if kwargs.get("split", "train") != "test" and not use_unanswerable:
            cands = set(self.answer_vocab)
            anns = [a for a in anns if set(a["answers"]) & cands]
        self.answerable_data_size = len(anns)
        super().__init__(anns, scene_source, tokenizer, **kwargs)

    def get_item(self, idx, out=None):
        item = super().get_item(idx, out)
        chunk = self.chunks[idx]
        l = self.lang_num_max
        answer_cat = np.zeros((l,), np.int32)
        answer_cats = np.zeros((l, self.num_answers), np.float32)
        answer_scores = np.zeros((l, self.num_answers), np.float32)
        for j in range(l):
            data = chunk[min(j, len(chunk) - 1)]
            for a in data.get("answers", []):
                ind = self.answer_vocab.get(a, -1)
                if ind < 0:
                    continue
                answer_cats[j, ind] = 1.0
                # per-answer soft score from train frequency
                # (lib/vqa/dataset.py:195-206)
                answer_scores[j, ind] = answer_score(
                    self.answer_counter.get(a, 0)
                )
            # answer_cat = answer_cats.argmax() (dataset.py:210): the
            # LOWEST labelled vocab index, not the first listed answer
            answer_cat[j] = int(np.argmax(answer_cats[j]))
        item["answer_cat"] = answer_cat  # (L,)
        item["answer_cats"] = answer_cats  # (L, A) multi-hot
        item["answer_cat_scores"] = answer_scores  # (L, A) soft targets
        return item
