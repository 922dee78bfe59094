"""ScanQA evaluation: answer EM@1 / EM@10.

Counterpart of ``vlp3d/eval/vqa.py`` (lib/vqa/eval_helper.py:218-259):
a question counts as answered at k when any of its labelled answers is
among the k highest logits. Ties go to the lowest answer index, as
``jnp.argmax`` and ``lax.top_k`` break them (``top_k_first``).
"""

from __future__ import annotations

import torch

from vlp3d_torch.models.caption import top_k_first


def answer_hits(answer_scores: torch.Tensor, answer_cats: torch.Tensor,
                topk: int = 10):
    """answer_scores (R, A) logits; answer_cats (R, A) multi-hot labels ->
    (hit@1, hit@topk), bool (R,) each; their means are the JAX package's
    ``answer_accuracy``."""
    at1 = torch.argmax(answer_scores, dim=1)
    hit1 = answer_cats.gather(1, at1[:, None])[:, 0] > 0
    _, idx = top_k_first(answer_scores, min(topk, answer_scores.shape[1]))
    hitk = answer_cats.gather(1, idx).amax(dim=1) > 0
    return hit1, hitk

