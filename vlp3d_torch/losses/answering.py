"""VQA answer classification loss.

Counterpart of ``vlp3d/losses/answering.py``
(lib/loss_helper/loss_answering.py:2-16): multi-answer BCE with logits
against soft targets, summed and divided by the number of rows (every
one of the B*L question slots, the padded ones included), or plain
cross-entropy against one answer index a row.
"""

from __future__ import annotations

import torch


def compute_answer_classification_loss(
        answer_scores: torch.Tensor,
        answer_cat_scores: torch.Tensor | None = None,
        answer_cat: torch.Tensor | None = None) -> torch.Tensor:
    """answer_scores (N, A) logits; answer_cat_scores (N, A) soft labels
    (the BCE branch, taken when given) or answer_cat (N,) indices."""
    if answer_cat_scores is not None:
        x, t = answer_scores, answer_cat_scores
        # the stable form JAX writes: max(x, 0) - x t + log1p(exp(-|x|))
        bce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
        return bce.sum() / x.shape[0]
    logp = torch.log_softmax(answer_scores, dim=-1)
    return -logp.gather(1, answer_cat.long()[:, None])[:, 0].mean()
