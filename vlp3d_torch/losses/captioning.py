"""Caption and masked-LM losses.

Counterpart of ``vlp3d/losses/captioning.py`` (the reference's
loss_captioning.py:25-73 and the MLM loss of
transformer_captioner.forward_mlm, :437-464). ``lang_cap`` / ``lang_mlm``
are log-probabilities; the cross entropy takes a log-softmax of them
again, as the JAX package does (softmax is shift-invariant). Under data
parallel (``shard``) the sums and counts are the global batch's.
"""

from __future__ import annotations

import torch

from vlp3d_torch.parallel.reduce import LOCAL


def _token_ce(logits: torch.Tensor, input_ids: torch.Tensor):
    """Next-token CE of each (sentence, word) slot and its targets: the
    words 1..num_words of each sentence."""
    b, l, t = input_ids.shape
    num_words = logits.shape[1]
    targets = input_ids.reshape(b * l, t)[:, 1:num_words + 1].long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return ce * (targets != 0).float(), targets  # ignore_index = 0


def _good_mean(ce: torch.Tensor, good_bbox_masks: torch.Tensor,
               shard=LOCAL):
    """Sum over good boxes' slots over the count of good (box, word) slots
    (not of non-pad tokens: loss_captioning.py:47-48)."""
    good = good_bbox_masks.float()[:, None]
    return shard.ratio((ce * good).sum(), good.expand(ce.shape).sum(), 1e-6)


def compute_cap_loss(lang_cap: torch.Tensor, input_ids: torch.Tensor,
                     good_bbox_masks: torch.Tensor, pad_token_id: int = 0,
                     shard=LOCAL):
    """lang_cap (B*L, T-1, vocab) log-probs; input_ids (B, L, T);
    good_bbox_masks (B*L,) bool -> (cap_loss, cap_acc): the token CE
    (pad ignored) over good boxes, and the accuracy over the non-pad
    tokens of good boxes."""
    ce, targets = _token_ce(lang_cap, input_ids)
    cap_loss = _good_mean(ce, good_bbox_masks, shard)
    pred = torch.argmax(lang_cap, dim=-1)
    acc_mask = ((targets != pad_token_id).float()
                * good_bbox_masks.float()[:, None])
    cap_acc = (shard.sum(((pred == targets).float() * acc_mask).sum())
               / shard.sum(acc_mask.sum()).clamp(min=1.0))
    return cap_loss, cap_acc


def compute_mlm_loss(lang_mlm: torch.Tensor, input_ids: torch.Tensor,
                     mask_index: torch.Tensor,
                     good_bbox_masks: torch.Tensor,
                     shard=LOCAL) -> torch.Tensor:
    """The next-token CE (pad ignored) at the masked input positions
    ``mask_index`` (B*L, T-1), normalised by the good (box, word) slots."""
    ce, _ = _token_ce(lang_mlm, input_ids)
    return _good_mean(ce * mask_index.float(), good_bbox_masks, shard)
