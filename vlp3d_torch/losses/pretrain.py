"""The legacy sentence <-> proposal InfoNCE of pretraining.

Counterpart of ``vlp3d/losses/pretrain.py`` (the reference's
``lib/loss_helper/loss_pretrain.py:4-36``, superseded there by the
contrast module's OCC / OSC losses). The reference drops invalid rows and
columns by boolean indexing; here, as in the JAX package, invalid
columns are filled with -1e9 before the softmax and the diagonal is
averaged over the valid rows, which is the same up to exp(-1e9)
underflowing to 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def compute_contrastive_loss(sim_l2p: torch.Tensor, sim_p2l: torch.Tensor,
                             positive_labels: torch.Tensor,
                             contrast_mask: torch.Tensor) -> torch.Tensor:
    """sim_l2p (L, K) sentence -> proposal and sim_p2l (K, L) proposal ->
    sentence similarities, positive_labels (L,) each sentence's proposal,
    contrast_mask (B, lang_num_max) the valid sentences -> the symmetric
    loss divided by B."""
    batch_size = contrast_mask.shape[0]
    m = contrast_mask.reshape(-1).bool()
    labels = positive_labels.long()
    n = torch.clamp(m.sum(), min=1)

    def masked_nce(s: torch.Tensor) -> torch.Tensor:
        logits = torch.where(m[None, :], s, torch.full_like(s, -1e9))
        diag = torch.diagonal(F.log_softmax(logits, dim=1))
        return -torch.where(m, diag, torch.zeros_like(diag)).sum() / n

    return (masked_nce(sim_l2p[:, labels])
            + masked_nce(sim_p2l[labels, :])) / batch_size
