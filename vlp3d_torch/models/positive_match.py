"""Positive match: each sentence's best-IoU proposal.

Counterpart of ``vlp3d/models/positive_match.py`` (the reference's
``models/positive_match_module/positive_match_module.py:30-86``, whose
JointNet call site is commented out): the axis-aligned IoU of every
proposal against each sentence's GT box (:func:`box3d_diou`), the
``argmax`` proposal as ``positive_labels`` (the lowest index on a tie,
proposal 0 on a row of zero IoUs, as ``jnp.argmax``), its IoU as
``target_ious``, ``good_bbox_masks`` where it reaches 0.25, and
``pred_ious``, their mean over the good rows.
"""

from __future__ import annotations

import torch

from vlp3d_torch.geometry.boxes import box3d_diou


def positive_match(pred_center: torch.Tensor, pred_size: torch.Tensor,
                   gt_center: torch.Tensor, gt_size: torch.Tensor) -> dict:
    """pred_center, pred_size (B, K, 3); gt_center, gt_size (B, L, 3) ->
    positive_labels, target_ious, good_bbox_masks (B * L,), pred_ious."""
    ious, _ = box3d_diou(pred_center[:, None], pred_size[:, None],
                         gt_center[:, :, None], gt_size[:, :, None])
    b, l, _ = ious.shape
    target_ious, _ = ious.max(dim=-1)
    positive_labels = torch.argmax(ious, dim=-1)
    target_ious = target_ious.reshape(b * l)
    good = target_ious >= 0.25
    pred_ious = (target_ious * good).sum() / torch.clamp(good.sum(), min=1)
    return {"positive_labels": positive_labels.reshape(b * l),
            "target_ious": target_ious, "good_bbox_masks": good,
            "pred_ious": pred_ious}
