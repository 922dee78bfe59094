"""Detection losses: vote, objectness, box + semantic classification.

Counterpart of ``vlp3d/losses/detection.py``
(lib/loss_helper/loss_detection.py: thresholds NEAR = FAR = 0.3,
objectness CE weights [0.2, 0.8], GT_VOTE_FACTOR = 3, distance huber
delta 0.15). All reductions are masked sums over the reference's +1e-6
denominators. Like the reference, GT boxes are zero-padded to MAX_NUM_OBJ
and the padding rows take part in the proposal <-> GT center matching.
Under data parallel (``shard``, a
:class:`~vlp3d_torch.parallel.reduce.BatchShard`) each sum and
denominator is the global batch's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vlp3d_torch.geometry.boxes import rotate_rotz_rows
from vlp3d_torch.geometry.nn_distance import huber_loss, nn_distance
from vlp3d_torch.parallel.reduce import LOCAL

NEAR_THRESHOLD = 0.3
FAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def _masked_mean(x, mask, eps=1e-6, shard=LOCAL):
    return shard.ratio((x * mask).sum(), mask.sum(), eps)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Label lookup x[b, idx[b, m]] for x (B, N) or (B, N, C) and idx
    (B, M) of any integer type."""
    idx = idx.long()
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _pick(logp: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, label.long()[..., None])[..., 0]


def compute_vote_loss(seed_xyz, vote_xyz, seed_inds, vote_label,
                      vote_label_mask, shard=LOCAL):
    """Min-of-min L1 Chamfer between the predicted votes (B, S*vf, 3) and
    the 3 GT votes of each seed (loss_detection.py:24-71)."""
    b, s, _ = seed_xyz.shape
    vf = vote_xyz.shape[1] // s
    seed_gt_mask = take_rows(vote_label_mask, seed_inds)
    seed_gt_votes = take_rows(vote_label, seed_inds)  # (B, S, 9)
    seed_gt_votes = seed_gt_votes + seed_xyz.repeat(1, 1, GT_VOTE_FACTOR)
    votes = vote_xyz.reshape(b * s, vf, 3)
    gt = seed_gt_votes.reshape(b * s, GT_VOTE_FACTOR, 3)
    _, _, dist2, _ = nn_distance(votes, gt, l1=True)
    votes_dist = dist2.amin(dim=1).reshape(b, s)
    return _masked_mean(votes_dist, seed_gt_mask.float(), shard=shard)


def compute_objectness_loss(aggregated_vote_xyz, objectness_scores,
                            center_label, shard=LOCAL, *,
                            far_threshold: float = FAR_THRESHOLD):
    """Proposal <-> GT center matching + weighted CE
    (loss_detection.py:73-113). Returns (loss, objectness_label (B, K)
    int64, objectness_mask (B, K) f32, object_assignment (B, K) int32).
    ``far_threshold``: the joint path has no gray zone (NEAR = FAR = 0.3);
    the ScanQA path keeps VoteNet's FAR = 0.6 (lib/vqa/loss_helper.py:18-19).
    """
    dist1, ind1, _, _ = nn_distance(aggregated_vote_xyz, center_label)
    euclid = torch.sqrt(dist1.detach() + 1e-6)
    near = euclid < NEAR_THRESHOLD
    label = near.long()
    mask = (near | (euclid > far_threshold)).float()
    logp = F.log_softmax(objectness_scores, dim=-1)
    w = logp.new_tensor(OBJECTNESS_CLS_WEIGHTS)[label]
    ce = -w * _pick(logp, label)
    return _masked_mean(ce, mask, shard=shard), label, mask, ind1


def recover_assigned_gt_bboxes(aggregated_vote_xyz, object_assignment,
                               center_label, heading_class_label,
                               heading_residual_label, size_class_label,
                               size_residual_label, mean_size_arr,
                               num_heading_bin: int) -> dict:
    """Gather the assigned GT box parameters and derive the 6-face
    distance targets (loss_detection.py:153-211)."""
    ga = object_assignment
    gt_center = take_rows(center_label, ga)
    hcls = take_rows(heading_class_label, ga)
    hres = take_rows(heading_residual_label, ga)
    if num_heading_bin != 1:
        gt_heading = hcls.float() * (2 * math.pi / num_heading_bin) + hres
    else:  # ScanNet: heading identically 0
        gt_heading = torch.zeros_like(hres)
    scls = take_rows(size_class_label, ga)
    sres = take_rows(size_residual_label, ga)
    gt_size = mean_size_arr[scls.long()] + sres  # (B, K, 3)
    half = gt_size / 2.0
    rel = rotate_rotz_rows(aggregated_vote_xyz - gt_center, -gt_heading)
    return {
        "gt_center": gt_center,
        "gt_heading_class": hcls,
        "gt_heading_residual": hres,
        "gt_heading": gt_heading,
        "gt_distance": torch.cat([half + rel, half - rel], dim=-1),
        "gt_size": gt_size,
    }


def compute_box_and_sem_cls_loss(preds: dict, targets: dict,
                                 objectness_label, num_heading_bin: int,
                                 mean_size_arr, shard=LOCAL):
    """Heading cls/reg + 6-distance huber + semantic CE
    (loss_detection.py:116-150, 215-258). Returns (heading_cls_loss,
    heading_reg_loss, size_distance_loss, sem_cls_loss)."""
    gt = recover_assigned_gt_bboxes(
        preds["aggregated_vote_xyz"], preds["object_assignment"],
        targets["center_label"], targets["heading_class_label"],
        targets["heading_residual_label"], targets["size_class_label"],
        targets["size_residual_label"], mean_size_arr, num_heading_bin,
    )
    obj = objectness_label.float()

    logp = F.log_softmax(preds["heading_scores"], dim=-1)
    heading_cls_loss = _masked_mean(-_pick(logp, gt["gt_heading_class"]),
                                    obj, shard=shard)

    hres_norm_label = gt["gt_heading_residual"] / (math.pi / num_heading_bin)
    onehot = F.one_hot(gt["gt_heading_class"].long(), num_heading_bin).float()
    pred_res = (preds["heading_residuals_normalized"] * onehot).sum(dim=-1)
    heading_reg_loss = _masked_mean(
        huber_loss(pred_res - hres_norm_label, delta=1.0), obj, shard=shard)

    dist_loss = huber_loss(preds["rois"] - gt["gt_distance"],
                           delta=0.15).mean(dim=-1)
    size_distance_loss = _masked_mean(dist_loss, obj, shard=shard)

    sem_label = take_rows(targets["sem_cls_label"], preds["object_assignment"])
    logp = F.log_softmax(preds["sem_cls_scores"], dim=-1)
    sem_cls_loss = _masked_mean(-_pick(logp, sem_label), obj, shard=shard)
    return heading_cls_loss, heading_reg_loss, size_distance_loss, sem_cls_loss
