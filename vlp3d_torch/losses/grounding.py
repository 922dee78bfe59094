"""Grounding losses: OID (IoU-guided DIoU reference loss) with its KL
branch, language classification, attribute (vote compactness), the
vote-weight BCE, and the ranking losses.

Counterpart of ``vlp3d/losses/grounding.py``
(lib/loss_helper/loss_grounding.py as masked (B, L, K) tensor math). Quirks
of the reference that are kept:

  * the one-hot ``labels`` use the argmax of the raw ious while the smooth
    labels use the argmax of the objectness-masked ious;
  * epoch < 50: label smoothing 0.95 / 0.05 over the iou >= 0.25 set when
    it has at least 2 members;
  * diou_loss is divided by the batch size only, not the sentence count;
  * ref loss = SoftmaxRankingLoss with the reference's +1e-8 epsilons,
    per-batch mean over valid sentences.

``argmax`` ties go to the lowest index, as in the JAX package. The
heteroscedastic KL branch (``alpha``, ``use_kl_loss``) keeps the
reference's quirks, listed at :func:`compute_diou_loss`.

Under data parallel (``shard``, a
:class:`~vlp3d_torch.parallel.reduce.BatchShard`) every mean over the
batch, masked sum, count and ``/ b`` of the losses and diagnostics is
the global batch's. The focal and sigmoid ranking losses, which no loss
of the joint model calls, stay rank-local.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vlp3d_torch.config import SCANNET_TYPES
from vlp3d_torch.geometry.boxes import box3d_diou
from vlp3d_torch.losses.detection import take_rows
from vlp3d_torch.parallel.reduce import LOCAL


def _lang_mask(lang_num: torch.Tensor, l: int) -> torch.Tensor:
    return (torch.arange(l, device=lang_num.device)[None, :]
            < lang_num[:, None]).float()


def softmax_ranking_loss(inputs, targets, row_mask):
    """-sum(log(softmax(x + 1e-8) + 1e-8) * t), averaged over the masked
    rows of each batch entry (loss.py:10-17)."""
    probs = torch.softmax(inputs + 1e-8, dim=-1)
    per_row = -(torch.log(probs + 1e-8) * targets).sum(dim=-1)
    return (per_row * row_mask).sum(dim=-1) / torch.clamp(
        row_mask.sum(dim=-1), min=1.0)


def softmax_ranking_focal_loss(inputs, targets, mask=None, gamma=2.0,
                               alpha=None):
    """Focal softmax ranking (loss.py:20-51): the target-weighted softmax
    probability p gets alpha * (1 - p)^gamma before -log(p); with ``mask``
    the reduction is sum(loss * mask) / (sum(mask) + 1e-8), else a mean."""
    probs = torch.softmax(inputs + 1e-8, dim=-1)
    if alpha is None:
        a = targets.sum(dim=-1)
    else:
        a = (targets * alpha[..., :targets.shape[-1]]).sum(dim=-1)
    p = (probs * targets).sum(dim=-1)
    loss = -a * (1.0 - p) ** gamma * torch.log(p + 1e-8)
    if mask is None:
        return loss.mean()
    return (loss * mask).sum() / (mask.sum() + 1e-8)


def sigmoid_ranking_loss(inputs, targets):
    """Element-wise BCE on sigmoid(inputs) with explicit +1e-8 epsilons,
    mean over all elements (loss.py:54-70)."""
    probs = torch.sigmoid(inputs)
    loss = (-torch.log(probs + 1e-8) * targets
            - torch.log(1.0 - probs + 1e-8) * (1.0 - targets))
    return loss.mean()


def sigmoid_ranking_focal_loss(inputs, targets, mask=None, gamma=2.0,
                               alpha=(1.0, 1.0)):
    """Focal BCE (loss.py:72-98): alpha = (negative, positive) weights."""
    probs = torch.sigmoid(inputs)
    pos = -alpha[1] * (1.0 - probs) ** gamma * torch.log(probs + 1e-8) * targets
    neg = (-alpha[0] * probs ** gamma * torch.log(1.0 - probs + 1e-8)
           * (1.0 - targets))
    loss = pos + neg
    if mask is None:
        return loss.mean()
    return (loss * mask).sum() / (mask.sum() + 1e-8)


def compute_diou_loss(*, pred_center, pred_size, cluster_ref,
                      objectness_masks, gt_center, gt_size, lang_num, epoch,
                      istrain, random_gate, pred_center_reg=None,
                      pred_size_reg=None, alpha=None, shard=LOCAL) -> dict:
    """OID loss (loss_grounding.py:129-365).

    pred_center/size (B, K, 3); cluster_ref (B*L, K); objectness_masks
    (B, K) float; gt_center/size (B, L, 3) per-sentence reference boxes;
    lang_num (B,); epoch, istrain, random_gate scalars (the gate is the
    step's one uniform draw, shared with the match copy-paste);
    pred_center_reg / pred_size_reg (B, L, K, 3), the regression head's
    offsets, added to every sentence's boxes before the IoU; alpha (B, K,
    6), the KL head's log-variances.

    Returns ref_loss, diou_loss, cluster_labels (raw one-hot),
    smooth_labels, ious (B, L, K), max_iou_rate_0.25 / 0.5, and with
    ``alpha`` the heteroscedastic kl_loss (loss_grounding.py:309-321),
    whose quirks are the reference's:

      * alpha channel 3 is unused: center = alpha[..., 0:3], size =
        alpha[..., 4:6];
      * the SmoothL1 is mean-reduced to one scalar a scene, which then
        multiplies the whole exp(-alpha_center) map;
      * the size branch is SmoothL1(pred, pred) = 0, so it is exactly
        0.5 * sum(alpha_size);
      * predictions and GT are detached: only alpha gets a gradient;
      * a sentence's target proposal is the raw (unmasked) IoU argmax.
    """
    b, k = pred_center.shape[:2]
    l = gt_center.shape[1]
    dev = pred_center.device
    pc, ps = pred_center[:, None], pred_size[:, None]
    if pred_center_reg is not None:
        pc, ps = pc + pred_center_reg, ps + pred_size_reg
    ious, dious = box3d_diou(pc, ps, gt_center[:, :, None],
                             gt_size[:, :, None])
    lang_mask = _lang_mask(lang_num, l)  # (B, L)

    with torch.no_grad():  # the labels carry no gradient
        apply_obj_mask = ((torch.as_tensor(istrain, device=dev) != 0)
                          & (torch.as_tensor(random_gate, device=dev) < 0.5))
        masked_ious = torch.where(
            apply_obj_mask, ious * objectness_masks[:, None, :], ious)
        raw_ind = torch.argmax(ious, dim=-1)  # (B, L)
        max_ious = ious.amax(dim=-1)
        has_pos = (max_ious >= 0.25).float() * lang_mask
        labels = F.one_hot(raw_ind, k).float() * has_pos[..., None]

        masked_onehot = F.one_hot(torch.argmax(masked_ious, dim=-1), k).float()
        smooth_mask = (masked_ious >= 0.25).float()
        cnt = smooth_mask.sum(dim=-1, keepdim=True)
        smoothed = torch.where(
            cnt >= 2,
            smooth_mask * (0.05 / torch.clamp(cnt - 1, min=1.0))
            * (1.0 - masked_onehot) + masked_onehot * 0.95,
            masked_onehot,
        )
        smooth_labels = torch.where(
            torch.as_tensor(epoch, device=dev) < 50, smoothed,
            masked_onehot) * has_pos[..., None]

    preds = cluster_ref.reshape(b, l, k)
    ref_loss = shard.mean(softmax_ranking_loss(preds, smooth_labels,
                                               lang_mask))
    diou_loss = shard.sum(
        ((1.0 - dious) * smooth_labels * lang_mask[..., None]).sum()) / (
            b * shard.world)
    total_lang = torch.clamp(shard.sum(lang_num.sum()), min=1)
    out = {
        "ref_loss": ref_loss,
        "diou_loss": diou_loss,
        "cluster_labels": labels,
        "smooth_labels": smooth_labels,
        "ious": ious,
        "max_iou_rate_0.25": shard.sum(has_pos.sum()) / total_lang,
        "max_iou_rate_0.5": shard.sum(
            ((max_ious >= 0.5).float() * lang_mask).sum()) / total_lang,
    }
    if alpha is not None:
        alpha_center, alpha_size = alpha[..., 0:3], alpha[..., 4:6]
        with torch.no_grad():
            kl_center = torch.gather(
                pred_center, 1, raw_ind[..., None].expand(-1, -1, 3))
            d = (kl_center - gt_center).abs()  # (B, L, 3)
            sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)  # beta 1
            # nn.SmoothL1Loss()'s mean over a scene's (lang_num, 3) rows
            sl1_mean = (sl1 * lang_mask[..., None]).sum(dim=(1, 2)) / \
                torch.clamp(3.0 * lang_num.float(), min=1.0)  # (B,)
        center_term = (sl1_mean * torch.exp(-alpha_center).sum(dim=(1, 2))
                       + 0.5 * alpha_center.sum(dim=(1, 2)))
        size_term = 0.5 * alpha_size.sum(dim=(1, 2))
        out["kl_loss"] = shard.sum((center_term + size_term).sum()) / (
            b * shard.world)
    return out


def compute_lang_classification_loss(lang_scores, object_cat, lang_num,
                                     shard=LOCAL):
    """Per-sentence object-category CE (loss_grounding.py:476-487):
    lang_scores (B*L, num_class), object_cat (B, L), lang_num (B,)."""
    b, l = object_cat.shape
    logp = F.log_softmax(lang_scores.reshape(b, l, -1), dim=-1)
    ce = -torch.gather(logp, -1, object_cat.long()[..., None])[..., 0]
    mask = _lang_mask(lang_num, l)
    per_batch = (ce * mask).sum(dim=-1) / torch.clamp(mask.sum(dim=-1),
                                                      min=1.0)
    return shard.mean(per_batch)


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Sum rows of ``values`` (R[, C]) into ``num_segments`` bins."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, segments.long(), values)


def compute_debug_diagnostics(*, ious, cluster_ref, object_cat, gt_size,
                              lang_num, num_class: int = 18,
                              shard=LOCAL) -> dict:
    """The reference's ``--debug`` diagnostics of the OID loop
    (loss_grounding.py:262-306, 327-345): top_iou_rate_1..5 (mean k-th
    largest raw IoU per sentence), pred_iou_rate_0.25 / 0.5 (mean share of
    proposals above the threshold), class_iou_rate_* / class_size_* (per GT
    class, mean IoU of the raw-argmax prediction and mean GT volume), and
    top_ind (mean ascending rank of the prediction, + 1)."""
    b, l, k = ious.shape
    lang_mask = _lang_mask(lang_num, l)
    total = torch.clamp(shard.sum(lang_num.sum().float()), min=1.0)
    out = {}
    top5 = torch.topk(ious, 5, dim=-1).values  # descending
    top_sums = shard.sum((top5 * lang_mask[..., None]).sum(dim=(0, 1)))
    for i in range(1, 6):
        out[f"top_iou_rate_{i}"] = top_sums[i - 1] / total
    for thr, key in ((0.25, "pred_iou_rate_0.25"), (0.5, "pred_iou_rate_0.5")):
        frac = (ious >= thr).float().mean(dim=-1)
        out[key] = shard.sum((frac * lang_mask).sum()) / total

    pred_ind = torch.argmax(cluster_ref.reshape(b, l, k), dim=-1)
    chosen_iou = torch.gather(ious, -1, pred_ind[..., None])[..., 0]
    flat_cat = object_cat.reshape(-1)
    vol = gt_size.prod(dim=-1)
    # (count, IoU sum, volume sum) of each class, over the global batch
    cnt, iou_sum, vol_sum = shard.sum(torch.stack([
        _segment_sum(v.reshape(-1), flat_cat, num_class)
        for v in (lang_mask, chosen_iou * lang_mask, vol * lang_mask)]))
    cnt = torch.clamp(cnt, min=1.0)
    class_iou = iou_sum / cnt
    class_size = vol_sum / cnt
    names = (SCANNET_TYPES if num_class == len(SCANNET_TYPES)
             else [str(i) for i in range(num_class)])
    for i, name in enumerate(names):
        out[f"class_iou_rate_{name}"] = class_iou[i]
        out[f"class_size_{name}"] = class_size[i]

    rank = (ious < chosen_iou[..., None]).float().sum(dim=-1)
    per_scene = (rank * lang_mask).sum(dim=1) / torch.clamp(lang_num.float(),
                                                            min=1.0)
    out["top_ind"] = shard.mean(per_scene) + 1.0
    return out


def compute_attr_loss(vote_xyz, seed_inds, instance_labels, vote_label_mask,
                      num_instances: int = 256, shard=LOCAL):
    """Vote compactness per instance (loss_grounding.py:71-126): L1
    distance of each vote (B, S, 3) to its instance's mean vote, masked by
    the GT vote mask; the scatter-mean is a fixed-size segment mean."""
    b, s, _ = vote_xyz.shape
    seed_mask = take_rows(vote_label_mask, seed_inds).float()
    seed_instance = take_rows(instance_labels, seed_inds).long()
    # one table of B * num_instances segments
    seg = (seed_instance + torch.arange(b, device=seed_instance.device)[
        :, None] * num_instances).reshape(-1)
    flat = vote_xyz.reshape(b * s, 3)
    seg_sum = _segment_sum(flat, seg, b * num_instances)
    seg_cnt = _segment_sum(flat.new_ones(b * s), seg, b * num_instances)
    seg_mean = seg_sum / torch.clamp(seg_cnt, min=1.0)[:, None]
    attr_dist = (flat - seg_mean[seg]).abs().sum(dim=-1).reshape(b, s)
    return shard.ratio((attr_dist * seed_mask).sum(), seed_mask.sum(), 1e-6)


def compute_vote_weight_loss(vote_weights, seed_inds, vote_label_mask,
                             shard=LOCAL):
    """BCE of the predicted vote weights (B, S, 1) against the GT vote
    mask at the seeds (loss_grounding.py:60-69): p clipped to [1e-7,
    1 - 1e-7], the mean over B x S."""
    target = take_rows(vote_label_mask, seed_inds).float()
    p = torch.clamp(vote_weights[..., 0], 1e-7, 1.0 - 1e-7)
    return -shard.mean(target * torch.log(p)
                       + (1.0 - target) * torch.log(1.0 - p))
