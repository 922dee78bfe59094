"""Losses of the standalone ScanQA model (VoteNet heading / size class +
residual form).

Counterpart of ``vlp3d/losses/vqa.py`` (the reference's
``lib/loss_helper/loss_vqa.py``): vote loss; objectness with VoteNet's
0.3 / 0.6 gray zone; centre Chamfer + heading and size class CE +
normalised-residual hubers + semantic CE; the reference loss, a
softmax ranking loss against the one-hot of the proposal with the best
axis-aligned IoU to the question's object (``argmax``: proposal 0 when
every IoU is 0); the language object-class CE; the answer loss. Total =
10 x (vote + objectness + box + sem + ref + lang + answer)
(loss_vqa.py:347-356: sem_cls enters twice, at 0.1 inside box and once
on its own).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vlp3d_torch.geometry.boxes import box3d_iou_aabb
from vlp3d_torch.geometry.nn_distance import huber_loss, nn_distance
from vlp3d_torch.losses.answering import compute_answer_classification_loss
from vlp3d_torch.losses.detection import (
    _masked_mean,
    _pick,
    compute_objectness_loss,
    compute_vote_loss,
    take_rows,
)
from vlp3d_torch.losses.grounding import softmax_ranking_loss


def compute_vqa_box_loss(outputs, batch, objectness_label, object_assignment,
                         mean_size_arr, num_heading_bin):
    """(center, heading cls, heading reg, size cls, size reg, sem cls)
    losses over the positive proposals (loss_vqa.py:117-192)."""
    obj = objectness_label.float()
    ga = object_assignment.long()
    dist1, _, dist2, _ = nn_distance(outputs["center"],
                                     batch["center_label"][..., 0:3])
    center = (_masked_mean(dist1, obj)
              + _masked_mean(dist2, batch["box_label_mask"].float()))

    hcls_label = take_rows(batch["heading_class_label"], ga).long()
    hcls = _masked_mean(-_pick(F.log_softmax(outputs["heading_scores"], -1),
                               hcls_label), obj)
    hres_label = take_rows(batch["heading_residual_label"], ga) / (
        math.pi / num_heading_bin)
    pred_res = (outputs["heading_residuals_normalized"]
                * F.one_hot(hcls_label, num_heading_bin)).sum(-1)
    hreg = _masked_mean(huber_loss(pred_res - hres_label, 1.0), obj)

    scls_label = take_rows(batch["size_class_label"], ga).long()
    scls = _masked_mean(-_pick(F.log_softmax(outputs["size_scores"], -1),
                               scls_label), obj)
    sres_label = take_rows(batch["size_residual_label"], ga)
    sres_label_norm = sres_label / mean_size_arr[scls_label]
    s_onehot = F.one_hot(scls_label, mean_size_arr.shape[0])[..., None]
    pred_sres = (outputs["size_residuals_normalized"] * s_onehot).sum(-2)
    sreg = _masked_mean(
        huber_loss(pred_sres - sres_label_norm, 1.0).mean(-1), obj)

    sem_label = take_rows(batch["sem_cls_label"], ga).long()
    sem = _masked_mean(-_pick(F.log_softmax(outputs["sem_cls_scores"], -1),
                              sem_label), obj)
    return center, hcls, hreg, scls, sreg, sem


def compute_vqa_reference_loss(outputs, batch, mean_size_arr):
    """Best-IoU proposal one-hot + softmax ranking loss
    (loss_vqa.py:195-245), one reference a question -> (loss, labels
    (B, K), ious (B, K))."""
    gt_center = batch["ref_center_label"][..., 0:3]
    gt_size = (mean_size_arr[batch["ref_size_class_label"].long()]
               + batch["ref_size_residual_label"])
    ious = box3d_iou_aabb(outputs["pred_center"], outputs["pred_size"],
                          gt_center[:, None, :], gt_size[:, None, :])
    labels = F.one_hot(torch.argmax(ious.detach(), dim=-1),
                       ious.shape[-1]).float()
    row_mask = ious.new_ones(ious.shape[0], 1)
    loss = softmax_ranking_loss(outputs["cluster_ref"][:, None, :],
                                labels[:, None, :], row_mask).mean()
    return loss, labels, ious


def compute_vqa_loss(outputs, batch, mean_size_arr, *, num_heading_bin=1,
                     use_reference=True, use_lang_classifier=True,
                     use_answer=True, loss_weights=None):
    """get_loss (loss_vqa.py:268-357): ``outputs`` ScanQA's, ``batch``
    the squeezed ScanQA batch (one question a scene: ref_center_label,
    ref_size_class_label, ref_size_residual_label, object_cat,
    answer_cat_scores / answer_cat), ``mean_size_arr`` a (NS, 3) tensor
    on the outputs' device. Returns (loss, metrics)."""
    w = loss_weights or {}
    m = {}
    vote_loss = compute_vote_loss(
        outputs["seed_xyz"], outputs["vote_xyz"], outputs["seed_inds"],
        batch["vote_label"], batch["vote_label_mask"])
    obj_loss, obj_label, obj_mask, assignment = compute_objectness_loss(
        outputs["aggregated_vote_xyz"], outputs["objectness_scores"],
        batch["center_label"][..., 0:3], far_threshold=0.6)
    center, hcls, hreg, scls, sreg, sem = compute_vqa_box_loss(
        outputs, batch, obj_label, assignment, mean_size_arr,
        num_heading_bin)
    box_loss = center + 0.1 * hcls + hreg + 0.1 * scls + sreg
    m.update(vote_loss=vote_loss, objectness_loss=obj_loss,
             center_loss=center, heading_cls_loss=hcls,
             heading_reg_loss=hreg, size_cls_loss=scls, size_reg_loss=sreg,
             sem_cls_loss=sem, box_loss=box_loss, objectness_label=obj_label,
             objectness_mask=obj_mask, object_assignment=assignment)

    zero = vote_loss.new_zeros(())
    ref_loss = zero
    if use_reference:
        ref_loss, cluster_labels, _ = compute_vqa_reference_loss(
            outputs, batch, mean_size_arr)
        m["cluster_labels"] = cluster_labels
    m["ref_loss"] = ref_loss

    lang_loss = zero
    if use_lang_classifier and "lang_scores" in outputs:
        lang_loss = -_pick(F.log_softmax(outputs["lang_scores"], -1),
                           batch["object_cat"].long()).mean()
    m["lang_loss"] = lang_loss

    answer_loss = zero
    if use_answer:
        answer_loss = compute_answer_classification_loss(
            outputs["answer_scores"], batch.get("answer_cat_scores"),
            batch.get("answer_cat"))
    m["answer_loss"] = answer_loss

    loss = (w.get("vote_loss", 1.0) * vote_loss
            + w.get("objectness_loss", 1.0) * obj_loss
            + w.get("box_loss", 1.0) * box_loss
            + w.get("sem_cls_loss", 1.0) * sem
            + w.get("ref_loss", 1.0) * ref_loss
            + w.get("lang_loss", 1.0) * lang_loss
            + w.get("answer_loss", 1.0) * answer_loss) * 10.0
    m["loss"] = loss
    return loss, m
