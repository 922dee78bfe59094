"""Joint loss orchestrator.

Counterpart of ``vlp3d/losses/joint.py`` (get_joint_loss,
lib/loss_helper/loss_joint.py:26-227) for the flags the port implements
(detection and reference losses always on, the language classifier
always present):

  total = 10 * (vote + 0.1 * objectness + box)
        + ref * (0.3 if epoch < 50 else 1.0)
        + 0.3 * diou + 0.3 * lang + 0.3 * attr
        + (epoch >= 50) * (0.5 * lang_con + 2.5 * iou_con)
        + 10 * mlm + answer + cap
  where box = 0.1 * heading_cls + heading_reg + 0.1 * sem_cls
            + 20 * size_distance.

The epoch-conditional weights are tensor ``where`` gates, so ``epoch`` may
be a tensor on the device and no step synchronises on it.
"""

from __future__ import annotations

import torch

from vlp3d_torch.config import Config
from vlp3d_torch.losses.answering import compute_answer_classification_loss
from vlp3d_torch.losses.captioning import compute_cap_loss, compute_mlm_loss
from vlp3d_torch.losses.detection import (
    compute_box_and_sem_cls_loss,
    compute_objectness_loss,
    compute_vote_loss,
)
from vlp3d_torch.losses.grounding import (
    compute_attr_loss,
    compute_debug_diagnostics,
    compute_diou_loss,
    compute_lang_classification_loss,
)
from vlp3d_torch.models.jointnet import ref_gt_boxes


def compute_joint_loss(config: Config, outputs: dict, batch: dict, *,
                       caption: bool = False):
    """Returns (total_loss, metrics dict). ``outputs`` is JointNet's
    forward dict; ``batch`` carries the GT labels and the epoch / istrain
    / random scalars, all as tensors on the outputs' device. The MLM term
    counts whenever the outputs hold ``lang_mlm``, the answer term
    whenever they hold ``answer_scores`` (BCE on ``answer_cat_scores``
    when the batch has them, else cross-entropy on ``answer_cat``; labels
    of shape (B, L, ...) are flattened to the B*L rows), the caption term
    and ``cap_acc`` with ``caption`` (the JAX package's flag: its eval step
    leaves them out)."""
    cfg_l, cfg_m, ds = config.loss, config.model, config.dataset
    dev = outputs["seed_xyz"].device
    mean_size = torch.as_tensor(ds.mean_size_arr(), device=dev)
    epoch = torch.as_tensor(batch["epoch"], device=dev)
    m = {}

    vote_loss = compute_vote_loss(
        outputs["seed_xyz"], outputs["vote_xyz"], outputs["seed_inds"],
        batch["vote_label"], batch["vote_label_mask"])
    objectness_loss, objectness_label, objectness_mask, object_assignment = (
        compute_objectness_loss(outputs["aggregated_vote_xyz"],
                                outputs["objectness_scores"],
                                batch["center_label"][..., 0:3]))
    m["objectness_label"] = objectness_label
    m["objectness_mask"] = objectness_mask
    m["object_assignment"] = object_assignment
    total_props = objectness_label.shape[0] * objectness_label.shape[1]
    m["pos_ratio"] = objectness_label.float().sum() / total_props
    m["neg_ratio"] = objectness_mask.sum() / total_props - m["pos_ratio"]

    preds = dict(outputs)
    preds["object_assignment"] = object_assignment
    hcls, hreg, size_dist, sem_cls = compute_box_and_sem_cls_loss(
        preds, batch, objectness_label, ds.num_heading_bin, mean_size)
    box_loss = 0.1 * hcls + hreg + 0.1 * sem_cls + 20.0 * size_dist

    obj_pred = torch.argmax(outputs["objectness_scores"], dim=-1)
    m["obj_acc"] = ((obj_pred == objectness_label).float()
                    * objectness_mask).sum() / (objectness_mask.sum() + 1e-6)
    m.update(vote_loss=vote_loss, objectness_loss=objectness_loss,
             heading_cls_loss=hcls, heading_reg_loss=hreg,
             size_distance_loss=size_dist, sem_cls_loss=sem_cls,
             box_loss=box_loss)

    loss = ((vote_loss + 0.1 * objectness_loss + box_loss)
            * cfg_l.detection_scale)

    gt_center, gt_size = ref_gt_boxes(batch, mean_size)
    diou = compute_diou_loss(
        pred_center=outputs["pred_center"],
        pred_size=outputs["pred_size"],
        cluster_ref=outputs["cluster_ref"],
        objectness_masks=outputs["objectness_masks"],
        gt_center=gt_center, gt_size=gt_size,
        lang_num=batch["lang_num"], epoch=epoch,
        istrain=batch["istrain"], random_gate=batch["random"],
    )
    for key in ("ref_loss", "diou_loss", "cluster_labels",
                "max_iou_rate_0.25", "max_iou_rate_0.5"):
        m[key] = diou[key]
    if cfg_l.debug:
        m.update(compute_debug_diagnostics(
            ious=diou["ious"], cluster_ref=outputs["cluster_ref"],
            object_cat=batch["object_cat_list"], gt_size=gt_size,
            lang_num=batch["lang_num"]))
    ref_w = torch.where(
        epoch < cfg_l.num_ground_epoch,
        loss.new_tensor(cfg_l.ref_weight_before_50),
        loss.new_tensor(cfg_l.ref_weight_after_50))
    loss = loss + ref_w * diou["ref_loss"]
    if cfg_l.use_diou_loss:
        loss = loss + cfg_l.diou_weight * diou["diou_loss"]
    lang_loss = compute_lang_classification_loss(
        outputs["lang_scores"], batch["object_cat_list"], batch["lang_num"])
    m["lang_loss"] = lang_loss
    loss = loss + cfg_l.lang_weight * lang_loss
    if cfg_l.use_attr_loss:
        attr = compute_attr_loss(
            outputs["vote_xyz"], outputs["seed_inds"],
            batch["instance_labels"], batch["vote_label_mask"])
        m["attr_loss"] = attr
        loss = loss + cfg_l.attr_weight * attr

    if cfg_m.use_con:
        con = (cfg_l.lang_con_weight * outputs["lang_con_loss"]
               + cfg_l.iou_con_weight * outputs["iou_con_loss"])
        m["lang_con_loss"] = outputs["lang_con_loss"]
        m["iou_con_loss"] = outputs["iou_con_loss"]
        m["con_loss"] = con
        loss = loss + con  # the epoch >= 50 gate is inside ContrastModule

    if cfg_m.use_mlm and "lang_mlm" in outputs:
        good = outputs.get("good_bbox_masks")
        if good is None:  # no caption branch: every slot counts
            good = torch.ones(outputs["lang_mlm"].shape[0], dtype=torch.bool,
                              device=dev)
        mlm = compute_mlm_loss(outputs["lang_mlm"], batch["input_ids"],
                               outputs["mlm_mask_index"], good)
        m["mlm_loss"] = mlm
        loss = loss + cfg_l.mlm_weight * mlm

    if cfg_m.use_answer and "answer_scores" in outputs:
        n_rows = outputs["answer_scores"].shape[0]

        def rows(x):
            if x is None or x.dim() < 2 or x.shape[0] == n_rows:
                return x
            return x.reshape(n_rows, *x.shape[2:])

        ans = compute_answer_classification_loss(
            outputs["answer_scores"], rows(batch.get("answer_cat_scores")),
            rows(batch.get("answer_cat")))
        m["answer_loss"] = ans
        loss = loss + ans

    if caption and "lang_cap" in outputs:
        cap_loss, cap_acc = compute_cap_loss(
            outputs["lang_cap"], batch["input_ids"],
            outputs["good_bbox_masks"])
        m["cap_loss"] = cap_loss
        m["cap_acc"] = cap_acc
        loss = loss + cap_loss

    m["loss"] = loss
    return loss, m
