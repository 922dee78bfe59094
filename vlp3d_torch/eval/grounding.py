"""Grounding evaluation: per-sentence IoU, Acc@0.25/0.5, breakdowns.

The port's own copy of ``vlp3d/eval/grounding.py``.

Host-side numpy port of `lib/joint/eval_ground.py:48-245` plus the
unique/multiple x others aggregation of `final_eval_fn`
(utils/utils_fn.py:165-291).
"""

from __future__ import annotations

import numpy as np

from vlp3d_torch.eval.box_iou import box3d_iou, construct_bbox_corners, get_3d_box


def get_eval(
    outputs: dict,
    batch: dict,
    *,
    mean_size_arr: np.ndarray,
    use_lang_classifier: bool = True,
    cluster_labels: np.ndarray | None = None,
    objectness_label: np.ndarray | None = None,
    objectness_mask: np.ndarray | None = None,
    object_assignment: np.ndarray | None = None,
) -> dict:
    """outputs/batch as numpy arrays. Returns metric dict with per-sample
    lists (ref_iou, masks) for epoch-level aggregation."""
    o = {k: np.asarray(v) for k, v in outputs.items() if not isinstance(v, (list, dict))}
    b = {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, (list, dict))}

    objectness_pred = np.argmax(o["objectness_scores"], axis=2)
    pred_masks = (objectness_pred == 1).astype(np.float32)  # (B, K)

    batch_size, l = b["ref_center_label_list"].shape[:2]
    k = pred_masks.shape[1]

    # chosen proposal: argmax of confidence * objectness mask
    # (eval_ground.py:124-130)
    conf = o["cluster_ref"].reshape(batch_size, l, k)
    pred_ref = np.argmax(conf * pred_masks[:, None, :], axis=-1)  # (B, L)

    metrics: dict = {}

    # ref_acc: chosen-proposal one-hot vs training cluster labels
    if cluster_labels is not None:
        labels = np.asarray(cluster_labels).reshape(batch_size, l, k)
        onehot = np.zeros_like(labels)
        flat_ref = np.argmax(o["cluster_ref"], axis=1).reshape(batch_size, l)
        for i in range(batch_size):
            for j in range(l):
                onehot[i, j, flat_ref[i, j]] = 1
        corrects = ((onehot == 1) & (labels == 1)).sum(-1).astype(float)
        metrics["ref_acc"] = corrects.reshape(-1).tolist()

    gt_ref = np.argmax(b["ref_box_label_list"], axis=-1)  # (B, L)
    lang_num = b["lang_num"]

    ious, multiple, others, pred_bboxes, gt_bboxes = [], [], [], [], []
    for i in range(batch_size):
        for j in range(l):
            if j >= lang_num[i]:
                continue
            pi, gi = int(pred_ref[i, j]), int(gt_ref[i, j])
            pred_bbox = get_3d_box(
                o["pred_size"][i, pi],
                float(o["pred_heading"][i, pi]),
                o["pred_center"][i, pi],
            )
            gt_center = b["center_label"][i, gi]
            gt_size = (
                mean_size_arr[int(b["size_class_label"][i, gi])]
                + b["size_residual_label"][i, gi]
            )
            gt_bbox = get_3d_box(gt_size, 0.0, gt_center)
            ious.append(box3d_iou(pred_bbox, gt_bbox))
            pred_bboxes.append(
                construct_bbox_corners(
                    o["pred_center"][i, pi], o["pred_size"][i, pi]
                )
            )
            gt_bboxes.append(construct_bbox_corners(gt_center, gt_size))
            multiple.append(int(b["unique_multiple_list"][i, j]))
            others.append(1 if int(b["object_cat_list"][i, j]) == 17 else 0)

    ious_np = np.array(ious) if ious else np.zeros((0,))
    metrics["ref_iou"] = ious
    metrics["ref_iou_rate_0.25"] = float(
        (ious_np >= 0.25).sum() / max(len(ious), 1)
    )
    metrics["ref_iou_rate_0.5"] = float(
        (ious_np >= 0.5).sum() / max(len(ious), 1)
    )
    metrics["ref_multiple_mask"] = multiple
    metrics["ref_others_mask"] = others
    metrics["pred_bboxes"] = pred_bboxes
    metrics["gt_bboxes"] = gt_bboxes

    if use_lang_classifier and "lang_scores" in o:
        cats = b["object_cat_list"].reshape(-1)
        metrics["lang_acc"] = float(
            (np.argmax(o["lang_scores"], axis=1) == cats).mean()
        )
    else:
        metrics["lang_acc"] = 0.0

    if objectness_label is not None:
        ol = np.asarray(objectness_label)
        om = np.asarray(objectness_mask)
        metrics["obj_acc"] = float(
            ((objectness_pred == ol) * om).sum() / (om.sum() + 1e-6)
        )
        sem_label = np.take_along_axis(
            b["sem_cls_label"], np.asarray(object_assignment), axis=1
        )
        sem_pred = np.argmax(o["sem_cls_scores"], axis=-1)
        metrics["sem_acc"] = float(
            ((sem_label == sem_pred) * pred_masks).sum()
            / max(pred_masks.sum(), 1e-6)
        )
    return metrics


def final_eval_breakdown(ious, multiple_mask, others_mask) -> dict:
    """Overall / unique / multiple x w/ / w/o others Acc@0.25/0.5
    (utils/utils_fn.py:165-291's aggregation)."""
    ious = np.asarray(ious, np.float64)
    multiple = np.asarray(multiple_mask, bool)
    others = np.asarray(others_mask, bool)

    def acc(mask, thr):
        if mask.sum() == 0:
            return 0.0
        return float((ious[mask] >= thr).mean())

    out = {}
    everything = np.ones_like(multiple)
    for name, m in [
        ("overall", everything),
        ("unique", ~multiple),
        ("multiple", multiple),
    ]:
        for sub, sm in [
            ("", everything),
            ("_wo_others", ~others),
            ("_w_others", others),
        ]:
            mask = m & sm
            out[f"{name}{sub}_acc@0.25"] = acc(mask, 0.25)
            out[f"{name}{sub}_acc@0.5"] = acc(mask, 0.5)
            out[f"{name}{sub}_count"] = int(mask.sum())
    return out
