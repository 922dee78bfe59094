"""Detection post-processing + mAP: NMS, parse_predictions, APCalculator.

The port's own copy of ``vlp3d/eval/detection.py`` (numpy only).

Host-side numpy ports of `lib/ap_helper/ap_helper_fcos.py:41-290`,
`utils/nms.py:10-245`, and `utils/eval_det.py:21-253`. The canonical
post-processing config is the solver's POST_DICT (solver_3dvlp.py:149-158):
remove_empty_box, 3D class-aware NMS at IoU 0.25, per-class proposals,
conf_thresh 0.05.

Point-in-box uses the corner AABB (the reference's in_hull Delaunay test is
equivalent for ScanNet's axis-aligned boxes; predicted headings are ~0).
"""

from __future__ import annotations

import numpy as np

from vlp3d_torch.eval.box_iou import box3d_iou, get_3d_box


def softmax_np(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def nms_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """Greedy class-aware 3D NMS (utils/nms.py:113-155). boxes: (N, 8) =
    [x1 y1 z1 x2 y2 z2 score cls]."""
    x1, y1, z1 = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    x2, y2, z2 = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    score, cls = boxes[:, 6], boxes[:, 7]
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)

    order = np.argsort(score)
    pick = []
    while order.size != 0:
        last = order.size
        i = order[-1]
        pick.append(int(i))
        rest = order[: last - 1]
        l = np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        w = np.maximum(0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        h = np.maximum(0, np.minimum(z2[i], z2[rest]) - np.maximum(z1[i], z1[rest]))
        inter = l * w * h
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        o = o * (cls[i] == cls[rest])
        order = np.delete(
            order,
            np.concatenate(([last - 1], np.where(o > overlap_threshold)[0])),
        )
    return pick


def nms_2d_faster(boxes, overlap_threshold, old_type=False):
    """BEV 2D greedy NMS (utils/nms.py:41-73): boxes (K, 5) =
    [x1, y1, x2, y2, score]; the reference's use_3d_nms=False path
    (ap_helper_fcos.py:115-132)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    score = boxes[:, 4]
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(score)
    pick = []
    while order.size:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        w = np.maximum(
            0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest])
        )
        h = np.maximum(
            0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest])
        )
        inter = w * h
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = rest[o <= overlap_threshold]
    return pick


def nms_3d_faster(boxes, overlap_threshold, old_type=False):
    """Class-agnostic variant (utils/nms.py:70-110)."""
    b = np.concatenate([boxes[:, :7], np.zeros((len(boxes), 1))], axis=1)
    return nms_3d_faster_samecls(b, overlap_threshold, old_type)


DEFAULT_POST_DICT = {
    "remove_empty_box": True,
    "use_3d_nms": True,
    "nms_iou": 0.25,
    "use_old_type_nms": False,
    "cls_nms": True,
    "per_class_proposal": True,
    "conf_thresh": 0.05,
}


def parse_predictions_classform(
    outputs: dict,
    config: dict,
    mean_size_arr: np.ndarray,
    num_heading_bin: int = 1,
    num_class: int = 18,
):
    """VoteNet/ScanQA-style class-form predictions -> NMS'd proposal lists.

    The ap_helper_votenet/ap_helper_vqa variant
    (lib/ap_helper/ap_helper_vqa.py:39-77): heading = argmax class bin's
    angle + its residual (class2angle — identically 0 on ScanNet with one
    bin, model_util_scannet.py:133-143), size = mean_size_arr[argmax size
    class] + its residual; the decoded boxes then go through the shared
    parse_predictions NMS path.

    outputs needs: center, heading_scores (B,K,NH), heading_residuals,
    size_scores (B,K,NS), size_residuals (B,K,NS,3), objectness_scores,
    sem_cls_scores, point_clouds (via config batch).
    """
    heading_scores = np.asarray(outputs["heading_scores"])
    heading_residuals = np.asarray(outputs["heading_residuals"])
    size_scores = np.asarray(outputs["size_scores"])
    size_residuals = np.asarray(outputs["size_residuals"])
    hcls = np.argmax(heading_scores, -1)
    hres = np.take_along_axis(heading_residuals, hcls[..., None], -1)[..., 0]
    angle = hcls * (2 * np.pi / num_heading_bin) + hres
    angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
    scls = np.argmax(size_scores, -1)
    sres = np.take_along_axis(
        size_residuals, scls[..., None, None], -2
    )[..., 0, :]
    size = mean_size_arr[scls] + sres
    decoded = {
        **outputs,
        "pred_center": np.asarray(outputs["center"]),
        "pred_size": size,
        "pred_heading": angle,
    }
    return parse_predictions(decoded, config, num_class=num_class)


def parse_predictions(outputs: dict, config: dict, num_class: int = 18,
                      nms_soft_sem_score: bool = True):
    """outputs: numpy dict with pred_center/pred_size/pred_heading,
    objectness_scores, sem_cls_scores, point_clouds.

    Returns (pred_mask (B, K), batch_pred_map_cls list).
    """
    cfg = {**DEFAULT_POST_DICT, **config}
    pred_center = np.asarray(outputs["pred_center"])
    pred_size = np.asarray(outputs["pred_size"])
    pred_heading = np.asarray(outputs["pred_heading"])
    b, k = pred_center.shape[:2]

    corners = np.zeros((b, k, 8, 3))
    for i in range(b):
        for j in range(k):
            corners[i, j] = get_3d_box(
                pred_size[i, j], float(pred_heading[i, j]), pred_center[i, j]
            )

    nonempty = np.ones((b, k), bool)
    if cfg["remove_empty_box"]:
        pc = np.asarray(outputs["point_clouds"])[:, :, :3]
        for i in range(b):
            for j in range(k):
                cmin = corners[i, j].min(0)
                cmax = corners[i, j].max(0)
                if (cmax - cmin).max() <= 1e-4:
                    nonempty[i, j] = False
                    continue
                inside = np.all(
                    (pc[i] >= cmin) & (pc[i] <= cmax), axis=1
                )
                if inside.sum() < 5:
                    nonempty[i, j] = False

    obj_prob = softmax_np(np.asarray(outputs["objectness_scores"]))[:, :, 1]
    sem_probs = softmax_np(np.asarray(outputs["sem_cls_scores"]))
    sem_cls = np.argmax(sem_probs, axis=-1)
    sem_prob_max = sem_probs.max(-1)

    pred_mask = np.zeros((b, k))
    for i in range(b):
        idxs = np.where(nonempty[i])[0]
        if len(idxs) == 0:
            continue
        if not cfg["use_3d_nms"]:
            # BEV 2D NMS on xy footprints (ap_helper_fcos.py:115-132)
            boxes = np.zeros((k, 5))
            boxes[:, 0:2] = corners[i].min(1)[:, 0:2]
            boxes[:, 2:4] = corners[i].max(1)[:, 0:2]
            boxes[:, 4] = obj_prob[i]
            pick = nms_2d_faster(
                boxes[idxs], cfg["nms_iou"], cfg["use_old_type_nms"]
            )
            pred_mask[i, idxs[pick]] = 1
            continue
        boxes = np.zeros((k, 8))
        boxes[:, 0:3] = corners[i].min(1)
        boxes[:, 3:6] = corners[i].max(1)
        if cfg["cls_nms"]:
            boxes[:, 6] = (
                obj_prob[i] * sem_prob_max[i]
                if nms_soft_sem_score
                else obj_prob[i]
            )
            boxes[:, 7] = sem_cls[i]
            nms_fn = nms_3d_faster_samecls
        else:
            boxes[:, 6] = obj_prob[i]
            nms_fn = nms_3d_faster
        pick = nms_fn(
            boxes[idxs], cfg["nms_iou"], cfg["use_old_type_nms"]
        )
        pred_mask[i, idxs[pick]] = 1

    batch_pred_map_cls = []
    for i in range(b):
        if cfg["per_class_proposal"]:
            cur = []
            for c in range(num_class):
                cur += [
                    (c, corners[i, j], sem_probs[i, j, c] * obj_prob[i, j])
                    for j in range(k)
                    if pred_mask[i, j] == 1
                    and obj_prob[i, j] > cfg["conf_thresh"]
                ]
            batch_pred_map_cls.append(cur)
        else:
            batch_pred_map_cls.append(
                [
                    (int(sem_cls[i, j]), corners[i, j], obj_prob[i, j])
                    for j in range(k)
                    if pred_mask[i, j] == 1
                    and obj_prob[i, j] > cfg["conf_thresh"]
                ]
            )
    return pred_mask, batch_pred_map_cls


def parse_groundtruths(batch: dict, mean_size_arr: np.ndarray):
    """GT (sem_cls, corners) lists (ap_helper_fcos.py:193-236)."""
    center = np.asarray(batch["center_label"])[..., :3]
    size_cls = np.asarray(batch["size_class_label"])
    size_res = np.asarray(batch["size_residual_label"])
    mask = np.asarray(batch["box_label_mask"])
    sem = np.asarray(batch["sem_cls_label"])
    b, k2 = center.shape[:2]
    out = []
    for i in range(b):
        cur = []
        for j in range(k2):
            if mask[i, j] == 0:
                continue
            size = mean_size_arr[int(size_cls[i, j])] + size_res[i, j]
            cur.append((int(sem[i, j]), get_3d_box(size, 0.0, center[i, j])))
        out.append(cur)
    return out


def voc_ap(rec, prec):
    """Continuous-interpolation VOC AP (eval_det.py:36-52)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred, gt, ovthresh=0.25):
    """Single-class PR/AP (eval_det.py:74-170): greedy TP matching on
    confidence-sorted detections; strict > threshold."""
    class_recs = {}
    npos = 0
    for img_id in gt:
        bbox = np.array(gt[img_id])
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
        npos += len(bbox)
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, bb_list = [], [], []
    for img_id in pred:
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            bb_list.append(box)
    if not image_ids:
        return np.zeros(0), np.zeros(0), 0.0
    confidence = np.array(confidence)
    order = np.argsort(-confidence)
    image_ids = [image_ids[x] for x in order]
    bb_list = [bb_list[x] for x in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        r = class_recs[image_ids[d]]
        bb = bb_list[d]
        ovmax, jmax = -np.inf, -1
        for j in range(len(r["bbox"])):
            iou = box3d_iou(bb, r["bbox"][j])
            if iou > ovmax:
                ovmax, jmax = iou, j
        if ovmax > ovthresh and not r["det"][jmax]:
            tp[d] = 1.0
            r["det"][jmax] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos + 1e-8)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec)


class APCalculator:
    """Accumulates (pred, gt) lists across batches -> per-class AP + mAP
    (ap_helper_fcos.py:238-290)."""

    def __init__(self, ap_iou_thresh=0.25, class2type=None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type = class2type or {}
        self.reset()

    def reset(self):
        self.gt_map = {}
        self.pred_map = {}
        self.scan_cnt = 0

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        for pred_list, gt_list in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.pred_map[self.scan_cnt] = pred_list
            self.gt_map[self.scan_cnt] = gt_list
            self.scan_cnt += 1

    def compute_metrics(self):
        pred_by_cls: dict = {}
        gt_by_cls: dict = {}
        for img_id, dets in self.pred_map.items():
            for cls, box, score in dets:
                pred_by_cls.setdefault(cls, {}).setdefault(img_id, []).append(
                    (box, score)
                )
        for img_id, gts in self.gt_map.items():
            for cls, box in gts:
                gt_by_cls.setdefault(cls, {}).setdefault(img_id, []).append(
                    box
                )
        out = {}
        aps = []
        recalls = []
        # the reference's eval_det (utils/eval_det.py:165-188) seeds an
        # empty gt entry for EVERY predicted class, so prediction-only
        # classes are evaluated too (AP 0) and count toward the mAP mean
        # — with per-class proposals that is all num_class classes
        for cls in sorted(set(gt_by_cls) | set(pred_by_cls)):
            rec, _, ap = eval_det_cls(
                pred_by_cls.get(cls, {}), gt_by_cls.get(cls, {}),
                self.ap_iou_thresh
            )
            name = self.class2type.get(cls, str(cls))
            out[f"{name} Average Precision"] = ap
            out[f"{name} Recall"] = float(rec[-1]) if rec.size else 0.0
            aps.append(ap)
            recalls.append(float(rec[-1]) if rec.size else 0.0)
        out["mAP"] = float(np.mean(aps)) if aps else 0.0
        out["AR"] = float(np.mean(recalls)) if recalls else 0.0
        return out
