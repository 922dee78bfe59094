"""Scene and box dumps for viewers: point clouds as ASCII PLY, boxes as
OBJ wireframes or coloured-vertex PLY, attention heatmaps over the
proposal boxes, and detection results.

The port's own copy of ``vlp3d/utils/visualize.py`` (after the
reference's visualizer scripts, scripts/joint_scripts/{ground,caption,
heatmap}_visualize.py, and models/mlcvnet/dump_helper.py). For the same
inputs each writer gives the bytes the JAX package's writes.
"""

from __future__ import annotations

import os

import numpy as np

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_ply_points(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """xyz (N, 3) float; rgb (N, 3) uint8 optional -> ascii PLY."""
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{xyz[i,0]:.4f} {xyz[i,1]:.4f} {xyz[i,2]:.4f}"
            if rgb is not None:
                row += f" {int(rgb[i,0])} {int(rgb[i,1])} {int(rgb[i,2])}"
            f.write(row + "\n")


def write_obj_boxes(path: str, corners: np.ndarray):
    """corners (K, 8, 3) -> OBJ wireframe (12 edges per box)."""
    with open(path, "w") as f:
        for box in corners:
            for v in box:
                f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for bi in range(len(corners)):
            off = bi * 8
            for a, b in _BOX_EDGES:
                f.write(f"l {off + a + 1} {off + b + 1}\n")


def write_ply_box_heatmap(path: str, corners: np.ndarray, weights: np.ndarray,
                          color=(255, 0, 0), gain: float = 5.0):
    """All K boxes as coloured wireframe vertices in one PLY, each box's
    intensity its weight times ``gain``, clipped at 1 (the reference's
    p = min(1, heatmap * 5), core_vision_utils.py:72-78).

    corners (K, 8, 3); weights (K,). The reference writes an OBJ
    wireframe a box; one PLY a map carries the colour a vertex, which OBJ
    cannot.
    """
    k = len(corners)
    w = np.clip(np.asarray(weights, np.float32) * gain, 0.0, 1.0)
    verts, cols, edges = [], [], []
    for i in range(k):
        off = len(verts)
        verts.extend(np.asarray(corners[i]).tolist())
        cols.extend([[int(c * w[i]) for c in color]] * 8)
        edges.extend([(off + a, off + b) for a, b in _BOX_EDGES])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for v, c in zip(verts, cols):
            f.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")


def save_bbox_heatmap(out_dir: str, corners: np.ndarray, heatmap: np.ndarray,
                      head: int | None = None):
    """One heatmap PLY an (object, head) over all proposal boxes
    (scripts/core_vision_utils.py:57-79, heatmap_visualize.py:460-462).

    corners (K, 8, 3); heatmap (n_obj, n_heads, K), each object query's
    attention over the K proposals. Writes ``<obj>_<head>.ply``.
    """
    os.makedirs(out_dir, exist_ok=True)
    hm = np.asarray(heatmap)
    heads = range(hm.shape[1]) if head is None else [head]
    for oi in range(hm.shape[0]):
        for hi in heads:
            write_ply_box_heatmap(
                os.path.join(out_dir, f"{oi}_{hi}.ply"), corners, hm[oi, hi]
            )


def dump_scene(
    out_prefix: str,
    point_cloud: np.ndarray,  # (N, >=3)
    pred_corners: np.ndarray | None = None,  # (K, 8, 3)
    gt_corners: np.ndarray | None = None,
    pcl_color: np.ndarray | None = None,  # (N, 3) 0-255
):
    """``<prefix>_scene.ply`` and, where given and not empty,
    ``<prefix>_pred.obj`` / ``<prefix>_gt.obj``."""
    write_ply_points(
        out_prefix + "_scene.ply",
        np.asarray(point_cloud)[:, :3],
        None if pcl_color is None else np.asarray(pcl_color).astype(np.uint8),
    )
    if pred_corners is not None and len(pred_corners):
        write_obj_boxes(out_prefix + "_pred.obj", np.asarray(pred_corners))
    if gt_corners is not None and len(gt_corners):
        write_obj_boxes(out_prefix + "_gt.obj", np.asarray(gt_corners))


def dump_detection_results(
    outputs: dict,
    batch: dict,
    dump_dir: str,
    *,
    pred_mask: np.ndarray | None = None,
    conf_thresh: float = 0.5,
    inference: bool = False,
):
    """Detection dumps (models/mlcvnet/dump_helper.py): a sample's
    confident (and ``pred_mask``-kept) boxes, one OBJ a semantic class;
    unless ``inference``, the GT centroids and the positive proposals'
    centres as PLY point clouds.

    outputs: host arrays ``pred_center`` / ``pred_size`` /
    ``pred_heading``, ``objectness_scores``, ``sem_cls_scores`` (and
    optionally ``objectness_label``); batch: ``center_label`` and
    ``box_label_mask``.
    """
    from vlp3d_torch.eval.box_iou import get_3d_box

    os.makedirs(dump_dir, exist_ok=True)
    center = np.asarray(outputs["pred_center"])
    size = np.asarray(outputs["pred_size"])
    heading = np.asarray(outputs["pred_heading"])
    obj = np.asarray(outputs["objectness_scores"])
    obj_prob = np.exp(obj - obj.max(-1, keepdims=True))
    obj_prob = (obj_prob / obj_prob.sum(-1, keepdims=True))[..., 1]
    sem_cls = np.argmax(np.asarray(outputs["sem_cls_scores"]), -1)
    b, k = center.shape[:2]
    if pred_mask is None:
        pred_mask = np.ones((b, k))

    for i in range(b):
        keep = (obj_prob[i] > conf_thresh) & (pred_mask[i] == 1)
        for cls in np.unique(sem_cls[i][keep]) if keep.any() else []:
            sel = keep & (sem_cls[i] == cls)
            corners = np.stack(
                [
                    get_3d_box(size[i, j], float(heading[i, j]), center[i, j])
                    for j in np.where(sel)[0]
                ]
            )
            write_obj_boxes(
                os.path.join(
                    dump_dir, f"{i:06d}_pred_confident_nms_bbox_{int(cls)}.obj"
                ),
                corners,
            )
    if inference:
        return

    gt_center = np.asarray(batch["center_label"])[..., :3]
    gt_mask = np.asarray(batch["box_label_mask"])
    for i in range(b):
        if "objectness_label" in outputs:
            lab = np.asarray(outputs["objectness_label"])[i] > 0
            if lab.any():
                write_ply_points(
                    os.path.join(
                        dump_dir, f"{i:06d}_gt_positive_proposal_pc.ply"
                    ),
                    center[i][lab],
                )
        write_ply_points(
            os.path.join(dump_dir, f"{i:06d}_gt_centroid_pc.ply"),
            gt_center[i][gt_mask[i] > 0],
        )
