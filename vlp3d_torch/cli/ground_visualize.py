"""Grounding visualizer.

The port's counterpart of ``vlp3d/cli/ground_visualize.py``, after
`scripts/joint_scripts/ground_visualize.py:354-460`'s dump contract: a
directory a scene holding
  * pc.ply                                   — the input point cloud
                                               (written if absent),
  * gt_{object_id}_{object_name}.ply         — the GT reference box,
  * pred_{object_id}_{object_name}_{ann_id}_{score:.5f}_{iou:.5f}.ply
                                             — the chosen proposal box,
box wireframes as coloured-vertex PLY (GT green, pred blue). The chosen
proposal of a sentence is the unmasked ``argmax(cluster_ref)``
(ground_visualize.py:429), not the objectness-masked choice that
``predict`` and the server make; its score is the softmax of the
sentence's confidences there.

    python -m vlp3d_torch.cli.ground_visualize --model_dir RUN \\
        --use_multiview --use_normal --no_caption --out_dir vis
    python -m vlp3d_torch.cli.ground_visualize --synthetic --smoke \\
        --device cpu --out_dir vis

Weights come from ``--model_dir`` (``<model_dir>/<model_name>.pth``),
else the model's seeded initialisation. Only the val split is read.
"""

from __future__ import annotations

import os

import numpy as np

from vlp3d_torch.cli.visualize_common import (
    forward_host,
    parse_visualizer_args,
    visualizer_setup,
)
from vlp3d_torch.eval.box_iou import box3d_iou, get_3d_box
from vlp3d_torch.eval.detection import softmax_np
from vlp3d_torch.utils.visualize import write_ply_box_heatmap, write_ply_points

KEYS = ("cluster_ref", "objectness_scores", "pred_center", "pred_size",
        "pred_heading")


def main(argv=None):
    args = parse_visualizer_args(argv, "vis", 8)
    config, predictor, loader = visualizer_setup(args)
    mean_size = config.dataset.mean_size_arr()

    n_dumped = 0
    for batch in loader:
        out = forward_host(predictor, batch, KEYS)
        b, l = batch["input_ids"].shape[:2]
        k = out["pred_center"].shape[1]
        conf = out["cluster_ref"].reshape(b, l, k)
        conf_soft = softmax_np(conf)
        chosen = np.argmax(conf, axis=-1)  # ground_visualize.py:429
        for i in range(b):
            if n_dumped >= args.max_scenes:
                break
            scene = batch["scene_id"][i]
            sdir = os.path.join(args.out_dir, scene)
            os.makedirs(sdir, exist_ok=True)
            if not os.path.exists(os.path.join(sdir, "pc.ply")):
                write_ply_points(os.path.join(sdir, "pc.ply"),
                                 np.asarray(batch["point_clouds"][i])[:, :3])
            for j in range(int(batch["lang_num"][i])):
                oid = int(batch["object_id_list"][i, j])
                name = batch["object_name_list"][i][j] if isinstance(
                    batch.get("object_name_list"), list) else "object"
                ann = int(batch["ann_id_list"][i, j])
                gt_center = batch["ref_center_label_list"][i, j, :3]
                gt_size = (mean_size[batch["ref_size_class_label_list"][i, j]]
                           + batch["ref_size_residual_label_list"][i, j])
                gt_corners = get_3d_box(gt_size, 0.0, gt_center)
                write_ply_box_heatmap(
                    os.path.join(sdir, f"gt_{oid}_{name}.ply"),
                    gt_corners[None], np.ones((1,)), color=(0, 255, 0),
                    gain=1.0)
                pi = int(chosen[i, j])
                pred_corners = get_3d_box(out["pred_size"][i, pi],
                                          float(out["pred_heading"][i, pi]),
                                          out["pred_center"][i, pi])
                iou = box3d_iou(pred_corners, gt_corners)
                score = float(conf_soft[i, j, pi])
                write_ply_box_heatmap(
                    os.path.join(
                        sdir,
                        f"pred_{oid}_{name}_{ann}_{score:.5f}_{iou:.5f}.ply"),
                    pred_corners[None], np.ones((1,)), color=(0, 0, 255),
                    gain=1.0)
            n_dumped += 1
        if n_dumped >= args.max_scenes:
            break
    print(f"ground visualizations for {n_dumped} scenes -> {args.out_dir}")
    return n_dumped


if __name__ == "__main__":
    main()
