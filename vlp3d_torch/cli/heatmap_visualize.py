"""Attention-heatmap visualizer.

The port's counterpart of ``vlp3d/cli/heatmap_visualize.py``, after
`scripts/joint_scripts/heatmap_visualize.py`: grounding inference over
the val scenes and, a directory ``<scene>_<sentence>`` a sentence,
  * scene_scene.ply — the scene's point cloud,
  * scene_pred.obj  — the chosen proposal's box,
  * 0_<map>.ply     — the chosen proposal's relation attention over all
    the proposal boxes, one map a (layer, head)
    (heatmap_visualize.py:433-462 -> save_bbox_heatmap).
The chosen proposal is the objectness-masked
``argmax(cluster_ref * argmax(objectness))``.

    python -m vlp3d_torch.cli.heatmap_visualize --synthetic --smoke \\
        --device cpu --out_dir hm

Weights come from ``--model_dir``, else the seeded initialisation.
"""

from __future__ import annotations

import os

import numpy as np

from vlp3d_torch.cli.visualize_common import (
    forward_host,
    parse_visualizer_args,
    visualizer_setup,
)
from vlp3d_torch.eval.box_iou import get_3d_box
from vlp3d_torch.utils.visualize import dump_scene, save_bbox_heatmap

KEYS = ("cluster_ref", "objectness_scores", "pred_center", "pred_size",
        "pred_heading", "relation_attn")


def main(argv=None):
    args = parse_visualizer_args(argv, "heatmap_result", 4)
    _, predictor, loader = visualizer_setup(args)

    n_dumped = 0
    for batch in loader:
        out = forward_host(predictor, batch, KEYS)
        b, l = batch["input_ids"].shape[:2]
        k = out["pred_center"].shape[1]
        masks = np.argmax(out["objectness_scores"], -1)
        conf = out["cluster_ref"].reshape(b, l, k)
        chosen = np.argmax(conf * masks[:, None, :], axis=-1)
        for i in range(b):
            if n_dumped >= args.max_scenes:
                break
            scene = batch["scene_id"][i]
            corners = np.stack([
                get_3d_box(out["pred_size"][i, pi],
                           float(out["pred_heading"][i, pi]),
                           out["pred_center"][i, pi])
                for pi in range(k)])  # (K, 8, 3)
            for j in range(int(batch["lang_num"][i])):
                pi = int(chosen[i, j])
                base = os.path.join(args.out_dir, f"{scene}_{j}")
                os.makedirs(base, exist_ok=True)
                dump_scene(os.path.join(base, "scene"),
                           batch["point_clouds"][i],
                           pred_corners=corners[pi:pi + 1])
                # the chosen proposal's attention over all proposals, one
                # map a (layer, head)
                attn = out["relation_attn"][i, :, pi, :]  # (maps, K)
                save_bbox_heatmap(base, corners, attn[None, :, :])
            n_dumped += 1
        if n_dumped >= args.max_scenes:
            break
    print(f"heatmaps for {n_dumped} scenes -> {args.out_dir}")
    return n_dumped


if __name__ == "__main__":
    main()
