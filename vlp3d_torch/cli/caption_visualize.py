"""Caption visualizer.

The port's counterpart of ``vlp3d/cli/caption_visualize.py``, after
`scripts/joint_scripts/caption_visualize.py:293-420`'s dump contract: a
directory a scene holding
  * pc.ply — the input point cloud,
  * pred-{proposal}-class{cls}.ply — each proposal kept by the
    post-processing (3D class-aware NMS at IoU 0.25) whose objectness
    argmax is 1, in its class's colour,
  * captions.json — {proposal: {object_name, description}}, the greedy
    caption of each kept proposal.
The model carries the caption decoder whatever ``--no_caption`` says.

    python -m vlp3d_torch.cli.caption_visualize --synthetic --smoke \\
        --device cpu --out_dir vis

Weights come from ``--model_dir``, else the seeded initialisation.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vlp3d_torch.cli.visualize_common import (
    parse_visualizer_args,
    visualizer_setup,
)
from vlp3d_torch.data.tokenizer import load_tokenizer
from vlp3d_torch.eval.box_iou import get_3d_box
from vlp3d_torch.eval.captioning import decode_caption
from vlp3d_torch.eval.detection import parse_predictions
from vlp3d_torch.serving import CaptionPredictor, to_device
from vlp3d_torch.utils.visualize import write_ply_box_heatmap, write_ply_points

# caption_visualize.py:85-93
POST = {
    "remove_empty_box": False,
    "use_3d_nms": True,
    "nms_iou": 0.25,
    "use_old_type_nms": False,
    "cls_nms": True,
    "per_class_proposal": False,
    "conf_thresh": 0.05,
}


def class_color(cls: int) -> tuple:
    """The wireframe colour of semantic class ``cls``."""
    return tuple(int(v) for v in np.random.default_rng(cls)
                 .integers(64, 255, 3))


def main(argv=None):
    args = parse_visualizer_args(argv, "vis", 4)
    args.no_caption = False  # this entry point exists to decode captions
    _, predictor, loader = visualizer_setup(args, CaptionPredictor)
    tokenizer = load_tokenizer(None if args.synthetic
                               else args.bert_vocab or None)

    n_dumped = 0
    for batch in loader:
        out = predictor._to_host(predictor.predict(
            to_device(batch, predictor.device)))
        ys = out["caption_ids"]  # (B, K, max_des_len + 2)
        pred_masks, _ = parse_predictions(out, POST)
        keep = pred_masks * np.argmax(out["objectness_scores"], -1)
        sem_cls = np.argmax(out["sem_cls_scores"], -1)
        b, k = keep.shape
        for i in range(b):
            if n_dumped >= args.max_scenes:
                break
            sdir = os.path.join(args.out_dir, batch["scene_id"][i])
            os.makedirs(sdir, exist_ok=True)
            write_ply_points(os.path.join(sdir, "pc.ply"),
                             np.asarray(batch["point_clouds"][i])[:, :3])
            candidates = {}
            for pi in range(k):
                if keep[i, pi] != 1:
                    continue
                cls = int(sem_cls[i, pi])
                candidates[str(pi)] = {
                    "object_name": f"class{cls}",
                    "description": decode_caption(tokenizer, ys[i, pi]),
                }
                corners = get_3d_box(out["pred_size"][i, pi],
                                     float(out["pred_heading"][i, pi]),
                                     out["pred_center"][i, pi])
                write_ply_box_heatmap(
                    os.path.join(sdir, f"pred-{pi}-class{cls}.ply"),
                    corners[None], np.ones((1,)), color=class_color(cls),
                    gain=1.0)
            with open(os.path.join(sdir, "captions.json"), "w") as f:
                json.dump(candidates, f, indent=2)
            n_dumped += 1
        if n_dumped >= args.max_scenes:
            break
    print(f"caption visualizations for {n_dumped} scenes -> {args.out_dir}")
    return n_dumped


if __name__ == "__main__":
    main()
