"""Dense-captioning prediction dump: the Scan2Cap benchmark's pred.json.

The port's counterpart of ``vlp3d/cli/caption_predict.py`` (after
scripts/joint_scripts/caption_predict.py:162-250): a greedy caption for
every proposal, kept where the proposal survives the POST_DICT
post-processing (3D class-aware NMS at IoU 0.25, conf 0.05;
:176-184) and its objectness argmax is 1, dumped as scene_id ->
[{caption, box (8x3 corners), sem_prob, obj_prob}].

    python -m vlp3d_torch.cli.caption_predict --model_dir RUN \\
        --use_multiview --use_normal --out pred.json
    python -m vlp3d_torch.cli.caption_predict --synthetic --smoke \\
        --device cpu

Weights come from ``--model_dir`` (``<model_dir>/model.pth``, a
:func:`~vlp3d_torch.train.checkpoint.save_params` snapshot), else the
model's seeded initialisation.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from vlp3d_torch.cli.common import (
    add_common_args,
    build_val_dataset,
    resolve_config,
)
from vlp3d_torch.data.dataset import BatchIterator
from vlp3d_torch.data.tokenizer import load_tokenizer
from vlp3d_torch.eval.box_iou import get_3d_box
from vlp3d_torch.eval.captioning import decode_caption
from vlp3d_torch.eval.detection import parse_predictions, softmax_np
from vlp3d_torch.serving import CaptionPredictor, to_device
from vlp3d_torch.train.checkpoint import load_params

# POST_DICT of caption_predict.py:176-184
POST_DICT = {
    "remove_empty_box": True,
    "use_3d_nms": True,
    "nms_iou": 0.25,
    "use_old_type_nms": False,
    "cls_nms": True,
    "per_class_proposal": True,
    "conf_thresh": 0.05,
}


def scene_captions(out: dict, point_clouds, scene_ids, tokenizer) -> dict:
    """One batch's host predictions (CaptionPredictor's) -> scene_id ->
    the kept proposals' records."""
    pred_mask, _ = parse_predictions({**out, "point_clouds": point_clouds},
                                     POST_DICT)
    keep = (np.asarray(pred_mask)
            * np.argmax(out["objectness_scores"], -1)).astype(bool)
    sem_prob = softmax_np(out["sem_cls_scores"])
    obj_prob = softmax_np(out["objectness_scores"])
    scenes = {}
    for i, scene_id in enumerate(scene_ids):
        scenes[scene_id] = [
            {
                "caption": decode_caption(tokenizer, out["caption_ids"][i, j]),
                "box": get_3d_box(out["pred_size"][i, j],
                                  float(out["pred_heading"][i, j]),
                                  out["pred_center"][i, j]).tolist(),
                "sem_prob": sem_prob[i, j].tolist(),
                "obj_prob": obj_prob[i, j].tolist(),
            }
            for j in range(keep.shape[1]) if keep[i, j]
        ]
    return scenes


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--out", type=str, default="pred.json")
    args = p.parse_args(argv)
    args.no_caption = False  # this entry point exists to decode captions

    config = resolve_config(args)
    val_ds = build_val_dataset(args, config)
    tokenizer = load_tokenizer(args.bert_vocab or None)
    predictor = CaptionPredictor(
        config, load_params(args.model_dir, "model") if args.model_dir
        else None, device=args.device)
    outputs: dict = {}
    loader = BatchIterator(val_ds, config.train.batch_size, drop_last=False,
                           num_workers=config.train.num_workers)
    for batch in loader:
        out = predictor._to_host(predictor.predict(
            to_device(batch, predictor.device)))
        outputs.update(scene_captions(out, batch["point_clouds"],
                                      batch["scene_id"], tokenizer))
    with open(args.out, "w") as f:
        json.dump(outputs, f, indent=4)
    print(f"dumped captions for {len(outputs)} scenes to {args.out}")
    return outputs


if __name__ == "__main__":
    main()
