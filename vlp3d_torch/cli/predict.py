"""Grounding prediction dump: the benchmark's pred.json.

The port's counterpart of ``vlp3d/cli/predict.py`` (after
``scripts/joint_scripts/train_3dvlp.py predict()`` :423-538 and
benchmark/predict.py's output contract): one record an annotation,
``{scene_id, object_id, ann_id, bbox (8x3 corners), unique_multiple,
others}``.

    python -m vlp3d_torch.cli.predict --model_dir RUN --out pred.json \\
        --use_multiview --use_normal --no_caption --use_con ...
    python -m vlp3d_torch.cli.predict --synthetic --smoke --no_caption \\
        --device cpu

Weights come from ``--model_dir`` (a :func:`~vlp3d_torch.train.checkpoint.
save_params` snapshot, ``<model_dir>/model.pth``), else the model's
seeded initialisation. The chosen proposal of a sentence is
GroundingPredictor's: the argmax of ``cluster_ref * argmax(objectness)``
(eval_ground.py:100-120), so a masked proposal wins when every unmasked
confidence is negative, as in the reference.
"""

from __future__ import annotations

import argparse
import json

import torch

from vlp3d_torch.cli.common import (
    add_common_args,
    build_val_dataset,
    resolve_config,
)
from vlp3d_torch.data.dataset import BatchIterator
from vlp3d_torch.eval.box_iou import get_3d_box
from vlp3d_torch.serving import GroundingPredictor, ground, to_device
from vlp3d_torch.train.checkpoint import load_params


def predict_batch(model, batch: dict, device) -> dict:
    """One host batch through the model on ``device`` -> host arrays:
    ``chosen`` (B, L) proposal of each sentence slot and, at it,
    ``pred_size`` (B, L, 3), ``pred_heading`` (B, L), ``pred_center``
    (B, L, 3)."""
    out = ground(model, to_device(batch, device))
    chosen = out["pred_ref"]
    rows = torch.arange(chosen.shape[0], device=chosen.device)[:, None]
    picked = {"chosen": chosen}
    for key in ("pred_size", "pred_heading", "pred_center"):
        picked[key] = out[key][rows, chosen]
    return {k: v.cpu().numpy() for k, v in picked.items()}


def predict_records(model, loader, device) -> list:
    """pred.json records of every annotation the loader's batches hold."""
    records = []
    for batch in loader:
        got = predict_batch(model, batch, device)
        for i in range(len(batch["scene_id"])):
            for j in range(int(batch["lang_num"][i])):
                bbox = get_3d_box(got["pred_size"][i, j],
                                  float(got["pred_heading"][i, j]),
                                  got["pred_center"][i, j])
                records.append({
                    "scene_id": batch["scene_id"][i],
                    "object_id": int(batch["object_id_list"][i, j]),
                    "ann_id": int(batch["ann_id_list"][i, j]),
                    "bbox": bbox.tolist(),
                    "unique_multiple": int(
                        batch["unique_multiple_list"][i, j]),
                    "others": 1 if int(batch["object_cat_list"][i, j]) == 17
                    else 0,
                })
    return records


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--model_name", type=str, default="model")
    p.add_argument("--out", type=str, default="pred.json")
    args = p.parse_args(argv)

    config = resolve_config(args)
    val_ds = build_val_dataset(args, config)
    predictor = GroundingPredictor(
        config, load_params(args.model_dir, args.model_name)
        if args.model_dir else None, device=args.device)
    loader = BatchIterator(val_ds, config.train.batch_size, drop_last=False,
                           num_workers=config.train.num_workers)
    preds = predict_records(predictor.model, loader, predictor.device)
    with open(args.out, "w") as f:
        json.dump(preds, f)
    print(f"dumped {len(preds)} predictions to {args.out}")
    return preds


if __name__ == "__main__":
    main()
