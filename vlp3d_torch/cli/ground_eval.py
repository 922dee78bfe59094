"""Grounding evaluation entry point (scripts/joint_scripts/ground_eval.py).

The port's counterpart of ``vlp3d/cli/ground_eval.py``: runs the val
split through the grounding model and reports Acc@0.25/0.5 with the
unique/multiple x others breakdown, the language classifier's accuracy
``lang_acc`` and, with ``--detection_map``, the detection mAP@0.25 / 0.5
through the AP calculator (:mod:`vlp3d_torch.eval.detection`).

    python -m vlp3d_torch.cli.ground_eval --model_dir RUN \\
        --use_multiview --use_normal --no_caption --use_con ...
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vlp3d_torch.cli.common import (
    add_common_args,
    build_val_dataset,
    resolve_config,
)
from vlp3d_torch.data.dataset import BatchIterator
from vlp3d_torch.eval.detection import (
    APCalculator,
    parse_groundtruths,
    parse_predictions,
)
from vlp3d_torch.eval.grounding import final_eval_breakdown, get_eval
from vlp3d_torch.serving import GroundingPredictor, to_device
from vlp3d_torch.train.checkpoint import load_params


def evaluate(model, loader, device, mean_size, *,
             detection_map: bool = False) -> dict:
    """Acc@0.25/0.5 breakdown and lang_acc (0 without the language
    classifier) over the loader's batches; with ``detection_map`` also
    mAP@0.25 and mAP@0.5."""
    keys = ("objectness_scores", "cluster_ref", "pred_center", "pred_size",
            "pred_heading", "sem_cls_scores", "lang_scores")
    ious, multiple, others, lang_accs = [], [], [], []
    aps = {0.25: APCalculator(0.25), 0.5: APCalculator(0.5)}
    for batch in loader:
        with torch.no_grad():
            out = model(to_device(batch, device), is_eval=True)
        out = {k: out[k].cpu().numpy() for k in keys if k in out}
        arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
        g = get_eval(out, arrays, mean_size_arr=mean_size,
                     use_lang_classifier=model.config.model.use_lang_classifier)
        ious += g["ref_iou"]
        multiple += g["ref_multiple_mask"]
        others += g["ref_others_mask"]
        lang_accs.append(g["lang_acc"])
        if detection_map:
            _, preds = parse_predictions(
                {**out, "point_clouds": arrays["point_clouds"]}, {})
            gts = parse_groundtruths(arrays, mean_size)
            for ap in aps.values():
                ap.step(preds, gts)
    result = final_eval_breakdown(ious, multiple, others)
    result["lang_acc"] = float(np.mean(lang_accs)) if lang_accs else 0.0
    if detection_map:
        for iou, ap in aps.items():
            result[f"mAP@{iou}"] = ap.compute_metrics()["mAP"]
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--model_name", type=str, default="model")
    p.add_argument("--detection_map", action="store_true")
    args = p.parse_args(argv)

    config = resolve_config(args)
    val_ds = build_val_dataset(args, config)
    predictor = GroundingPredictor(
        config, load_params(args.model_dir, args.model_name)
        if args.model_dir else None, device=args.device)
    loader = BatchIterator(val_ds, config.train.batch_size, drop_last=True,
                           num_workers=config.train.num_workers)
    result = evaluate(predictor.model, loader, predictor.device,
                      config.dataset.mean_size_arr(),
                      detection_map=args.detection_map)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
