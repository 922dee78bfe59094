"""Grounding evaluation entry point (scripts/joint_scripts/ground_eval.py).

The port's counterpart of ``vlp3d/cli/ground_eval.py``: runs the val
split through the grounding model and reports Acc@0.25/0.5 with the
unique/multiple x others breakdown, and the language classifier's
accuracy ``lang_acc``.

    python -m vlp3d_torch.cli.ground_eval --model_dir RUN \\
        --use_multiview --use_normal --no_caption --use_con ...

``--detection_map`` (detection mAP through the AP calculator) needs the
port of ``vlp3d/eval/detection.py``, which comes with captioning
(ROADMAP.md queue A item A16), and raises until then.
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
from vlp3d_torch.eval.grounding import final_eval_breakdown, get_eval
from vlp3d_torch.serving import GroundingPredictor, to_device
from vlp3d_torch.train.checkpoint import load_params

DETECTION_ITEM = "ROADMAP.md queue A item A16 (vlp3d/eval/detection.py)"


def evaluate(model, loader, device, mean_size) -> dict:
    """Acc@0.25/0.5 breakdown and lang_acc over the loader's batches."""
    keys = ("objectness_scores", "cluster_ref", "pred_center", "pred_size",
            "pred_heading", "sem_cls_scores", "lang_scores")
    ious, multiple, others, lang_accs = [], [], [], []
    for batch in loader:
        with torch.no_grad():
            out = model(to_device(batch, device), is_eval=True)
        out = {k: out[k].cpu().numpy() for k in keys if k in out}
        arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
        g = get_eval(out, arrays, mean_size_arr=mean_size)
        ious += g["ref_iou"]
        multiple += g["ref_multiple_mask"]
        others += g["ref_others_mask"]
        lang_accs.append(g["lang_acc"])
    result = final_eval_breakdown(ious, multiple, others)
    result["lang_acc"] = float(np.mean(lang_accs)) if lang_accs else 0.0
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--model_name", type=str, default="model")
    p.add_argument("--detection_map", action="store_true")
    args = p.parse_args(argv)
    if args.detection_map:
        raise NotImplementedError(
            f"--detection_map needs the port of vlp3d/eval/detection.py; "
            f"see {DETECTION_ITEM}")

    config = resolve_config(args)
    val_ds = build_val_dataset(args, config)
    predictor = GroundingPredictor(
        config, load_params(args.model_dir, args.model_name)
        if args.model_dir else None, device=args.device)
    loader = BatchIterator(val_ds, config.train.batch_size, drop_last=True,
                           num_workers=config.train.num_workers)
    result = evaluate(predictor.model, loader, predictor.device,
                      config.dataset.mean_size_arr())
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
