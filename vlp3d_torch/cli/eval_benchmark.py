"""Benchmark scorer: a pred.json against the organized GT boxes.

The port's counterpart of ``vlp3d/cli/eval_benchmark.py`` (the
benchmark/eval.py contract, :37-165): grounding Acc@0.25 / 0.5 with the
unique / multiple x others breakdown, over the records whose
(scene, object, annotation) the GT json holds.

    python -m vlp3d_torch.cli.eval_benchmark --pred pred.json --gt gt.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from vlp3d_torch.eval.box_iou import box3d_iou
from vlp3d_torch.eval.grounding import final_eval_breakdown


def evaluate(preds: list, gts: dict) -> dict:
    """gts: {scene_id: {object_id: {ann_id: {bbox: 8x3}}}} (the benchmark's
    organized GT json). A record whose key the GTs lack is not scored;
    ``num_scored`` counts the rest."""
    ious, multiple, others = [], [], []
    for pred in preds:
        sid = pred["scene_id"]
        oid = str(pred["object_id"])
        ann = str(pred["ann_id"])
        try:
            gt_bbox = np.asarray(gts[sid][oid][ann]["bbox"])
        except KeyError:
            continue
        ious.append(box3d_iou(np.asarray(pred["bbox"]), gt_bbox))
        multiple.append(pred.get("unique_multiple", 0))
        others.append(pred.get("others", 0))
    out = final_eval_breakdown(ious, multiple, others)
    out["num_scored"] = len(ious)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred", type=str, required=True)
    p.add_argument("--gt", type=str, required=True)
    args = p.parse_args(argv)
    with open(args.pred) as f:
        preds = json.load(f)
    with open(args.gt) as f:
        gts = json.load(f)
    out = evaluate(preds, gts)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
