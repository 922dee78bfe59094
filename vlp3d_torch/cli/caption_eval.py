"""Standalone Scan2Cap metric evaluation of a trained model.

The port's counterpart of ``vlp3d/cli/caption_eval.py`` (after
scripts/joint_scripts/caption_eval.py): a snapshot's captions over the
val split (greedy per proposal, or beam search with ``--num_beams`` > 1;
NMS and IoU >= 0.5 against the assigned GT box), scored as BLEU-1..4,
CIDEr, ROUGE-L and METEOR (eval_cap, lib/joint/eval_helper.py:278-357).

    python -m vlp3d_torch.cli.caption_eval --synthetic --smoke --device cpu
    python -m vlp3d_torch.cli.caption_eval --scanrefer_dir ... \\
        --scannet_data ... --model_dir RUN --snapshot caption_model
"""

from __future__ import annotations

import argparse
import json

from vlp3d_torch.cli.common import (
    add_common_args,
    build_val_dataset,
    load_scanrefer,
    resolve_config,
)
from vlp3d_torch.data.dataset import BatchIterator
from vlp3d_torch.data.tokenizer import load_tokenizer
from vlp3d_torch.eval.captioning import (
    organize_scanrefer,
    prepare_corpus,
    score_captions,
)
from vlp3d_torch.eval.scan2cap import collect_batch
from vlp3d_torch.serving import CaptionPredictor, to_device
from vlp3d_torch.train.checkpoint import load_params

# the reference annotations of --synthetic's val scenes
SYNTHETIC_ANNS = [
    {"scene_id": s, "object_id": str(o), "object_name": "chair",
     "ann_id": str(a), "token": ["a", "chair"]}
    for s in ("scene0000_00", "scene0001_00") for o in range(2)
    for a in range(2)
]


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--snapshot", type=str, default="model",
                   help="snapshot name inside model_dir (model / "
                        "caption_model / model_last)")
    p.add_argument("--out", type=str, default="",
                   help="optional json dump of the metric dict")
    p.add_argument("--num_beams", type=int, default=1,
                   help="beam width for caption decode (1 = greedy, the "
                        "reference's effective setting)")
    p.add_argument("--length_penalty", type=float, default=1.0,
                   help="beam-search length normalization exponent")
    args = p.parse_args(argv)
    args.no_caption = False

    config = resolve_config(args)
    val_ds = build_val_dataset(args, config)
    tokenizer = load_tokenizer(args.bert_vocab or None)
    # corpus + organized GT from the val annotations (eval_helper.py:24-44)
    anns = (SYNTHETIC_ANNS if args.synthetic
            else load_scanrefer(args.scanrefer_dir, "val"))
    corpus = prepare_corpus(anns, config.model.max_des_len)
    organized = organize_scanrefer(anns)

    predictor = CaptionPredictor(
        config, load_params(args.model_dir, args.snapshot)
        if args.model_dir else None, device=args.device)
    candidates: dict = {}
    loader = BatchIterator(val_ds, config.train.batch_size, drop_last=False,
                           num_workers=config.train.num_workers)
    for batch in loader:
        arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
        out = predictor.forward(to_device(batch, predictor.device))
        collect_batch(predictor.model, out, arrays, batch["scene_id"],
                      tokenizer, organized, candidates,
                      num_beams=args.num_beams,
                      length_penalty=args.length_penalty)

    metrics = score_captions(corpus, candidates)
    for name, value in sorted(metrics.items()):
        print(f"[caption_eval] {name}: {value:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
