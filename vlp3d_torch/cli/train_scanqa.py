"""Standalone ScanQA training (the reference's non-joint VQA pipeline:
``scripts/vqa_scripts/train.py`` + ``lib/vqa/solver.py``).

The port's counterpart of ``vlp3d/cli/train_scanqa.py``: the MCAN-based
ScanQA model (:class:`vlp3d_torch.models.scanqa.ScanQA`: GloVe + LSTM
language encoder, PointNet++ detection, MCAN fusion, answer head)
trained with :func:`vlp3d_torch.losses.vqa.compute_vqa_loss`, answer
EM@1 / EM@10 printed and logged every ``--val_step`` epochs
(lib/vqa/solver.py:366-390), the best model (``model.pth``) kept by
EM@1. The optimizer is the reference's: Adam with coupled L2 (``--wd``)
after ``clip_grad_value_(1.0)``, one parameter group, MultiStepLR
(``--lr_decay_step`` x ``--lr_decay_rate``) stepped by epoch with
``steps_per_epoch = max(len(train) // batch, 1)``.

One question an item (the reference's VQA dataset is unchunked), so the
ScanQADataset runs with lang_num_max=1 and the L axis is squeezed
(:func:`squeeze_l`).

    python -m vlp3d_torch.cli.train_scanqa --scanqa_dir data/scanqa \\
        --glove_pickle data/glove.p
    python -m vlp3d_torch.cli.train_scanqa --synthetic --epoch 1
    python -m vlp3d_torch.cli.train_scanqa --synthetic --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser():
    from vlp3d_torch.cli.task_common import add_task_args

    p = argparse.ArgumentParser()
    add_task_args(p)
    p.add_argument("--scanqa_dir", type=str, default="data/scanqa")
    p.add_argument("--epoch", type=int, default=50)
    # reference default (scripts/vqa_scripts/train.py:44)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--lr_decay_step", nargs="+", type=int,
                   default=[100, 200])
    p.add_argument("--lr_decay_rate", type=float, default=0.2)
    return p


SQUEEZED = ("lang_feat", "lang_len", "main_lang_feat", "main_lang_len",
            "first_obj", "answer_cat", "answer_cats", "answer_cat_scores")
RENAMES = {
    "ref_center_label_list": "ref_center_label",
    "ref_size_class_label_list": "ref_size_class_label",
    "ref_size_residual_label_list": "ref_size_residual_label",
    "ref_box_label_list": "ref_box_label",
    "object_cat_list": "object_cat",
}


def squeeze_l(batch: dict) -> dict:
    """Drop the lang_num_max=1 chunk axis and map the *_list reference
    labels to the per-question keys the model and loss read."""
    out = dict(batch)
    for k in SQUEEZED:
        if k in out:
            out[k] = out[k][:, 0]
    for src, dst in RENAMES.items():
        if src in out:
            out[dst] = out[src][:, 0]
    return out


def build_datasets(args, config):
    """(train, val) ScanQADataset with the GloVe fields, one question an
    item."""
    from vlp3d_torch.data.vqa_dataset import ScanQADataset

    if args.synthetic:
        from vlp3d_torch.data.synthetic import (
            QA_WORDS,
            synthetic_glove_for,
            synthetic_qa,
        )
        from vlp3d_torch.data.tokenizer import HashTokenizer

        qa_train, source = synthetic_qa(config)
        qa_val = qa_train
        glove = synthetic_glove_for(QA_WORDS)
        tokenizer = HashTokenizer()
        raw2label = {}
    else:
        from vlp3d_torch.data.dataset import (
            DirectorySceneSource,
            load_raw2label,
        )
        from vlp3d_torch.data.glove import load_glove
        from vlp3d_torch.data.tokenizer import load_tokenizer

        with open(os.path.join(args.scanqa_dir,
                               "ScanQA_v1.0_train.json")) as f:
            qa_train = json.load(f)
        with open(os.path.join(args.scanqa_dir,
                               "ScanQA_v1.0_val.json")) as f:
            qa_val = json.load(f)
        source = DirectorySceneSource(args.scannet_data)
        glove = load_glove(args.glove_pickle)
        tokenizer = load_tokenizer("")
        raw2label = load_raw2label(args.labels_tsv) if args.labels_tsv else {}
    common = dict(num_points=config.dataset.num_points, lang_num_max=1,
                  bert_max_len=config.model.bert_seq_len,
                  mean_size_arr=config.dataset.mean_size_arr(), glove=glove,
                  raw2label=raw2label)
    train_ds = ScanQADataset(qa_train, source, tokenizer, split="train",
                             **common)
    val_ds = ScanQADataset(
        qa_val, source, tokenizer, split="val",
        answer_vocab=train_ds.answer_vocab,
        answer_counter=train_ds.answer_counter,
        num_answers=train_ds.num_answers, **common)
    return train_ds, val_ds


def vqa_optimizer(model, args, steps_per_epoch: int):
    """Adam with coupled L2 after clip_grad_value_(1.0), one group,
    MultiStepLR by epoch (lib/vqa/solver.py:210-216, 336-339)."""
    from vlp3d_torch.train import make_optimizer
    from vlp3d_torch.train.schedules import step_lr

    milestones = tuple(args.lr_decay_step)
    return make_optimizer(
        model, base_lr=args.lr, weight_decay=args.wd,
        lr_schedule=lambda e, lr0: step_lr(e, lr0, milestones,
                                           args.lr_decay_rate),
        steps_per_epoch=steps_per_epoch, optim_name="adam",
        single_group=True, clip_grad_value=1.0)


def main(argv=None):
    import torch

    from vlp3d_torch.cli.task_common import host_batch, make_workdir, run_task
    from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
    from vlp3d_torch.data.synthetic import tiny_config
    from vlp3d_torch.device import resolve_device
    from vlp3d_torch.eval.vqa import answer_hits
    from vlp3d_torch.losses.vqa import compute_vqa_loss
    from vlp3d_torch.models.jointnet import init_weights_
    from vlp3d_torch.models.scanqa import ScanQA
    from vlp3d_torch.train import batch_to_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        config = tiny_config()
        args.synthetic = True
        args.batch_size = min(args.batch_size, 2)
        args.epoch = min(args.epoch, 2)
    else:
        config = Config(dataset=DatasetConfig(num_points=args.num_points),
                        model=ModelConfig())
    workdir = make_workdir(args)
    train_ds, val_ds = build_datasets(args, config)

    model = ScanQA(config, train_ds.num_answers, device=device)
    init_weights_(model, args.seed)
    optimizer = vqa_optimizer(
        model, args, max(len(train_ds) // args.batch_size, 1))
    mean_size = torch.as_tensor(config.dataset.mean_size_arr(),
                                device=device)
    topk = min(10, train_ds.num_answers)

    def prep(batch):
        return batch_to_device(squeeze_l(host_batch(batch)), device)

    def loss_fn(out, batch):
        loss, metrics = compute_vqa_loss(out, batch, mean_size)
        return loss, metrics

    def validate(batches):
        acc1s, acc10s = [], []
        for batch in batches:
            scores = model(batch)["answer_scores"]
            hit1, hitk = answer_hits(scores, batch["answer_cats"], topk)
            acc1s.append(float(hit1.float().mean()))
            acc10s.append(float(hitk.float().mean()))
        acc1, acc10 = float(np.mean(acc1s)), float(np.mean(acc10s))
        return ({"answer_acc_1": acc1, "answer_acc_10": acc10},
                f"EM@1 {acc1:.4f} EM@10 {acc10:.4f}")

    return run_task(args, model, optimizer, train_ds, val_ds, workdir,
                    device=device, prep=prep, loss_fn=loss_fn,
                    validate=validate, best_key="answer_acc_1",
                    best_init={"epoch": 0, "answer_acc_1": -1.0,
                               "answer_acc_10": -1.0},
                    snapshot="model")


if __name__ == "__main__":
    main()
