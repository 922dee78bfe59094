"""ScanQA question-answering training entry point
(scripts/joint_scripts/train_qa.py): JointNet with ``use_answer=True``
over ScanQA question annotations.

The port's counterpart of ``vlp3d/cli/train_qa.py``. The answer
vocabulary is built from the training answers (Counter.most_common()
capped at --answer_max_size, filtered by --answer_min_freq, sorted keys;
train_qa.py:32-45) and written beside info.json (``num_answers``) as
``answer_vocab.json``, the id -> text list the serve CLI's
``--answer_vocab`` reads. The model runs with no_caption=True
(train_qa.py:106-127); the optimizer is the VQA recipe (Adam with
coupled L2 over one parameter group, gradient values clipped to
--max_grad_norm, MultiStepLR at --lr_decay_step x --lr_decay_rate,
lr 5e-4, wd 1e-5), and the best model is keyed on answer_acc_at1
(lib/vqa/solver.py:120,503-506). ``--pretrain RUN/model.pth`` warm-starts
from a grounding or captioning run (train_qa.py:129-134).

    python -m vlp3d_torch.cli.train_qa --use_multiview --use_normal \\
        --scanqa_dir data/scanqa --pretrain RUN/model.pth
    python -m vlp3d_torch.cli.train_qa --synthetic --smoke --device cpu

Data parallel as :mod:`vlp3d_torch.cli.train_3dvlp`: ``python -m
torch.distributed.run --nproc_per_node N -m vlp3d_torch.cli.train_qa
...`` or ``srun``; ``--tp k`` (N = dp x k ranks) and ``--zero1`` as
there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

def build_qa_datasets(args, config):
    """(train_ds, val_ds) of ScanQADataset: joint-format batches plus
    answer_cat / answer_cats / answer_cat_scores."""
    from vlp3d_torch.data.vqa_dataset import ScanQADataset, build_answer_vocab

    if args.synthetic:
        from vlp3d_torch.data.synthetic import synthetic_qa
        from vlp3d_torch.data.tokenizer import HashTokenizer

        qa_train, source = synthetic_qa(config)
        qa_val = qa_train
        tokenizer = HashTokenizer()
        raw2label = {}
    else:
        from vlp3d_torch.data.dataset import (
            DirectorySceneSource,
            load_raw2label,
        )
        from vlp3d_torch.data.tokenizer import load_tokenizer

        with open(os.path.join(
                args.scanqa_dir, f"{args.project}_train.json")) as f:
            qa_train = json.load(f)
        with open(os.path.join(
                args.scanqa_dir, f"{args.project}_val.json")) as f:
            qa_val = json.load(f)
        source = DirectorySceneSource(
            args.scannet_data, multiview_hdf5=args.multiview_hdf5 or None)
        tokenizer = load_tokenizer(args.bert_vocab or None)
        raw2label = load_raw2label(args.labels_tsv) if args.labels_tsv else {}

    vocab, counter = build_answer_vocab(
        qa_train, min_count=args.answer_min_freq,
        max_size=args.answer_max_size)
    common = dict(
        answer_vocab=vocab,
        answer_counter=counter,
        num_answers=max(len(vocab), 1),
        num_points=config.dataset.num_points,
        lang_num_max=config.model.lang_num_max,
        bert_max_len=config.model.bert_seq_len,
        mean_size_arr=config.dataset.mean_size_arr(),
        raw2label=raw2label,
        seed=args.seed,
    )
    train_ds = ScanQADataset(
        qa_train, source, tokenizer, split="train",
        augment=not args.no_augment, shuffle=True, **common)
    val_ds = ScanQADataset(
        qa_val, source, tokenizer, split="val", augment=False, **common)
    return train_ds, val_ds


def parse_args(argv=None):
    from vlp3d_torch.cli.common import add_common_args

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--scanqa_dir", type=str, default="data/scanqa")
    p.add_argument("--project", type=str, default="ScanQA_v1.0")
    p.add_argument("--answer_max_size", type=int, default=-1)
    p.add_argument("--answer_min_freq", type=int, default=1)
    # the reference VQA recipe: MultiStepLR([100, 200], gamma 0.2)
    # (scripts/joint_scripts/train_qa.py:446-449, lib/vqa/solver.py:210)
    p.add_argument("--lr_decay_step", nargs="+", type=int,
                   default=[100, 200])
    p.add_argument("--lr_decay_rate", type=float, default=0.2)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="clip_grad_value_ bound (the reference's name; it "
                        "clips VALUES, lib/vqa/solver.py:336-339)")
    # the VQA defaults (scripts/joint_scripts/train_qa.py:435-437)
    p.set_defaults(lr=5e-4, wd=1e-5)
    args = p.parse_args(argv)
    args.use_answer = True
    args.no_caption = True  # the reference's get_model: no_caption=True
    if not any(a.startswith("--criterion") for a in (argv or [])):
        args.criterion = "answer_acc_at1"
    return args


def main(argv=None):
    """Parse the flags, join the process group (data parallel under
    ``torchrun`` / ``srun``, as train_3dvlp) and train."""
    import sys

    from vlp3d_torch.cli.common import process_group

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    with process_group(args):
        return _train(args)


def _train(args):
    from vlp3d_torch.cli.common import (
        resolve_config,
        resolve_workdir,
        run_training,
    )
    from vlp3d_torch.parallel.distributed import is_main_process

    config = resolve_config(args)
    train_ds, val_ds = build_qa_datasets(args, config)
    config = dataclasses.replace(
        config,
        model=dataclasses.replace(
            config.model, num_answers=train_ds.num_answers, use_answer=True,
            no_caption=True),
        # the VQA recipe: plain Adam (coupled L2) over one parameter group,
        # MultiStepLR whatever --coslr says, clip_grad_value_
        train=dataclasses.replace(
            config.train, lr_schedule="step",
            lr_decay_steps=tuple(args.lr_decay_step),
            lr_decay_rate=args.lr_decay_rate, optim_name="adam",
            single_lr_group=True, clip_grad_value=args.max_grad_norm),
    )
    workdir = resolve_workdir(args)
    if is_main_process():
        with open(os.path.join(workdir, "info.json"), "w") as f:
            json.dump({"args": vars(args),
                       "num_answers": train_ds.num_answers}, f, indent=2)
        with open(os.path.join(workdir, "answer_vocab.json"), "w") as f:
            json.dump(sorted(train_ds.answer_vocab,
                             key=train_ds.answer_vocab.get), f)

    return run_training(args, config, train_ds, val_ds, workdir,
                        caption=False, use_bn_schedule=True)


if __name__ == "__main__":
    main()
