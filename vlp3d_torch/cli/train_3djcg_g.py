"""Legacy single-task grounding training: RefNet with the GloVe/LSTM
language encoder.

The port's counterpart of ``vlp3d/cli/train_3djcg_g.py`` (the
reference's ``scripts/grounding_scripts/train_3djcg_g.py`` +
``lib/visual_grounding/solver_3djcg_g.py``, broken as checked out
upstream, so this mirrors the contract): backbone / vote / proposal /
relation / match without BERT or contrast heads, GloVe-embedded
descriptions through an LSTM encoder, scored by the joint detection +
reference loss (``no_caption``, ``use_con=False``, ``use_mlm=False``)
and grounding Acc@0.25 / 0.5, the best model (``ground_model.pth``)
kept by ``iou_rate_0.5``. The optimizer is ``optax.adamw(lr, wd)``: one
group, every parameter decayed.

    python -m vlp3d_torch.cli.train_3djcg_g --scanrefer_dir data/scanrefer \\
        --glove_pickle data/glove.p
    python -m vlp3d_torch.cli.train_3djcg_g --synthetic --epoch 1
    python -m vlp3d_torch.cli.train_3djcg_g --synthetic --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def build_parser():
    from vlp3d_torch.cli.task_common import add_task_args

    p = argparse.ArgumentParser()
    add_task_args(p)
    p.add_argument("--scanrefer_dir", type=str, default="data/scanrefer")
    p.add_argument("--epoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--wd", type=float, default=1e-3)
    p.add_argument("--lang_num_max", type=int, default=8)
    p.add_argument("--use_diou_loss", action="store_true", default=True)
    return p


def adamw_one_group(model, lr: float, wd: float):
    """``optax.adamw(lr, weight_decay=wd)``: decoupled decay of every
    parameter, one group, a constant learning rate."""
    from vlp3d_torch.train import make_optimizer

    return make_optimizer(model, base_lr=lr, weight_decay=wd,
                          optim_name="adamw", single_group=True)


def scanrefer_glove_datasets(args, config, *, caption_vocab=None,
                             max_des_len: int = 30):
    """(train, val) ScanReferJointDataset with the GloVe fields (and the
    caption-vocabulary fields when ``caption_vocab``), synthetic or from
    the ScanRefer files."""
    common = dict(glove=None, max_des_len=max_des_len,
                  caption_vocab=caption_vocab)
    if args.synthetic:
        from vlp3d_torch.data.synthetic import (
            REF_WORDS,
            make_synthetic_dataset,
            synthetic_glove_for,
        )

        extra = ("unk", "pad", "sos", "eos") if caption_vocab else (
            "unk", "pad")
        common["glove"] = synthetic_glove_for(REF_WORDS, extra)
        mk = dict(n_scenes=2, n_points=config.dataset.num_points, **common)
        return (make_synthetic_dataset(config, **mk),
                make_synthetic_dataset(config, split="val", **mk))
    from vlp3d_torch.cli.common import load_scanrefer
    from vlp3d_torch.data.dataset import (
        DirectorySceneSource,
        ScanReferJointDataset,
        load_raw2label,
    )
    from vlp3d_torch.data.glove import load_glove
    from vlp3d_torch.data.tokenizer import load_tokenizer

    common.update(
        glove=load_glove(args.glove_pickle),
        raw2label=load_raw2label(args.labels_tsv) if args.labels_tsv else {},
        num_points=config.dataset.num_points,
        lang_num_max=config.model.lang_num_max,
        mean_size_arr=config.dataset.mean_size_arr())
    source = DirectorySceneSource(args.scannet_data)
    tok = load_tokenizer("")
    return (ScanReferJointDataset(
        load_scanrefer(args.scanrefer_dir, "train"), source, tok,
        split="train", augment=True, **common),
        ScanReferJointDataset(
            load_scanrefer(args.scanrefer_dir, "val"), source, tok,
            split="val", **common))


def main(argv=None):
    from vlp3d_torch.cli.task_common import host_batch, make_workdir, run_task
    from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
    from vlp3d_torch.data.synthetic import tiny_config
    from vlp3d_torch.device import resolve_device
    from vlp3d_torch.eval.grounding import get_eval
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.jointnet import init_weights_
    from vlp3d_torch.models.refnet import RefNet
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
                        model=ModelConfig(lang_num_max=args.lang_num_max))
    config = dataclasses.replace(config, model=dataclasses.replace(
        config.model, no_caption=True, use_con=False, use_mlm=False))
    workdir = make_workdir(args)
    train_ds, val_ds = scanrefer_glove_datasets(args, config)

    model = RefNet(config, device=device)
    init_weights_(model, args.seed)
    optimizer = adamw_one_group(model, args.lr, args.wd)
    mean_size = config.dataset.mean_size_arr()

    def prep(batch):
        return batch_to_device(host_batch(batch), device)

    def loss_fn(out, batch):
        return compute_joint_loss(config, out, batch)

    def validate(batches):
        ious = []
        for batch in batches:
            out = model(batch)
            g = get_eval(
                {k: v.cpu().numpy() for k, v in out.items()},
                {k: v.cpu().numpy() for k, v in batch.items()},
                mean_size_arr=mean_size,
                use_lang_classifier=config.model.use_lang_classifier)
            ious += g["ref_iou"]
        ious = np.asarray(ious)
        r25 = float((ious >= 0.25).mean()) if len(ious) else 0.0
        r5 = float((ious >= 0.5).mean()) if len(ious) else 0.0
        return ({"iou_rate_0.25": r25, "iou_rate_0.5": r5},
                f"Acc@0.25 {r25:.4f} Acc@0.5 {r5:.4f}")

    return run_task(args, model, optimizer, train_ds, val_ds, workdir,
                    device=device, prep=prep, loss_fn=loss_fn,
                    validate=validate, best_key="iou_rate_0.5",
                    best_init={"epoch": 0, "iou_rate_0.25": -1.0,
                               "iou_rate_0.5": -1.0},
                    snapshot="ground_model")


if __name__ == "__main__":
    main()
