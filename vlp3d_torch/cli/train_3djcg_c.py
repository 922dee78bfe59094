"""Legacy single-task captioning training: CapNet's top-down captioner.

The port's counterpart of ``vlp3d/cli/train_3djcg_c.py`` (the
reference's ``scripts/captioning_scripts/train_3djcg_c.py`` +
``lib/visual_captioning/solver_3djcg_c.py``, broken as checked out
upstream, so this mirrors the contract): detection stack + relation +
the top-down captioner over the sos/eos-wrapped GloVe embeddings of each
description, trained with the joint detection loss (``reference=False``)
plus the caption CE against the caption vocabulary
(:func:`vlp3d_torch.data.vocab.build_caption_vocabulary`), the best
model (``caption_model.pth``) kept by val ``cap_acc``. ``--num_locals``
k > 0 restricts the captioner's attention to the k proposals nearest
the target. The optimizer is ``optax.adamw(lr, wd)``: one group, every
parameter decayed.

    python -m vlp3d_torch.cli.train_3djcg_c --scanrefer_dir data/scanrefer \\
        --glove_pickle data/glove.p
    python -m vlp3d_torch.cli.train_3djcg_c --synthetic --epoch 1
    python -m vlp3d_torch.cli.train_3djcg_c --synthetic --smoke --device cpu
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
    p.add_argument("--vocab_json", type=str, default="")
    p.add_argument("--epoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--lang_num_max", type=int, default=8)
    p.add_argument("--max_des_len", type=int, default=30)
    p.add_argument("--num_locals", type=int, default=-1)
    return p


def caption_vocab(args, config) -> dict:
    """The caption vocabulary: from one synthetic scene's annotations, or
    from the ScanRefer train split over the GloVe keys (cached at
    ``--vocab_json``)."""
    from vlp3d_torch.data.vocab import build_caption_vocabulary

    if args.synthetic:
        from vlp3d_torch.data.synthetic import make_synthetic_dataset

        anns = make_synthetic_dataset(config, n_scenes=1).scanrefer
        return build_caption_vocabulary(anns, max_des_len=args.max_des_len)
    from vlp3d_torch.cli.common import load_scanrefer
    from vlp3d_torch.data.glove import load_glove

    return build_caption_vocabulary(
        load_scanrefer(args.scanrefer_dir, "train"),
        max_des_len=args.max_des_len,
        known_words=set(load_glove(args.glove_pickle)),
        vocab_path=args.vocab_json or None)


def caption_losses(config, out, batch):
    """The joint detection loss (no reference term) + the caption CE;
    metrics with cap_loss, cap_acc and the total as ``loss``."""
    from vlp3d_torch.losses.captioning import compute_cap_loss
    from vlp3d_torch.losses.joint import compute_joint_loss

    det_loss, metrics = compute_joint_loss(config, out, batch,
                                           reference=False)
    cap_loss, cap_acc = compute_cap_loss(out["lang_cap"], batch["lang_ids"],
                                         out["good_bbox_masks"])
    metrics = {k: v for k, v in metrics.items() if v.dim() == 0}
    total = det_loss + cap_loss
    metrics.update(cap_loss=cap_loss, cap_acc=cap_acc, loss=total)
    return total, metrics


def main(argv=None):
    from vlp3d_torch.cli.task_common import host_batch, make_workdir, run_task
    from vlp3d_torch.cli.train_3djcg_g import (
        adamw_one_group,
        scanrefer_glove_datasets,
    )
    from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
    from vlp3d_torch.data.synthetic import tiny_config
    from vlp3d_torch.device import resolve_device
    from vlp3d_torch.models.capnet import CapNet
    from vlp3d_torch.models.jointnet import init_weights_
    from vlp3d_torch.train import batch_to_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        config = tiny_config()
        args.synthetic = True
        args.batch_size = min(args.batch_size, 2)
        args.epoch = min(args.epoch, 2)
        args.max_des_len = 10
    else:
        config = Config(dataset=DatasetConfig(num_points=args.num_points),
                        model=ModelConfig(lang_num_max=args.lang_num_max))
    config = dataclasses.replace(config, model=dataclasses.replace(
        config.model, no_caption=True, use_con=False, use_mlm=False,
        no_reference=True))
    workdir = make_workdir(args)
    vocab = caption_vocab(args, config)
    train_ds, val_ds = scanrefer_glove_datasets(
        args, config, caption_vocab=vocab, max_des_len=args.max_des_len)

    model = CapNet(config, len(vocab["word2idx"]),
                   num_locals=args.num_locals, device=device)
    init_weights_(model, args.seed)
    optimizer = adamw_one_group(model, args.lr, args.wd)

    def prep(batch):
        b = host_batch(batch)
        # the captioner teacher-forces on the sos/eos-wrapped embeddings
        b["lang_feat"] = b["cap_lang_feat"]
        return batch_to_device(b, device)

    def loss_fn(out, batch):
        return caption_losses(config, out, batch)

    def validate(batches):
        accs, cls = [], []
        for batch in batches:
            _, m = caption_losses(config, model(batch), batch)
            accs.append(float(m["cap_acc"]))
            cls.append(float(m["cap_loss"]))
        acc = float(np.mean(accs)) if accs else 0.0
        cl = float(np.mean(cls)) if cls else 0.0
        return ({"cap_acc": acc, "cap_loss": cl},
                f"cap_acc {acc:.4f} cap_loss {cl:.4f}")

    return run_task(args, model, optimizer, train_ds, val_ds, workdir,
                    device=device, prep=prep, loss_fn=loss_fn,
                    validate=validate, best_key="cap_acc",
                    best_init={"epoch": 0, "cap_acc": -1.0},
                    snapshot="caption_model")


if __name__ == "__main__":
    main()
