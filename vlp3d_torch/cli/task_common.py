"""What the three single-task trainers share (ScanQA with MCAN, RefNet,
CapNet): their common flags, the run directory, and the epoch loop.

Counterpart of the loops the JAX trainers ``vlp3d/cli/train_scanqa.py``,
``train_3djcg_g.py`` and ``train_3djcg_c.py`` each write out: every
epoch the train split is re-chunked and run through ``BatchIterator``
(one train step a batch, dropout drawn from a generator seeded with
``--seed``), the last step's scalar metrics are logged, and every
``--val_step`` epochs the val split is scored; a better value of the
trainer's criterion saves the best snapshot. ``model_last.pth`` and
``best.json`` are written at the end. Snapshots are
:func:`~vlp3d_torch.train.checkpoint.save_params` ``.pth`` files (the JAX
trainers write orbax directories of the same names).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import numpy as np
import torch


def add_task_args(p: argparse.ArgumentParser, *, batch_size: int = 8):
    """The flags every single-task trainer has (their JAX defaults), plus
    the port's ``--device``."""
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--scannet_data", type=str, default="data/scannet_data")
    p.add_argument("--glove_pickle", type=str, default="")
    p.add_argument("--labels_tsv", type=str, default="")
    p.add_argument("--batch_size", type=int, default=batch_size)
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val_step", type=int, default=1)
    p.add_argument("--smoke", action="store_true",
                   help="tiny synthetic end-to-end run (no assets)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the current "
                        "CUDA device; without one the run fails rather "
                        "than fall back to the CPU)")


def make_workdir(args) -> str:
    """<output_dir>/<time stamp>[_<TAG>], created."""
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    if args.tag:
        stamp += "_" + args.tag.upper()
    workdir = os.path.join(args.output_dir, stamp)
    os.makedirs(workdir, exist_ok=True)
    return workdir


def host_batch(batch: dict) -> dict:
    """A loader batch without its list entries (scene ids)."""
    return {k: v for k, v in batch.items() if not isinstance(v, list)}


def scalars(metrics: dict) -> dict:
    """The 0-dim tensors of ``metrics``, detached (reading none)."""
    return {k: v.detach() for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0}


def run_task(args, model, optimizer, train_ds, val_ds, workdir: str, *,
             device, prep: Callable, loss_fn: Callable, validate: Callable,
             best_key: str, best_init: dict, snapshot: str) -> dict:
    """The epoch loop. ``prep(host_batch) -> device batch``,
    ``loss_fn(outputs, batch) -> (loss, metrics)``, ``validate(batches)
    -> (val metrics, the line to print)`` over an iterable of device
    batches. The best snapshot ``snapshot`` is saved whenever
    ``val[best_key]`` beats the best so far; returns the best record."""
    from vlp3d_torch.data.dataset import BatchIterator
    from vlp3d_torch.models.layers import set_dropout_generator
    from vlp3d_torch.train import checkpoint as ckpt
    from vlp3d_torch.train.state import backward_and_step

    gen = torch.Generator(device=device).manual_seed(args.seed)
    set_dropout_generator(model, gen)
    rng = np.random.default_rng(args.seed)
    best = dict(best_init)
    with open(os.path.join(workdir, "log.jsonl"), "a") as logf:
        for epoch in range(args.epoch):
            train_ds.shuffle_data()
            metrics = {}
            for batch in BatchIterator(train_ds, args.batch_size,
                                       epoch=epoch,
                                       num_workers=args.num_workers,
                                       rng=rng):
                b = prep(batch)
                loss, m = loss_fn(model(b, train=True), b)
                backward_and_step(loss, optimizer)
                metrics = scalars(m)
            logf.write(json.dumps({"phase": "train", "epoch": epoch, **{
                k: float(v) for k, v in metrics.items()}}) + "\n")
            if (epoch + 1) % args.val_step:
                continue
            batches = (prep(b) for b in BatchIterator(
                val_ds, args.batch_size, drop_last=False,
                num_workers=args.num_workers,
                rng=np.random.default_rng(0)))
            val, line = validate(batches)
            logf.write(json.dumps({"phase": "val", "epoch": epoch, **val})
                       + "\n")
            logf.flush()
            print(f"epoch {epoch}: {line}", flush=True)
            if val[best_key] > best[best_key]:
                best = {"epoch": epoch, **val}
                ckpt.save_params(workdir, snapshot, model.state_dict())
    ckpt.save_params(workdir, "model_last", model.state_dict())
    with open(os.path.join(workdir, "best.json"), "w") as f:
        json.dump(best, f)
    print("best:", best)
    return best
