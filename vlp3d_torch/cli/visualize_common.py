"""What the three visualizer CLIs share: their flags, the val split's
loader, the model with ``--model_dir``'s weights, and one batch's
forward at ``is_eval`` copied to the host."""

from __future__ import annotations

import argparse

import torch

from vlp3d_torch.cli.common import (
    add_common_args,
    build_val_dataset,
    resolve_config,
)
from vlp3d_torch.data.dataset import BatchIterator
from vlp3d_torch.serving import GroundingPredictor, to_device
from vlp3d_torch.train.checkpoint import load_params_into


def parse_visualizer_args(argv, out_dir: str, max_scenes: int):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--model_name", type=str, default="model")
    p.add_argument("--out_dir", type=str, default=out_dir)
    p.add_argument("--max_scenes", type=int, default=max_scenes)
    return p.parse_args(argv)


def visualizer_setup(args, predictor_cls=GroundingPredictor):
    """(config, predictor, loader) of the val split. The model holds
    ``--model_dir``'s snapshot as far as it goes (a head the snapshot
    lacks, such as a grounding run's caption decoder, keeps its seeded
    values; the counts are printed), else its seeded initialisation."""
    config = resolve_config(args)
    val_ds = build_val_dataset(args, config)
    predictor = predictor_cls(config, device=args.device)
    if args.model_dir:
        got = load_params_into(predictor.model, args.model_dir,
                               args.model_name)
        print(f"{args.model_dir}/{args.model_name}.pth: {got['restored']} "
              f"entries restored, {got['fresh']} fresh, {got['ignored']} "
              "ignored")
    loader = BatchIterator(val_ds, config.train.batch_size, drop_last=False,
                           num_workers=config.train.num_workers)
    return predictor.config, predictor, loader


@torch.no_grad()
def forward_host(predictor, batch: dict, keys) -> dict:
    """One host batch through the predictor's model at ``is_eval`` ->
    ``keys`` of its outputs as host arrays."""
    out = predictor.model(to_device(batch, predictor.device), is_eval=True)
    return {k: out[k].cpu().numpy() for k in keys}
