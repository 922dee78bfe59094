"""vlp3d_torch: the PyTorch + CUDA port of vlp3d for NVIDIA Hopper.

Slice 1 covers ScanRefer grounding inference: the PointNet++ backbone
(hand-written CUDA kernels for furthest point sampling, ball query,
three-NN and the row gather under ``csrc/``), voting, proposals, relation,
the frozen BERT text encoder, the match head and
:class:`~vlp3d_torch.serving.GroundingPredictor`. Slice 2 adds the joint
train step: train-mode BatchNorm and dropout, the gather's scatter-add
backward kernel, the contrast head, the detection / grounding / joint
losses, AdamW with its learning-rate groups, and
:func:`~vlp3d_torch.train.state.make_train_step` /
:func:`~vlp3d_torch.train.state.make_eval_step`. Slice 6 adds the
ScanRefer data path (:mod:`vlp3d_torch.data`, :mod:`vlp3d_torch.native`),
checkpoints (:mod:`vlp3d_torch.train.checkpoint`), the grounding
evaluation (:mod:`vlp3d_torch.eval`) and the ``predict`` / ``ground_eval``
CLIs (:mod:`vlp3d_torch.cli`). Slice 7 adds the trainer behind run.sh
(:class:`~vlp3d_torch.train.solver.Solver`, ``python -m
vlp3d_torch.cli.train_3dvlp``: resume, warm start, gradient
accumulation, rematerialisation, the TensorBoard / wandb / JSONL logs of
:mod:`vlp3d_torch.utils`) and the HTTP grounding server
(:mod:`vlp3d_torch.serve`, ``python -m vlp3d_torch.cli.serve``). Slice 8
adds Scan2Cap captioning: the caption decoder with KV-cached greedy and
beam decode (:mod:`vlp3d_torch.models.caption`), the caption and MLM
losses, :class:`~vlp3d_torch.serving.CaptionPredictor`, ``/v1/caption``,
and the ``caption_predict`` / ``caption_eval`` / ``train_caption`` CLIs.
Activations are channels-last (B, N, C), as in the JAX package; weights
load from the reference-layout state dict
(:func:`vlp3d_torch.convert.jax_to_torch_state_dict`).
"""

from vlp3d_torch.config import (
    Config,
    DatasetConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from vlp3d_torch.device import resolve_device

__all__ = ["Config", "DatasetConfig", "LossConfig", "ModelConfig",
           "TrainConfig", "resolve_device"]
