"""Train and eval steps of the joint model.

Counterpart of ``vlp3d/train/state.py`` ``make_train_step`` /
``make_eval_step`` as plain functions over the module, the optimizer and
an explicit generator. The state the JAX package threads through a
``TrainState`` lives where PyTorch keeps it: parameters and BatchNorm
statistics in the module, moments and the step count in the optimizer.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vlp3d_torch.config import Config
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.models.jointnet import JointNet
from vlp3d_torch.models.layers import set_dropout_generator


def batch_to_device(batch: dict, device) -> dict:
    """Host batch (numpy arrays and scalars, as ``make_batch`` or the
    loader give it) -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _scalars(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0}


def backward_and_step(loss: torch.Tensor, optimizer) -> None:
    """One micro-batch of ``optimizer.grad_accum`` = k: clear ``.grad`` at
    a window's start, add the gradients of ``loss / k``, and update the
    parameters on the window's k-th call (every call when k = 1)."""
    k = optimizer.grad_accum
    if optimizer.micro_step == 0:
        optimizer.zero_grad(set_to_none=True)
    (loss / k if k > 1 else loss).backward()
    optimizer.micro_step += 1
    if optimizer.micro_step == k:
        optimizer.step()
        optimizer.micro_step = 0


def make_train_step(model: JointNet, config: Config, optimizer, *,
                    caption: bool = False, reference: bool = True,
                    detection: bool = True) -> Callable:
    """Returns ``train_step(batch, generator=None) -> metrics``: forward
    in training mode, the joint loss, gradients, one optimizer update and
    new BatchNorm statistics, all in place in ``model`` and ``optimizer``.

    With ``optimizer.grad_accum`` = k > 1 a call is one micro-batch: it
    adds the gradients of ``loss / k`` to ``.grad`` (cleared at the start
    of each window of k) and updates the parameters on every k-th call,
    so k micro-batches of B take the step of one batch of k x B; the
    BatchNorm statistics move on every call.

    ``batch`` holds tensors on the model's device
    (:func:`batch_to_device`); ``generator`` (a ``torch.Generator`` on
    that device) draws the dropout masks, the ``mask_box`` masks and the
    caption / MLM token masks, the global generator when None; it advances
    every step. ``caption`` adds the caption loss; ``reference`` and
    ``detection`` switch the loss's terms (the Solver's, see
    :func:`~vlp3d_torch.losses.joint.compute_joint_loss`). ``metrics`` are
    the scalar entries of the loss's metrics, as 0-dim
    tensors on the device (reading one synchronises). ``optimizer`` is
    :func:`vlp3d_torch.train.optimizer.make_optimizer`'s.
    """

    def train_step(batch: dict, generator: torch.Generator | None = None):
        set_dropout_generator(model, generator)
        model.mask_generator = generator
        out = model(batch, train=True)
        loss, metrics = compute_joint_loss(
            config, out, batch, caption=caption, reference=reference,
            detection=detection)
        backward_and_step(loss, optimizer)
        return _scalars(metrics)

    return train_step


def make_eval_step(model: JointNet, config: Config, *,
                   reference: bool = True, detection: bool = True) -> Callable:
    """Returns ``eval_step(batch) -> (outputs, metrics)``: the forward at
    evaluation (running BatchNorm statistics, no dropout, no box masks, no
    gradient) and the loss's scalar metrics, with the train step's
    ``reference`` / ``detection`` and without the caption term (the JAX
    solver's eval step leaves it out; a caption model's outputs still
    hold ``lang_cap``)."""

    def eval_step(batch: dict):
        out = model(batch, train=False)
        with torch.no_grad():
            _, metrics = compute_joint_loss(config, out, batch,
                                            reference=reference,
                                            detection=detection)
        return out, _scalars(metrics)

    return eval_step
