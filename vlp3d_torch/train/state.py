"""Train and eval steps of the joint model.

Counterpart of ``vlp3d/train/state.py`` ``make_train_step`` /
``make_eval_step`` as plain functions over the module, the optimizer and
an explicit generator. The state the JAX package threads through a
``TrainState`` lives where PyTorch keeps it: parameters and BatchNorm
statistics in the module, moments and the step count in the optimizer.

Data parallel (``shard``, a :class:`~vlp3d_torch.parallel.reduce.BatchShard`
of the default process group; one process a card). The port all-reduces
the gradients by hand instead of wrapping the model in
``DistributedDataParallel``:

  * the loss already holds differentiable collectives (the BatchNorm
    statistics, the losses' global sums, the copy-paste gather), so every
    rank computes the one global loss and its backward runs the matching
    collectives; the gradients are averaged over the ranks once the
    backward has ended, so no bucket all-reduce interleaves with those;
  * every trained parameter takes part, with a zero gradient where it has
    none (the contrast head before epoch 50, C6): the optimizer then
    treats it as optax does, and DDP's ``find_unused_parameters``
    traversal is not needed;
  * ``grad_accum``: the micro-batches before the update only add to
    ``.grad`` (what DDP's ``no_sync`` does) and the update's micro-batch
    reduces the sum once;
  * ``--remat``: a checkpoint's recompute runs the same BatchNorm
    collectives again in the backward, in the same order on every rank.

With :data:`~vlp3d_torch.parallel.reduce.LOCAL` (one process, the
default) the step is the one-process step, with no collective.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vlp3d_torch.config import Config
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.models.jointnet import JointNet
from vlp3d_torch.models.layers import set_batch_shard, set_dropout_generator
from vlp3d_torch.parallel.reduce import LOCAL


def batch_to_device(batch: dict, device) -> dict:
    """Host batch (numpy arrays and scalars, as ``make_batch`` or the
    loader give it) -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _scalars(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0}


def backward_and_step(loss: torch.Tensor, optimizer, shard=LOCAL) -> None:
    """One micro-batch of ``optimizer.grad_accum`` = k: clear ``.grad`` at
    a window's start, add the gradients of ``loss / k``, and update the
    parameters on the window's k-th call (every call when k = 1), after
    averaging the gradients over ``shard``'s ranks."""
    k = optimizer.grad_accum
    if optimizer.micro_step == 0:
        optimizer.zero_grad(set_to_none=True)
    (loss / k if k > 1 else loss).backward()
    optimizer.micro_step += 1
    if optimizer.micro_step == k:
        shard.average_gradients(
            [p for g in optimizer.param_groups for p in g["params"]])
        optimizer.step()
        optimizer.micro_step = 0


def make_train_step(model: JointNet, config: Config, optimizer, *,
                    caption: bool = False, reference: bool = True,
                    detection: bool = True, shard=LOCAL) -> Callable:
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

    ``shard``: under data parallel, this rank's
    :class:`~vlp3d_torch.parallel.reduce.BatchShard`; ``batch`` then
    holds this rank's rows of the global batch, ``generator`` is seeded
    alike on every rank, and the step (its loss, metrics, gradients,
    BatchNorm statistics and update) is the one-process step on the
    global batch.
    """

    def train_step(batch: dict, generator: torch.Generator | None = None):
        set_batch_shard(model, shard)
        set_dropout_generator(model, generator)
        model.mask_generator = generator
        out = model(batch, train=True)
        loss, metrics = compute_joint_loss(
            config, out, batch, caption=caption, reference=reference,
            detection=detection, shard=shard)
        backward_and_step(loss, optimizer, shard)
        return _scalars(metrics)

    return train_step


def make_eval_step(model: JointNet, config: Config, *,
                   reference: bool = True, detection: bool = True,
                   shard=LOCAL) -> Callable:
    """Returns ``eval_step(batch) -> (outputs, metrics)``: the forward at
    evaluation (running BatchNorm statistics, no dropout, no box masks, no
    gradient) and the loss's scalar metrics, with the train step's
    ``reference`` / ``detection`` and without the caption term (the JAX
    solver's eval step leaves it out; a caption model's outputs still
    hold ``lang_cap``). Under data parallel (``shard``) ``batch`` holds
    this rank's rows and the metrics are the global batch's; a call's own
    ``shard`` overrides the step's
    (:data:`~vlp3d_torch.parallel.reduce.LOCAL` for a batch that every
    rank runs whole)."""

    def eval_step(batch: dict, shard=shard):
        set_batch_shard(model, shard)
        out = model(batch, train=False)
        with torch.no_grad():
            _, metrics = compute_joint_loss(config, out, batch,
                                            reference=reference,
                                            detection=detection, shard=shard)
        return out, _scalars(metrics)

    return eval_step
