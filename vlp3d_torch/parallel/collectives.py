"""Cross-rank negatives for contrastive training.

Counterpart of ``vlp3d/parallel/collectives.py`` (the reference's
``concat_all_gather``, utils/utils_fn.py:10-21): each rank contrasts its
own rows against the embeddings of the whole global batch.

  * :func:`gather_negatives` is the all-gather of a rank's rows over the
    data group in rank order. Its backward sums the incoming gradient
    over the ranks and keeps this rank's rows, the reduce-scatter that
    JAX's ``all_gather`` transposes to (``BatchShard.cat``). NCCL on the
    card, gloo on the CPU, as :mod:`vlp3d_torch.parallel.distributed`
    sets up.
  * :func:`make_sharded_contrastive_step` wraps a loss of (local rows,
    global rows) into the loss averaged over the ranks. Every rank holds
    the same value, and the gradient that reaches each rank's inputs is
    the one-process gradient of that mean on its own rows, as
    ``jax.grad`` of the JAX package's shard_map step gives it: the
    average's backward passes 1 / W to each rank's loss (no all-reduce),
    so no gradient average follows.
"""

from __future__ import annotations

import torch

from vlp3d_torch.parallel.reduce import BatchShard


def gather_negatives(x: torch.Tensor, shard: BatchShard) -> torch.Tensor:
    """(local_B, ...) -> (global_B, ...), the ranks' rows in rank order;
    differentiable. ``shard`` is this rank's data shard
    (:meth:`BatchShard.of_group`)."""
    return shard.cat(x)


class _MeanOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        import torch.distributed as dist

        ctx.world = shard.world
        out = x.detach().clone()
        if shard.distributed:
            dist.all_reduce(out, group=shard.group)
        return out / shard.world

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.world, None


def make_sharded_contrastive_step(loss_fn, shard: BatchShard):
    """``loss_fn(local_a, global_b) -> scalar`` -> ``step(a, b)``: this
    rank's rows ``a`` and ``b``, ``b`` gathered over the ranks, and the
    loss averaged over the ranks."""

    def step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _MeanOverRanks.apply(loss_fn(a, gather_negatives(b, shard)),
                                    shard)

    return step
