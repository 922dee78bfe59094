"""The sums over the global batch that data parallel needs, and the
gradient convention they share.

The JAX package has no such file: its ``Solver(mesh=...)`` runs one GSPMD
program over the global batch, and XLA inserts the cross-device sums of
the BatchNorm statistics, the losses' masked means and the copy-paste
pool where the program needs them. Here each of ``W`` ranks of a process
group holds the contiguous rows ``[r * B / W, (r + 1) * B / W)`` of a
global batch of B rows (the JAX loader's ``item_slice``), and the code
that reduces over the batch asks a :class:`BatchShard` for the global
value:

  * :meth:`BatchShard.sum` is a differentiable all-reduce
    (``torch.distributed.nn.functional.all_reduce``); every quantity that
    reduces over batch rows (a BatchNorm's batch sums, a loss's numerator
    and denominator) goes through it, so every rank computes the whole
    global loss;
  * :meth:`BatchShard.cat` is a differentiable all-gather of the rows in
    rank order (the copy-paste pool, the caption token masks' ids);
  * :meth:`BatchShard.rows` draws a random tensor at the global shape and
    keeps this rank's rows, so that with the same generator seed every
    rank's draw is its rows of the one-process draw;
  * :meth:`BatchShard.average_gradients` all-reduces the gradients and
    divides them by W.

The gradient convention. The backward of an all-reduce sum is an
all-reduce sum of the incoming gradients, and that of an all-gather a
reduce-scatter sum. Every rank starts its backward from the same global
loss L, so the gradient that reaches a rank's parameters through its own
rows is W times their share of dL: a term computed as
``shard.sum(n) / shard.sum(d)`` sends dL/dn = 1/D from each of the W
ranks, and the all-reduce adds them. Averaging the gradients over the
ranks (W ranks x 1/W) then gives the one-process gradient of L on the
global batch. Summing them instead, or scaling the loss, would give W
times that. A term left rank-local (no ``shard.sum``) would come out as
the mean of the ranks' terms, which is the global term only where every
rank holds an equal share of its denominator; so every term is global.

:data:`LOCAL` is the one-process shard (no group, one rank): each method
is then the identity or the one-process expression itself, so a run
without a process group computes exactly what it computed before data
parallel existed. A shard over a group of one rank still calls the
collectives.
"""

from __future__ import annotations

import torch


class BatchShard:
    """This process's rows of a global batch: rank ``rank`` of the
    ``world`` ranks of ``group`` (the default process group when built
    with :meth:`of_group`), holding rows ``[rank * n, (rank + 1) * n)``
    of each batch-major tensor of global leading dimension ``world * n``.
    Every rank calls each method in the same order."""

    def __init__(self, group=None, rank: int = 0, world: int = 1,
                 *, distributed: bool = False):
        self.group = group
        self.rank = rank
        self.world = world
        self.distributed = distributed

    @classmethod
    def of_group(cls, group=None) -> "BatchShard":
        """The shard of this process in ``group`` (the default group when
        None), which must be initialised."""
        import torch.distributed as dist

        return cls(group, dist.get_rank(group), dist.get_world_size(group),
                   distributed=True)

    def __repr__(self) -> str:
        return (f"BatchShard(rank={self.rank}, world={self.world}, "
                f"distributed={self.distributed})")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``x`` over the ranks, differentiable."""
        if not self.distributed:
            return x
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x, group=self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every entry of ``x`` on every rank (``x.mean()``
        over the global batch: every rank holds as many entries)."""
        if not self.distributed:
            return x.mean()
        return self.sum(x.sum()) / (x.numel() * self.world)

    def ratio(self, num: torch.Tensor, den: torch.Tensor,
              eps: float = 0.0) -> torch.Tensor:
        """sum(num) / (sum(den) + eps) over the ranks for scalars ``num``
        and ``den`` (one all-reduce for both; the gradient flows through
        both)."""
        if not self.distributed:
            return num / (den + eps)
        s = self.sum(torch.stack([num, den.to(num.dtype)]))
        return s[0] / (s[1] + eps)

    def cat(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along dim 0 in rank order (the
        global batch's rows), differentiable (under no_grad a plain
        all-gather)."""
        if not self.distributed:
            return x
        return _AllGather.apply(x, self)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch-major tensor."""
        if not self.distributed:
            return x
        n = x.shape[0] // self.world
        return x.narrow(0, self.rank * n, n)

    def rows(self, draw, shape) -> torch.Tensor:
        """``draw(global_shape)``, a random tensor of the global batch's
        shape (the leading dimension times W), and this rank's rows of
        it."""
        shape = tuple(shape)
        return self.own(draw((shape[0] * self.world,) + shape[1:]))

    @torch.no_grad()
    def average_gradients(self, params) -> None:
        """Replace each parameter's ``.grad`` by its mean over the ranks,
        one all-reduce a dtype. A parameter without a gradient takes part
        as zeros (the optimizer treats a missing gradient as zero, as
        optax does) and leaves with the mean."""
        if not self.distributed:
            return
        import torch.distributed as dist

        by_dtype: dict = {}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_dtype.setdefault(p.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.world)
            means = flat.split([g.numel() for g in grads])
            # one multi-tensor copy, not a launch a parameter
            torch._foreach_copy_(grads, [m.view_as(g)
                                         for m, g in zip(means, grads)])


class _AllGather(torch.autograd.Function):
    """The ranks' ``x`` concatenated in rank order; the backward sums the
    incoming gradient over the ranks and keeps this rank's rows (the
    reduce-scatter of the convention). ``torch.distributed.nn``'s
    all-gather has no gloo backward over a subgroup (its all-to-all
    scatters from group ranks as if they were global ones), which the data
    group of a tensor-parallel grid is."""

    @staticmethod
    def forward(ctx, x, shard):
        import torch.distributed as dist

        ctx.shard = shard
        pieces = [torch.empty_like(x) for _ in range(shard.world)]
        dist.all_gather(pieces, x.contiguous(), group=shard.group)
        return torch.cat(pieces)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        shard = ctx.shard
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=shard.group)
        n = grad.shape[0] // shard.world
        return grad.narrow(0, shard.rank * n, n), None


LOCAL = BatchShard()
"""The one-process shard: no group, one rank; every method the identity
or the one-process expression."""
