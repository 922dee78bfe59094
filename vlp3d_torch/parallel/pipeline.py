"""Pipeline parallelism (GPipe microbatching) over the BERT text layers.

Counterpart of ``vlp3d/parallel/pipeline.py``. Stage ``s`` of a pipe
group of S ranks holds the text layers ``[s * L / S, (s + 1) * L / S)``
(JAX's ``P('pipe')`` slices of the stacked layers; a stage that builds
only its layers holds only their memory) and microbatches flow from
stage to stage by hand point-to-point messages (``dist.isend`` /
``dist.irecv``, which gloo and NCCL both have) where JAX ``ppermute``\\ s
them. The pipe group is the second axis of a :func:`~vlp3d_torch.parallel.
tensor_parallel.make_grid` grid (rank ``d * S + s``), whose first axis is
the data group: each data rank runs its rows of every microbatch, as JAX
shards the microbatch over its data axis.

Schedule: GPipe. Every stage runs the forwards of the M microbatches in
order (stage 0 from the embeddings, the others from what the stage
before sent), then, in the backward, the M backwards in reverse order,
each stage receiving its output gradient from the stage after it and
sending its input gradient to the stage before. The bubble is (S - 1) /
(M + S - 1) of a schedule, as in JAX. The whole schedule is one
:class:`torch.autograd.Function` (:class:`_Pipeline`), whose forward
sends and receives activations and whose backward receives and sends
their gradients, in one fixed order on every stage (NCCL matches the
messages between two ranks in order). Nothing in ``torch.distributed.nn``
differentiates a send or a receive.

The output is replicated on every stage (JAX's final ``psum``): the last
stage broadcasts it over the pipe group. Every stage then computes the
same loss from it, so the backward takes the output gradient of the last
stage only, which is the whole gradient, and the other stages' copies
are not added to it (a sum would be S times the truth, as with TP's
operators). The embeddings run replicated on every stage outside the
pipeline; their input gradient reaches stage 0 only. With a data group
the output is gathered over it under the data axis's gradient convention
(``reduce.py``): every rank's loss is the global one, and the data group
averages the gradients.

A stage runs its layers as they are: in training mode each microbatch
draws its own dropout masks, so a pipelined training forward is not the
sequential one draw for draw.
"""

from __future__ import annotations

import torch

from vlp3d_torch.parallel.reduce import LOCAL, BatchShard
from vlp3d_torch.parallel.tensor_parallel import ModelGroup

PIPE_AXIS = "pipe"


def stage_range(num_layers: int, stage: int, n_stages: int) -> tuple:
    """The layers [lo, hi) of stage ``stage`` of ``n_stages``."""
    if num_layers % n_stages:
        raise ValueError(
            f"{num_layers} layers not divisible by {n_stages} stages")
    n = num_layers // n_stages
    return stage * n, (stage + 1) * n


def _global(pipe: ModelGroup, stage: int) -> int:
    import torch.distributed as dist

    return dist.get_global_rank(pipe.group, stage)


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of one stage: forward (M microbatches in
    order, activations received and sent) and backward (in reverse
    order, gradients received and sent). ``xs`` (M, mb, seq, hidden) is
    stage 0's input; the output (M, mb, seq, hidden) is the last stage's,
    broadcast to every stage."""

    @staticmethod
    def forward(ctx, pipe, layers, masks, build, xs, *params):
        import torch.distributed as dist

        s, n = pipe.rank, pipe.world
        ctx.pipe, ctx.params = pipe, params
        ins, outs, sends = [], [], []
        with torch.set_grad_enabled(build):
            for j in range(xs.shape[0]):
                if s == 0:
                    h = xs[j].detach()
                else:
                    h = torch.empty_like(xs[j])
                    dist.irecv(h, src=_global(pipe, s - 1),
                               group=pipe.group).wait()
                if build:
                    h.requires_grad_(True)
                y = h
                for layer in layers:
                    y = layer(y, masks[j])
                if s < n - 1:
                    sends.append(dist.isend(y.detach().contiguous(),
                                            dst=_global(pipe, s + 1),
                                            group=pipe.group))
                ins.append(h)
                outs.append(y)
        for w in sends:
            w.wait()
        out = (torch.stack([y.detach() for y in outs]) if s == n - 1
               else torch.empty_like(xs))
        dist.broadcast(out, src=_global(pipe, n - 1), group=pipe.group)
        ctx.ins, ctx.outs = ins, outs
        return out

    @staticmethod
    def backward(ctx, grad_out):
        import torch.distributed as dist

        pipe, params = ctx.pipe, ctx.params
        s, n = pipe.rank, pipe.world
        live = [p for p in params if p.requires_grad]
        acc = [torch.zeros_like(p) for p in live]
        gx = torch.zeros_like(grad_out) if s == 0 else None
        sends = []
        for j in reversed(range(len(ctx.outs))):
            if s == n - 1:
                g = grad_out[j].contiguous()
            else:
                g = torch.empty_like(grad_out[j])
                dist.irecv(g, src=_global(pipe, s + 1),
                           group=pipe.group).wait()
            grads = torch.autograd.grad(ctx.outs[j], [ctx.ins[j]] + live, g,
                                        allow_unused=True)
            if s > 0:
                sends.append(dist.isend(grads[0].contiguous(),
                                        dst=_global(pipe, s - 1),
                                        group=pipe.group))
            else:
                gx[j] = grads[0]
            for a, gp in zip(acc, grads[1:]):
                if gp is not None:
                    a.add_(gp)
        for w in sends:
            w.wait()
        it = iter(acc)
        param_grads = [next(it) if p.requires_grad else None for p in params]
        ctx.ins = ctx.outs = None
        return (None, None, None, None, gx, *param_grads)


def build_pipeline(pipe: ModelGroup | None, layers, num_layers: int,
                   num_microbatches: int, data: BatchShard = LOCAL):
    """``run(x, mask) -> hidden``: the pipelined text layers of this
    stage (``layers``, the ``num_layers / S`` layers it holds, in order)
    over ``pipe`` with ``num_microbatches`` microbatches. ``x`` (B, seq,
    hidden) is the embedded batch and ``mask`` (B, seq) the attention mask,
    the same on every rank; the result, (B, seq, hidden) after every
    layer, is replicated on every rank. B must divide into the
    microbatches, and a microbatch over ``data``'s ranks."""
    if pipe is None or pipe.group is None:
        raise ValueError(f"no '{PIPE_AXIS}' group (axis) to pipeline over")
    stage_range(num_layers, pipe.rank, pipe.world)
    layers = list(layers)
    if len(layers) != num_layers // pipe.world:
        raise ValueError(f"stage {pipe.rank} holds {len(layers)} layers, "
                         f"not {num_layers // pipe.world}")
    m = num_microbatches
    params = [p for layer in layers for p in layer.parameters()]

    def run(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, seq, hidden = x.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        mb = b // m
        if mb % data.world:
            raise ValueError(
                f"microbatch size {mb} (batch {b} / {m} microbatches) not "
                f"divisible by the data-axis size {data.world}")
        k = mb // data.world
        xs = x.reshape(m, mb, seq, hidden).narrow(1, data.rank * k, k)
        masks = mask.to(x.dtype).reshape(m, mb, seq).narrow(
            1, data.rank * k, k)
        build = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params))
        out = _Pipeline.apply(pipe, layers, masks, build, xs.contiguous(),
                              *params)
        if data.distributed:
            # every data rank's rows of each microbatch, in rank order
            out = data.cat(out.transpose(0, 1).contiguous()).transpose(0, 1)
        return out.reshape(b, seq, hidden)

    return run


def pipeline_text_encoder(pipe: ModelGroup | None, encoder, input_ids,
                          attention_mask, *, num_microbatches: int = 4,
                          data: BatchShard = LOCAL) -> torch.Tensor:
    """The embeddings, replicated, then the pipelined text layers: the
    pipelined form of ``BertTextEncoder(input_ids, attention_mask)``
    (text mode). ``encoder`` is a :class:`~vlp3d_torch.models.bert.
    BertTextEncoder`; this stage runs its slice of the encoder's layers."""
    if pipe is None or pipe.group is None:
        raise ValueError(f"no '{PIPE_AXIS}' group (axis) to pipeline over")
    all_layers = list(encoder.bert.encoder.layer)
    lo, hi = stage_range(len(all_layers), pipe.rank, pipe.world)
    x = encoder.bert.embeddings(input_ids)
    run = build_pipeline(pipe, all_layers[lo:hi], len(all_layers),
                         num_microbatches, data)
    return run(x, attention_mask.float())
