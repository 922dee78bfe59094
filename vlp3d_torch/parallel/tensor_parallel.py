"""Tensor parallelism over a (data, model) grid of ranks.

Counterpart of ``vlp3d/parallel/tensor_parallel.py``. The JAX package
annotates weight shardings on a 2-D (data, model) mesh and GSPMD inserts
the collectives; here each rank is one process, a mesh axis is a
``torch.distributed`` subgroup, and the collectives are written out, in
Megatron's pattern: a column-parallel first linear (output features
split over the model group, its bias with them) and a row-parallel second
linear (input features split, its partial products all-reduced over the
model group, the bias added once after the sum). :data:`TP_RULES` names
the same layers as the JAX rules, over the port's module names:

  * the BERT text layers: ``attention.self.{query,key,value}`` and
    ``intermediate.dense`` column-parallel, ``attention.output.dense``
    and ``output.dense`` row-parallel;
  * the caption and MLM decoders' feed-forwards: ``w_1`` column, ``w_2``
    row;
  * the match module's cross-attention feed-forwards: ``ffn.linear1``
    column, ``ffn.linear2`` row.

Everything else is replicated. A dimension that the model group's size
does not divide stays replicated (JAX's ``_spec_for`` fallback). A BERT
layer's attention is split by whole heads: where the heads do not divide
over the group, its q/k/v and attention output stay replicated, while
JAX splits the 768 columns anyway and lets GSPMD split the heads
(ROADMAP.md C14).

Layout. Ranks form the grid as JAX's ``reshape(n_data, n_model)``: rank
``d * n_model + m`` is row ``d`` of the data axis and column ``m`` of the
model axis. :func:`make_grid` builds both subgroups; a rank's
:class:`~vlp3d_torch.parallel.reduce.BatchShard` is over its data group,
so BatchNorm, the losses, the dropout rows and the gradient average run
over the data group alone, and every rank of a model group holds the same
rows of the batch.

The gradient convention, beside the data axis's (``reduce.py``). Every
rank of a model group computes the same loss from the same replicated
activations. A column-parallel layer's input therefore goes through
:class:`_CopyToModel` (the identity forward; the backward all-reduces the
input gradient, the sum of the column shards' contributions) and a
row-parallel layer's output through :class:`_ReduceFromModel` (an
all-reduce forward; the identity backward: each rank's copy of the
output gradient is already the whole gradient). A plain differentiable
all-reduce in their place would sum the W identical gradients in the
backward, W times the truth. The gradients of a TP-sharded parameter are
then this rank's columns of the one-process gradient, and those of a
replicated parameter are equal on every rank of the model group; both are
averaged over the data group only.

Dropout on split heads or columns (:class:`SliceDropout`) draws its mask
at the whole layer's shape (and the global batch's rows) and keeps this
rank's heads or columns, so a TP step takes the one-process step's masks
from the same generator.

State dicts. A split layer's ``state_dict`` gathers the whole weight over
the model group (a collective: every rank of the group asks for it) and
its ``load_state_dict`` keeps this rank's part of a whole one, so a
checkpoint is the one-process layout and loads ``strict=True`` at any
``tp``. Each split parameter carries its :class:`Split` as ``tp_split``
for the optimizer (:mod:`vlp3d_torch.parallel.zero`).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.models.layers import Dropout
from vlp3d_torch.parallel.reduce import LOCAL, BatchShard

# (module name regex, kind). First match wins; no match -> replicated.
TP_RULES: list[tuple[str, str]] = [
    # BERT text layers: column-parallel QKV + intermediate, row outputs
    (r".*\.encoder\.layer\.\d+\.attention\.self\.(query|key|value)$",
     "column"),
    (r".*\.encoder\.layer\.\d+\.intermediate\.dense$", "column"),
    (r".*\.encoder\.layer\.\d+\.attention\.output\.dense$", "row"),
    (r".*\.encoder\.layer\.\d+\.output\.dense$", "row"),
    # caption / MLM decoder feed-forwards
    (r".*\.decoder\.layers\.\d+\.feed_forward\.w_1$", "column"),
    (r".*\.decoder\.layers\.\d+\.feed_forward\.w_2$", "row"),
    # match cross-attention feed-forwards
    (r".*cross_attn\.\d+\.ffn\.linear1$", "column"),
    (r".*cross_attn\.\d+\.ffn\.linear2$", "row"),
]

# collective calls of the two operators, forward and backward (read by
# chip_smoke.py to show that a TP step ran every collective)
calls = {"copy_backward": 0, "reduce_forward": 0, "gather": 0}


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's place on the model axis: rank ``rank`` of the
    ``world`` ranks of ``group``."""

    group: object = None
    rank: int = 0
    world: int = 1


@dataclasses.dataclass(frozen=True)
class Split:
    """How a rank holds a tensor of the model: its part ``rank`` of
    ``world`` equal parts along ``dim``, over ``group``."""

    dim: int
    rank: int
    world: int
    group: object

    def part(self, full: torch.Tensor) -> torch.Tensor:
        n = full.shape[self.dim] // self.world
        return full.narrow(self.dim, self.rank * n, n)

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's part (a collective)."""
        import torch.distributed as dist

        calls["gather"] += 1
        pieces = [torch.empty_like(part) for _ in range(self.world)]
        dist.all_gather(pieces, part.contiguous(), group=self.group)
        return torch.cat(pieces, dim=self.dim)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A rank's data shard and model group on a (data, model) grid."""

    data: BatchShard
    model: ModelGroup


def make_grid(n_model: int) -> Grid:
    """The (data, model) grid of the default process group, rank ``d *
    n_model + m`` at (d, m); every rank builds every subgroup, in one
    order. Raises when ``n_model`` does not divide the world size. With no
    process group: the one-process grid, where ``n_model`` must be 1."""
    from vlp3d_torch.parallel import distributed as dist_utils

    world = dist_utils.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(
            f"tensor parallel over {n_model} ranks needs a world size that "
            f"{n_model} divides; the world size is {world} (start dp x "
            f"{n_model} processes)")
    if not dist_utils.initialized():
        return Grid(LOCAL, ModelGroup())
    import torch.distributed as dist

    rank = dist.get_rank()
    n_data = world // n_model
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Grid(BatchShard(data_group, rank // n_model, n_data,
                           distributed=True),
                ModelGroup(model_group, rank % n_model, n_model))


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the
    model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        calls["copy_backward"] += 1
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        calls["reduce_forward"] += 1
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitLinear(nn.Module):
    """A linear layer of which this rank holds the part ``split`` of the
    weight (and of the bias for a column split); the state dict holds the
    whole layer."""

    def __init__(self, linear: nn.Linear, split: Split, bias_split: bool):
        super().__init__()
        self.split = split
        self.weight = nn.Parameter(split.part(linear.weight.detach()).clone(),
                                   requires_grad=linear.weight.requires_grad)
        self.weight.tp_split = split
        self.bias = None
        if linear.bias is not None:
            b = linear.bias.detach()
            if bias_split:
                b = split.part(b)
            self.bias = nn.Parameter(b.clone(),
                                     requires_grad=linear.bias.requires_grad)
            if bias_split:
                self.bias.tp_split = split

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name, p in self._parameters.items():
            if p is None:
                continue
            split = getattr(p, "tp_split", None)
            t = p if keep_vars else p.detach()
            destination[prefix + name] = (t if split is None
                                          else split.gather(p.detach()))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, p in self._parameters.items():
            split = getattr(p, "tp_split", None)
            full = state_dict.get(prefix + name)
            if (split is not None and torch.is_tensor(full)
                    and full.dim() == p.dim() and full.shape[split.dim]
                    == p.shape[split.dim] * split.world):
                state_dict[prefix + name] = split.part(full)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class ColumnParallelLinear(_SplitLinear):
    """Output features split over the model group (bias with them)."""

    def __init__(self, linear: nn.Linear, model: ModelGroup):
        super().__init__(linear, Split(0, model.rank, model.world,
                                       model.group), bias_split=True)

    def forward(self, x):
        return F.linear(_CopyToModel.apply(x, self.split.group),
                        self.weight, self.bias)


class RowParallelLinear(_SplitLinear):
    """Input features split over the model group; the partial products
    are summed over the group, then the whole bias is added once."""

    def __init__(self, linear: nn.Linear, model: ModelGroup):
        super().__init__(linear, Split(1, model.rank, model.world,
                                       model.group), bias_split=False)

    def forward(self, x):
        y = _ReduceFromModel.apply(F.linear(x, self.weight),
                                   self.split.group)
        return y if self.bias is None else y + self.bias


class SliceDropout(Dropout):
    """The :class:`~vlp3d_torch.models.layers.Dropout` of a layer whose
    dimension ``dim`` is split over the model group: the mask is drawn at
    the whole dimension (and the global batch's rows) and this rank keeps
    its part, so every rank's mask is its part of the one-process mask."""

    def __init__(self, dropout: Dropout, dim: int, model: ModelGroup):
        super().__init__(dropout.p)
        self.generator = dropout.generator
        self.shard = dropout.shard
        self.dim = dim
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        dim = self.dim % x.dim()
        shape = list(x.shape)
        shape[dim] *= self.model.world
        mask = self.shard.rows(
            lambda s: torch.rand(s, device=x.device, dtype=x.dtype,
                                 generator=self.generator), shape)
        n = x.shape[dim]
        mask = mask.narrow(dim, self.model.rank * n, n) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def tp_kind(name: str) -> str | None:
    """"column", "row" or None (replicated) for a module name."""
    for pattern, kind in TP_RULES:
        if re.match(pattern, name):
            return kind
    return None


def _divides(linear: nn.Linear, kind: str, n_model: int) -> bool:
    dim = 0 if kind == "column" else 1
    return linear.weight.shape[dim] % n_model == 0


def _bert_heads_divide(model: nn.Module, name: str, n_model: int) -> bool:
    """Whether the BERT layer owning attention module ``name`` splits its
    heads evenly over ``n_model`` ranks (True for any other module)."""
    m = re.match(r"(.*\.encoder\.layer\.\d+)\.attention\.", name)
    if not m:
        return True
    layer = model.get_submodule(m.group(1))
    return layer.heads % n_model == 0


def _selected(model: nn.Module, n_model: int):
    """(name, module, kind) of every linear layer that :data:`TP_RULES`
    selects and ``n_model`` ranks can split."""
    for name, module in list(model.named_modules()):
        kind = tp_kind(name)
        if (kind is not None and isinstance(module, nn.Linear)
                and _divides(module, kind, n_model)
                and _bert_heads_divide(model, name, n_model)):
            yield name, module, kind


def param_dims(model: nn.Module, n_model: int) -> dict:
    """{parameter name: split dimension} of the parameters that
    :func:`shard_model` would split over ``n_model`` ranks, read from a
    whole model (no process group): a column layer's weight and bias
    along their output dimension (0), a row layer's weight along its
    input dimension (1)."""
    out = {}
    for name, _, kind in _selected(model, n_model):
        if kind == "column":
            out[f"{name}.weight"] = out[f"{name}.bias"] = 0
        else:
            out[f"{name}.weight"] = 1
    return out


def shard_model(model: nn.Module, model_group: ModelGroup) -> list:
    """Replace every linear layer that :data:`TP_RULES` selects by its
    column- or row-parallel form over ``model_group``, and the dropout
    between a column and a row layer by its :class:`SliceDropout`, in
    place; returns the names of the split layers. Call it after every
    rank holds the same whole model (``broadcast_module``) and before the
    optimizer is built. A group of one rank splits nothing but runs every
    collective."""
    split = []
    for name, module, kind in list(_selected(model, model_group.world)):
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        cls = ColumnParallelLinear if kind == "column" else RowParallelLinear
        setattr(parent, child, cls(module, model_group))
        split.append(name)
    for name in split:
        _slice_dropouts(model, name, model_group)
    return split


def _slice_dropouts(model: nn.Module, name: str, model_group) -> None:
    """The dropout that acts on a split layer's split output: the BERT
    attention probabilities (split by heads, dim 1) after a split query,
    and a feed-forward's inner dropout after its split first linear."""
    m = re.match(r"(.*\.encoder\.layer\.\d+)\.attention\.self\.query$", name)
    if m:
        att = model.get_submodule(m.group(1) + ".attention")
        if isinstance(att.dropout, Dropout):
            att.dropout = SliceDropout(att.dropout, 1, model_group)
        return
    m = re.match(r"(.*)\.(w_1|linear1)$", name)
    if m:
        ffn = model.get_submodule(m.group(1))
        if isinstance(ffn.dropout, Dropout):
            ffn.dropout = SliceDropout(ffn.dropout, -1, model_group)


def full_tensor(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's part, split as
    ``param`` is (``t`` itself for a replicated parameter); a collective
    for a split one."""
    split = getattr(param, "tp_split", None)
    return t if split is None else split.gather(t)
