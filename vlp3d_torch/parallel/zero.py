"""ZeRO-1: the optimizer's moments sharded over the data group.

Counterpart of ``vlp3d/parallel/zero.py``. JAX annotates each moment
buffer with a PartitionSpec that splits one of its dimensions over the
data axis and lets GSPMD partition the elementwise Adam update; here
:class:`ShardedAdam` does it by hand over a ``torch.distributed`` data
group (stage 1: parameters and gradients stay whole on every rank).

Layout (JAX's ``_moment_spec``). A moment keeps its parameter's tensor
parallel split (:mod:`vlp3d_torch.parallel.tensor_parallel`), then one
more dimension is split over the data group: the first, in the JAX
layout's order of dimensions, that is not the TP dimension and whose
whole size is at least the data size and divisible by it, on parameters
of at least :data:`MIN_SHARD_ELEMS` elements (whole sizes). A linear or
k=1 conv weight is (out, in[, 1, 1]) here and (in, out) in flax, so its
dimensions are taken in the order (in, out); the set-abstraction
modules' first-layer weights join JAX's ``first_xyz`` and ``first_feat``
kernels into one tensor, which takes one split as a whole (ROADMAP.md
C15). Smaller
parameters keep whole moments on every rank, as in JAX. Rank ``r`` of the
data group holds part ``r`` of the split dimension.

Update. Adam's update is elementwise (value clip, coupled L2, moments,
bias correction, decoupled decay: ``train/optimizer.py``), so each rank
runs the port's update on its slice of each parameter, with its slice of
the averaged gradient and of the moments, and is bit-equal there to the
one-process update on the same gradient; one all-gather a dtype over the
data group then rebuilds the whole parameters on every rank. The
gradients are still all-reduced whole (``BatchShard.average_gradients``);
a reduce-scatter is later work.

State. :meth:`ShardedAdam.state_dict` gathers the whole moments (a
collective: every rank calls it; only rank 0 writes the checkpoint), so
a checkpoint has the one-process layout (JAX's ``host_global``) and
resumes with or without ZeRO-1, at any world size and ``tp``;
:meth:`ShardedAdam.load_state_dict` keeps this rank's slices. The
``grad_accum`` window's accumulated gradients and the step count are
kept as :class:`~vlp3d_torch.train.optimizer.Adam` keeps them (a TP part
gathered whole). With no process group the data shard is
:data:`~vlp3d_torch.parallel.reduce.LOCAL`, a shard of one: the update
runs on whole tensors with no collective.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vlp3d_torch.parallel.reduce import LOCAL, BatchShard
from vlp3d_torch.train.optimizer import Adam

# moments of parameters smaller than this stay whole on every rank
# (vlp3d/parallel/zero.py:46)
MIN_SHARD_ELEMS = 1 << 14


def jax_order(module: nn.Module, name: str, p: torch.Tensor) -> list:
    """``p``'s dimensions in the order of the JAX leaf's: (in, out) for a
    linear or k=1 conv weight (out, in[, 1, 1]), else as they are."""
    from vlp3d_torch.models.layers import PointwiseConv
    from vlp3d_torch.parallel.tensor_parallel import _SplitLinear

    if name == "weight" and isinstance(
            module, (nn.Linear, PointwiseConv, _SplitLinear)):
        return [1, 0] + list(range(2, p.dim()))
    return list(range(p.dim()))


def moment_dim(shape, order, tp_dim: int | None, n_data: int):
    """The dimension of a moment that the data group splits (None: the
    moment stays whole). ``shape`` is the whole parameter's."""
    if math.prod(shape) < MIN_SHARD_ELEMS:
        return None
    for d in order:
        if d != tp_dim and shape[d] >= n_data and shape[d] % n_data == 0:
            return d
    return None


def moment_layout(model: nn.Module, n_data: int, n_model: int = 1) -> dict:
    """{trained parameter name: (TP dimension, data dimension)} of a whole
    (unsplit) model on a grid of ``n_data`` x ``n_model`` ranks: the
    layout :class:`ShardedAdam` gives the moments, without a process
    group."""
    from vlp3d_torch.parallel.tensor_parallel import param_dims

    tp = param_dims(model, n_model) if n_model > 1 else {}
    out = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if not p.requires_grad:
                continue
            tp_dim = tp.get(full)
            out[full] = (tp_dim, moment_dim(
                tuple(p.shape), jax_order(module, pname, p), tp_dim, n_data))
    return out


def _whole_shape(p: torch.Tensor) -> tuple:
    split = getattr(p, "tp_split", None)
    shape = list(p.shape)
    if split is not None:
        shape[split.dim] *= split.world
    return tuple(shape)


class ShardedAdam(Adam):
    """``adam``'s optimizer (same groups, recipe and schedule) with its
    moments split as the module docstring says over ``data``'s group, and
    gathered whole across the TP split in its state dict. ``model`` holds
    ``adam``'s parameters (already split by
    :func:`~vlp3d_torch.parallel.tensor_parallel.shard_model` where TP
    runs). ``data`` :data:`~vlp3d_torch.parallel.reduce.LOCAL` keeps whole
    moments of each rank's part: the optimizer of a TP run without
    ZeRO-1."""

    def __init__(self, adam: Adam, model: nn.Module,
                 data: BatchShard = LOCAL):
        groups = [{k: v for k, v in g.items() if k != "lr"}
                  for g in adam.param_groups]
        super().__init__(
            groups, lr_schedule=adam.lr_schedule,
            steps_per_epoch=adam.steps_per_epoch,
            weight_decay=adam.defaults["weight_decay"],
            amsgrad=adam.amsgrad, decoupled=adam.decoupled,
            clip_grad_value=adam.clip_grad_value,
            grad_accum=adam.grad_accum, b1=adam.b1, b2=adam.b2, eps=adam.eps)
        self.step_count = adam.step_count
        self.data = data
        orders = {id(p): jax_order(module, name, p)
                  for module in model.modules()
                  for name, p in module.named_parameters(recurse=False)}
        self.data_dim = {}
        for p in self.params():
            split = getattr(p, "tp_split", None)
            self.data_dim[p] = (moment_dim(
                _whole_shape(p), orders[id(p)],
                None if split is None else split.dim, data.world))

    def params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    def _slice(self, p, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (``p``'s part or a tensor shaped like
        it)."""
        dim = self.data_dim[p]
        if dim is None:
            return t
        n = t.shape[dim] // self.data.world
        return t.narrow(dim, self.data.rank * n, n)

    @torch.no_grad()
    def step(self, closure=None):
        count = self.step_count + 1
        for group in self.param_groups:
            lr = group["lr"] = self.group_lr(group)
            params = group["params"]
            if not params:
                continue
            views = [self._slice(p, p) for p in params]
            grads = [torch.zeros_like(v) if p.grad is None
                     else self._slice(p, p.grad)
                     for p, v in zip(params, views)]
            self.update(views, grads,
                        [self.moments(p, v) for p, v in zip(params, views)],
                        lr, group["weight_decay"], count)
        self.step_count = count
        self._gather_params()

    def _gather_params(self) -> None:
        """Every rank's updated slices into every rank's parameters: one
        all-gather a dtype over the data group."""
        if not self.data.distributed:
            return
        import torch.distributed as dist

        by_dtype: dict = {}
        for p in self.params():
            if self.data_dim[p] is not None:
                by_dtype.setdefault(p.dtype, []).append(p)
        world, rank = self.data.world, self.data.rank
        for params in by_dtype.values():
            mine = [self._slice(p, p) for p in params]
            flat = torch.cat([v.reshape(-1) for v in mine])
            flats = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(flats, flat, group=self.data.group)
            sizes = [v.numel() for v in mine]
            dst, src = [], []
            for r in range(world):
                if r == rank:
                    continue
                for p, v, piece in zip(params, mine, flats[r].split(sizes)):
                    dim = self.data_dim[p]
                    n = v.shape[dim]
                    dst.append(p.data.narrow(dim, r * n, n))
                    src.append(piece.view(v.shape))
            if dst:
                torch._foreach_copy_(dst, src)

    def _whole(self, p, t: torch.Tensor) -> torch.Tensor:
        """The whole-parameter form of this rank's moment slice ``t``
        (collectives over the data group, then the model group)."""
        dim = self.data_dim[p]
        if dim is not None and self.data.distributed:
            import torch.distributed as dist

            pieces = [torch.empty_like(t) for _ in range(self.data.world)]
            dist.all_gather(pieces, t.contiguous(), group=self.data.group)
            t = torch.cat(pieces, dim=dim)
        split = getattr(p, "tp_split", None)
        return t if split is None else split.gather(t)

    def _part(self, p, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole-parameter tensor ``t``."""
        split = getattr(p, "tp_split", None)
        if split is not None:
            t = split.part(t)
        return self._slice(p, t).clone()

    def state_dict(self):
        """Adam's state dict with every moment whole (the one-process
        layout); a collective, so every rank calls it."""
        sd = super().state_dict()
        params = self.params()
        sd["state"] = {
            i: {k: self._whole(params[i], v) if torch.is_tensor(v)
                and v.dim() > 0 else v for k, v in st.items()}
            for i, st in sd["state"].items()}
        if "accumulated" in sd:
            sd["accumulated"] = [
                None if g is None else self._tp_whole(p, g)
                for p, g in zip(params, sd["accumulated"])]
        return sd

    @staticmethod
    def _tp_whole(p, g):
        split = getattr(p, "tp_split", None)
        return g if split is None else split.gather(g.to(p.device)).cpu()

    def load_state_dict(self, state_dict):
        """Load a one-process-layout state dict, keeping this rank's
        slices."""
        state_dict = dict(state_dict)
        params = self.params()
        state_dict["state"] = {
            i: {k: self._part(params[int(i)], v.to(params[int(i)].device))
                if torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in st.items()}
            for i, st in state_dict["state"].items()}
        if state_dict.get("accumulated") is not None:
            state_dict["accumulated"] = [
                None if g is None else (
                    g if getattr(p, "tp_split", None) is None
                    else p.tp_split.part(g).clone())
                for p, g in zip(params, state_dict["accumulated"])]
        super().load_state_dict(state_dict)


def optimizer_state_bytes(opt: torch.optim.Optimizer, device=None) -> int:
    """Bytes of optimizer state (the moments) this rank holds on
    ``device`` (every device when None): the measured ZeRO-1 saving
    (``opt_state_bytes_per_device``)."""
    device = None if device is None else torch.device(device)
    total = 0
    for st in opt.state.values():
        for t in st.values():
            if torch.is_tensor(t) and (
                    device is None or t.device.type == device.type and (
                        device.index is None
                        or t.device.index == device.index)):
                total += t.numel() * t.element_size()
    return total
