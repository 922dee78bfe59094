"""Shared building blocks: point MLPs, set abstraction, feature propagation.

Counterparts of ``PointMLP``, ``SAModule``, ``FPModule`` and ``PReLU`` in
``vlp3d/models/layers.py``, plus the port's :class:`BatchNorm` and
:class:`Dropout` (flax semantics, see each) and the captioner's
:class:`RefLayerNorm`. A module follows
``nn.Module.training``: BatchNorm then normalises with batch statistics
and updates its running ones, Dropout draws a mask, and the SA module
with ``leaf_inputs`` gathers raw rows. Activations are channels-last
(B, N, C). Parameter names follow the reference state dict
(``mlp_module.layer0.conv.weight``, ``layer0.bn.bn.running_mean``, ...):
a k=1 conv keeps the reference's (out, in, 1[, 1]) weight but runs as a
matmul on the channels-last tensor, never as ``nn.Conv*`` (which would
put cuDNN, and its TF32 default, on the path).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
)
from vlp3d_torch.ops.interpolate import interpolate_features
from vlp3d_torch.parallel.reduce import LOCAL


class PointwiseConv(nn.Module):
    """A k=1 Conv1d/Conv2d (``rank`` trailing unit dims) as a matmul over
    the last axis."""

    def __init__(self, cin: int, cout: int, *, rank: int = 1,
                 bias: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(
            torch.zeros((cout, cin) + (1,) * rank, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with torch's buffers and flax's
    arithmetic: (x - mean) * (rsqrt(var + eps) * weight) + bias.

    In training the statistics are the batch's over all leading axes, the
    variance biased and computed as max(E[x^2] - E[x]^2, 0), and the
    running statistics move as ra = (1 - momentum) * ra + momentum *
    batch, in place, with that same biased variance (flax stores it;
    ``torch.nn.BatchNorm`` would store the unbiased one). ``momentum`` is
    torch's convention: 0.1 is flax's 0.9. With ``track`` False (see
    :func:`frozen_statistics`) a training forward normalises with the
    batch's statistics and leaves the running ones alone.

    Under data parallel (``shard``, set by :func:`set_batch_shard`) the
    batch statistics are the global batch's: the sums of x and x^2 over
    this rank's rows go through one differentiable all-reduce, so every
    rank normalises with, and moves its running statistics by, the
    statistics of the whole batch (``torch.nn.SyncBatchNorm`` would
    store the unbiased variance, and takes no CPU tensors).
    """

    eps = 1e-5
    shard = LOCAL

    def __init__(self, c: int, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.momentum = 0.1
        self.track = True
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if self.shard.distributed:
                sums = self.shard.sum(torch.stack([x.sum(dims),
                                                   (x * x).sum(dims)]))
                count = x.numel() // x.shape[-1] * self.shard.world
                mean, mean_sq = sums[0] / count, sums[1] / count
            else:
                mean, mean_sq = x.mean(dims), (x * x).mean(dims)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if self.track:
                with torch.no_grad():
                    self.running_mean.lerp_(mean, self.momentum)
                    self.running_var.lerp_(var, self.momentum)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Every :class:`BatchNorm` under ``module`` leaves its running
    statistics alone while the context is open: a rematerialised block
    recomputes its training forward for the backward pass, and its
    statistics already moved once, in the step's forward."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.track for m in norms]
    for m in norms:
        m.track = False
    try:
        yield
    finally:
        for m, track in zip(norms, saved):
            m.track = track


class Dropout(nn.Module):
    """Inverted dropout as flax draws it: keep with probability 1 - p,
    scale the kept values by 1 / (1 - p); the identity at evaluation or
    p = 0. The mask comes from ``generator`` (an explicit
    ``torch.Generator`` on the input's device, set by
    :func:`set_dropout_generator`), or from the global generator when it
    is None. Under data parallel (``shard``) the mask is drawn at the
    global batch's shape and each rank keeps its rows (the input's
    leading axis is batch-major)."""

    shard = LOCAL

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = self.shard.rows(
            lambda shape: torch.rand(shape, device=x.device, dtype=x.dtype,
                                     generator=self.generator),
            x.shape) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Hand every :class:`Dropout` under ``module`` the generator its
    masks are drawn from."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_batch_shard(module: nn.Module, shard) -> None:
    """Hand every submodule of ``module`` that reduces or draws over the
    batch (those with a ``shard`` attribute: BatchNorm, Dropout, the
    proposal, match and contrast modules, JointNet) the
    :class:`~vlp3d_torch.parallel.reduce.BatchShard` of this rank;
    :data:`~vlp3d_torch.parallel.reduce.LOCAL` for one process."""
    for m in module.modules():
        if hasattr(m, "shard"):
            m.shard = shard


class PReLU(nn.Module):
    """Per-channel parametric ReLU (torch nn.PReLU(num_channels)), as the
    JAX module's ``PReLU(c)``. Where the reference declares a single
    slope (``nn.PReLU()``: the vote-weight predictor and the match
    module's lang-emb branch) its state dict holds a (1,) weight: that
    loads too, the one slope on every channel."""

    def __init__(self, c: int, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.full((c,), 0.25, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        w = state_dict.get(key)
        if w is not None and w.shape == (1,) and self.weight.shape != (1,):
            state_dict[key] = w.expand(self.weight.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class RefLayerNorm(nn.Module):
    """The annotated-transformer LayerNorm of the caption decoder
    (transformer_captioner.py:115-127; ``RefLayerNorm`` in
    ``vlp3d/models/layers.py``): ``a_2 * (x - mean) / (std + eps) + b_2``
    with std Bessel-corrected and eps = 1e-6 added to the std, not to the
    variance, so not ``torch.nn.LayerNorm``. The variance is the JAX
    module's ``var(x) * d / (d - 1)``."""

    eps = 1e-6

    def __init__(self, d: int, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.a_2 = nn.Parameter(torch.ones(d, device=device))
        self.b_2 = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True) * (d / (d - 1))
        return self.a_2 * (x - mean) / (var.sqrt() + self.eps) + self.b_2


class _BNHolder(nn.Module):
    """The reference's ``bn.bn`` nesting (pytorch_utils.py BatchNorm2d)."""

    def __init__(self, c: int, device):
        super().__init__()
        self.bn = BatchNorm(c, device=device)


class _SharedLayer(nn.Module):
    """k=1 Conv2d (no bias) + BN + ReLU: one SharedMLP layer."""

    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.conv = PointwiseConv(cin, cout, rank=2, bias=False, device=device)
        self.bn = _BNHolder(cout, device)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        if dtype is None:
            return F.relu(self.bn.bn(self.conv(x)))
        # flax's Dense(dtype) and BatchNorm(dtype): input and kernel cast,
        # the product in dtype; BatchNorm's statistics and normalisation in
        # float32, its output cast; the ReLU in dtype
        y = F.linear(x.to(dtype), self.conv.weight.flatten(1).to(dtype))
        return F.relu(self.bn.bn(y.float()).to(dtype))


class PointMLP(nn.Module):
    """Dense + BatchNorm + ReLU stack over the last axis (SharedMLP).

    ``dtype`` (None: the input's) is the JAX module's compute dtype: each
    layer's matmul and ReLU run in it (``torch.bfloat16`` for
    ``compute_dtype="bfloat16"``), BatchNorm in float32, and the stack's
    output is cast back to the input's dtype. Parameters and statistics
    stay float32. Explicit casts, not ``torch.autocast``, which would also
    change ops the JAX package keeps in float32."""

    def __init__(self, cin: int, channels: Sequence[int], *,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        for j, c in enumerate(channels):
            self.add_module(f"layer{j}", _SharedLayer(cin, c, device))
            cin = c

    def forward(self, x: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Layers [start:] of the stack."""
        in_dtype = x.dtype
        for layer in list(self.children())[start:]:
            x = layer(x, self.dtype)
        return x.to(in_dtype)


class SAModule(nn.Module):
    """Set abstraction (PointnetSAModuleVotes, pointnet2_modules.py:164-272):
    FPS -> ball query -> recentred (radius-normalised) grouping -> shared
    MLP -> max pool, with xyz used as features and divided by the radius
    (use_xyz, normalize_xyz: every caller's setting).

    The first layer is folded before the gather as the JAX module does:
    W [xyz_rel / r; f] = gather(W_feat f + W_xyz xyz / r) - W_xyz c / r, so
    only mlp[0] channels are gathered. With no feature channels W_feat is
    (mlp[0], 0) and contributes zeros.

    ``leaf_inputs`` says that xyz and features are raw inputs that need no
    gradient: in training the module then gathers the raw rows first and
    applies the first linear after, so the gather has no backward at all
    (the folded form would need a scatter-add over every gathered row just
    to reach the weight gradients). Evaluation keeps the folded form.

    The max pool is ``amax``, whose gradient is split evenly among tied
    maxima as ``jnp.max``'s is (padded neighbourhoods repeat a row, so
    ties are the rule).

    ``dtype`` is the compute dtype of layers 1 and up, as in the JAX
    module: the folded first layer and its BatchNorm stay float32, so the
    gather always moves float32 rows.
    """

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], in_channels: int, *,
                 leaf_inputs: bool = False, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.leaf_inputs = leaf_inputs
        self.mlp_module = PointMLP(3 + in_channels, mlp, dtype=dtype,
                                   device=device)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor):
        """xyz (B, N, 3), features (B, N, C), C may be 0.

        Returns (new_xyz (B, npoint, 3), new_features (B, npoint, mlp[-1]),
        inds (B, npoint) int32).
        """
        inds, new_xyz, idx = self.sample(xyz)
        return new_xyz, self.group(xyz, features, new_xyz, idx), inds

    def sample(self, xyz: torch.Tensor):
        """The block's point indices: FPS (inds (B, npoint) int32), the
        centres new_xyz (B, npoint, 3) and the ball query (idx (B, npoint,
        nsample) int32). None of them carries a gradient."""
        inds = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, inds)
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        return inds, new_xyz, idx

    def group(self, xyz: torch.Tensor, features: torch.Tensor,
              new_xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The neighbourhoods of :meth:`sample`'s indices through the
        shared MLP and the max pool -> (B, npoint, mlp[-1])."""
        scale = 1.0 / self.radius
        if self.leaf_inputs and self.training:
            src = torch.cat([xyz, features], dim=-1).detach()
            grouped = group_points(src, idx)  # (B, M, K, 3 + C)
            grouped[..., :3] = (grouped[..., :3]
                                - new_xyz[:, :, None, :]) * scale
            return self.group_precomputed(grouped)
        layers = list(self.mlp_module.children())
        w = layers[0].conv.weight.flatten(1)
        w_xyz, w_feat = w[:, :3], w[:, 3:]
        pre_all = F.linear(features, w_feat) + F.linear(xyz, w_xyz) * scale
        # the gather subtracts the centre term on its way out
        x = group_points(pre_all, idx, F.linear(new_xyz, w_xyz) * scale)
        x = F.relu(layers[0].bn.bn(x))
        return self.mlp_module(x, start=1).amax(dim=2)

    def group_precomputed(self, grouped: torch.Tensor) -> torch.Tensor:
        """The shared MLP and max pool of neighbourhoods grouped elsewhere
        (:meth:`group`'s training path on leaf inputs, the point-sharded
        front end): grouped (B, npoint, nsample, 3 + C) with the xyz
        channels recentred and divided by the radius -> (B, npoint,
        mlp[-1]). The first linear is split into its feature and xyz
        columns."""
        layers = list(self.mlp_module.children())
        w = layers[0].conv.weight.flatten(1)
        x = (F.linear(grouped[..., 3:], w[:, 3:])
             + F.linear(grouped[..., :3], w[:, :3]))
        x = F.relu(layers[0].bn.bn(x))
        return self.mlp_module(x, start=1).amax(dim=2)


class FPModule(nn.Module):
    """Feature propagation (PointnetFPModule, pointnet2_modules.py:356-416):
    three-NN inverse-distance interpolation + skip concat + shared MLP."""

    def __init__(self, mlp: Sequence[int], in_channels: int, *,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        self.mlp = PointMLP(in_channels, mlp, dtype=dtype, device=device)

    def forward(self, unknown, known, unknown_feats, known_feats):
        interp = interpolate_features(unknown, known, known_feats)
        return self.mlp(torch.cat([interp, unknown_feats], dim=-1))
