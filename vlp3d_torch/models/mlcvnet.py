"""MLCVNet's CGNL voting (``--use_mlcv_net``), channels-last.

Counterpart of ``SpatialCGNL`` and ``MLCVVotingModule`` in
``vlp3d/models/mlcvnet.py`` (the reference's
``models/mlcvnet/{CGNL,voting_module}.py``). The CGNL block with the
linear dot-product kernel and ``use_scale`` False is, per scene and
group, a rank-1 global aggregation: ``att`` is the sum over the N points
and the gc channels of the group of p * g, and the block's value is
``att * t``; then the grouped 1x1 conv ``z``, GroupNorm and the residual.
The voting module runs the block over the seeds, then the two conv + BN +
ReLU layers and the vote head of :class:`VotingModule`.

Parameter names are the reference's (``sa1.t``, ``sa1.p``, ``sa1.g``,
``sa1.z``, ``sa1.gn``; ``conv1-3``, ``bn1-2``). ``z`` is the
reference's ``Conv2d(planes, inplanes, 1, groups)`` weight (inplanes,
planes / groups, 1, 1): output channel ``g * (inplanes / groups) + o`` of
group ``g`` reads that group's gc channels, the JAX module's
``z_kernel[g, c, o]``.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import PointwiseConv
from vlp3d_torch.models.voting import VotingModule


class GroupNorm(nn.Module):
    """flax's ``GroupNorm(num_groups, epsilon)`` over the last axis of a
    channels-last (B, ..., C) tensor: each sample's statistics over its
    points and the C / groups channels of a group, the variance computed
    as flax's default does, max(E[x^2] - E[x]^2, 0)."""

    def __init__(self, groups: int, c: int, eps: float = 1e-5, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        per = (self.groups, shape[-1] // self.groups)
        g = x.reshape(shape[0], -1, *per)
        dims = (1, 3)
        mean = g.mean(dims, keepdim=True)
        var = torch.clamp((g * g).mean(dims, keepdim=True) - mean * mean,
                          min=0.0)
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(per)
        return ((g - mean) * mul + self.bias.reshape(per)).reshape(shape)


class SpatialCGNL(nn.Module):
    """Channels-last CGNL block: (B, N, inplanes) -> (B, N, inplanes)."""

    def __init__(self, inplanes: int, planes: int, groups: int = 4, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.groups, self.planes = groups, planes
        self.t = PointwiseConv(inplanes, planes, rank=2, bias=False,
                               device=device)
        self.p = PointwiseConv(inplanes, planes, rank=2, bias=False,
                               device=device)
        self.g = PointwiseConv(inplanes, planes, rank=2, bias=False,
                               device=device)
        self.z = nn.Module()
        self.z.weight = nn.Parameter(torch.zeros(
            inplanes, planes // groups, 1, 1, device=device))
        self.gn = GroupNorm(groups, inplanes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        gs, gc = self.groups, self.planes // self.groups
        t = self.t(x).reshape(b, n, gs, gc)
        p = self.p(x).reshape(b, n, gs, gc)
        g = self.g(x).reshape(b, n, gs, gc)
        att = (p * g).sum(dim=(1, 3))  # (B, groups): one scalar a group
        out = att[:, None, :, None] * t
        zw = self.z.weight.reshape(gs, c // gs, gc)  # (groups, out, in)
        out = torch.einsum("bngc,goc->bngo", out, zw).reshape(b, n, c)
        return self.gn(out) + x


class MLCVVotingModule(VotingModule):
    """CGNL over the seeds, then :class:`VotingModule`'s layers: the vote
    offsets and feature residuals are computed from the CGNL output and
    added to the seeds' own coordinates and features."""

    def __init__(self, vote_factor: int = 1, seed_feature_dim: int = 256, *,
                 device=None):
        super().__init__(vote_factor, seed_feature_dim, device=device)
        c = seed_feature_dim
        self.sa1 = SpatialCGNL(c, c // 2, device=device)

    def forward(self, seed_xyz: torch.Tensor, seed_features: torch.Tensor):
        return self.vote(seed_xyz, seed_features, self.sa1(seed_features))
