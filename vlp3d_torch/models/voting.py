"""Hough voting module (voting_module.py:11-60), channels-last.

Counterpart of ``vlp3d/models/voting.py``: two conv+BN+ReLU blocks, then
a head predicting per-seed xyz offsets and feature residuals.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import BatchNorm, PointwiseConv


class VotingModule(nn.Module):
    def __init__(self, vote_factor: int = 1, seed_feature_dim: int = 256, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        c = seed_feature_dim
        self.vote_factor, self.c = vote_factor, c
        self.conv1 = PointwiseConv(c, c, device=device)
        self.bn1 = BatchNorm(c, device=device)
        self.conv2 = PointwiseConv(c, c, device=device)
        self.bn2 = BatchNorm(c, device=device)
        self.conv3 = PointwiseConv(c, (3 + c) * vote_factor, device=device)

    def forward(self, seed_xyz: torch.Tensor, seed_features: torch.Tensor):
        """seed_xyz (B, S, 3), seed_features (B, S, C) ->
        vote_xyz (B, S*vf, 3), vote_features (B, S*vf, C)."""
        b, s, _ = seed_xyz.shape
        x = F.relu(self.bn1(self.conv1(seed_features)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.conv3(x).reshape(b, s, self.vote_factor, 3 + self.c)
        vote_xyz = (seed_xyz[:, :, None, :] + x[..., :3]).reshape(
            b, s * self.vote_factor, 3)
        vote_features = (seed_features[:, :, None, :] + x[..., 3:]).reshape(
            b, s * self.vote_factor, self.c)
        return vote_xyz, vote_features


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-12) over the last axis (jointnet.py:139-141)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)
