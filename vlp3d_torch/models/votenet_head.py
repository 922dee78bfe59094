"""Classic VoteNet proposal head of the standalone ScanQA model.

Counterpart of ``vlp3d/models/votenet_head.py`` (the reference's
``models/vqa/proposal.py:20-120``): vote aggregation SA (FPS 256 of the
votes, r 0.3, k 16, mlp [128, 128, 128], normalize_xyz; the port's
:class:`~vlp3d_torch.models.layers.SAModule`, so the same FPS, ball
query and gather kernels as the grounding proposal) -> 2 x (bias-free
conv, BatchNorm, ReLU) -> one conv emitting [objectness (2), centre
offset (3), heading class + residual (NH each), size class (NS) + residual
(NS x 3), semantic class]. Decode: centre = aggregated xyz + offset;
size = mean_size[argmax] + residual. ``argmax`` takes the first index of
a tie, as ``jnp.argmax`` does (``objectness_masks``, the size class).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import BatchNorm, PointwiseConv, SAModule


class VoteNetProposalModule(nn.Module):
    def __init__(self, num_class: int = 18, num_heading_bin: int = 1,
                 num_size_cluster: int = 18, num_proposal: int = 256, *,
                 mean_size_arr: np.ndarray, device=None):
        """The vote features are 256-d; the aggregation's radius 0.3,
        16 neighbours and 128 channels are the reference's constants."""
        super().__init__()
        device = resolve_device(device)
        self.num_class = num_class
        self.nh, self.ns = num_heading_bin, num_size_cluster
        c = 128
        self.vote_aggregation = SAModule(num_proposal, 0.3, 16, [c] * 3, 256,
                                         device=device)
        self.conv1 = PointwiseConv(c, c, bias=False, device=device)
        self.bn1 = BatchNorm(c, device=device)
        self.conv2 = PointwiseConv(c, c, bias=False, device=device)
        self.bn2 = BatchNorm(c, device=device)
        self.conv3 = PointwiseConv(
            c, 2 + 3 + self.nh * 2 + self.ns * 4 + num_class, device=device)
        self.register_buffer(
            "mean_size_arr",
            torch.as_tensor(np.asarray(mean_size_arr, np.float32),
                            device=device), persistent=False)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor) -> dict:
        """xyz (B, V, 3) votes, features (B, V, C) -> the head's outputs
        and decoded boxes (B, K, ...)."""
        agg_xyz, agg_f, agg_inds = self.vote_aggregation(xyz, features)
        x = F.relu(self.bn1(self.conv1(agg_f)))
        x = F.relu(self.bn2(self.conv2(x)))
        head = self.conv3(x)
        nh, ns = self.nh, self.ns
        objectness, center_offset, heading_scores, heading_res_norm, \
            size_scores, size_res, sem_cls_scores = head.split(
                [2, 3, nh, nh, ns, ns * 3, self.num_class], dim=-1)
        size_res_norm = size_res.reshape(*head.shape[:-1], ns, 3)
        center = agg_xyz + center_offset
        mean = self.mean_size_arr
        size_residuals = size_res_norm * mean[None, None]
        size_cls = torch.argmax(size_scores, dim=-1)
        pred_size = mean[size_cls] + torch.gather(
            size_residuals, 2,
            size_cls[..., None, None].expand(-1, -1, 1, 3))[..., 0, :]
        return {
            "aggregated_vote_xyz": agg_xyz,
            "aggregated_vote_features": agg_f,
            "aggregated_vote_inds": agg_inds,
            "objectness_scores": objectness,
            "center": center,
            "pred_center": center,
            "heading_scores": heading_scores,
            "heading_residuals_normalized": heading_res_norm,
            "heading_residuals": heading_res_norm * (math.pi / nh),
            "size_scores": size_scores,
            "size_residuals_normalized": size_res_norm,
            "size_residuals": size_residuals,
            "pred_size": pred_size,
            "sem_cls_scores": sem_cls_scores,
            "objectness_masks": torch.argmax(objectness, dim=-1).float(),
        }
