"""Proposal relation module: 2-layer self-attention with geometric bias.

Counterpart of ``vlp3d/models/relation.py`` (relation_module.py:9-139).
The multiview object embedding reads point_clouds[..., off:off+dim] at
the point -> seed -> proposal index composition. With
``reference_obj_gather`` it reads what the reference reads instead
(relation_module.py:101-117), which published weights were trained
against: the contiguous copy of the (B, C, N) transpose viewed as (B*N,
C) rows, each row C consecutive point positions of one channel, at row
``point_idx + b * C`` (C, not N: batch b reads mostly batch 0's block).
Every such row exists ((B - 1) * C + N - 1 < B * N). The read is one row
gather (:func:`vlp3d_torch.ops.gather_points`, the kernel on the card)
over a (1, B*N, C) table; the point cloud is an input without gradient,
so it has no backward, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.geometry.boxes import corner_offsets_flat
from vlp3d_torch.models.attention import MultiHeadAttention
from vlp3d_torch.models.layers import BatchNorm, PointwiseConv, PReLU
from vlp3d_torch.ops import gather_points


def _dist_mlp(heads: int, device) -> nn.Sequential:
    """[4 -> 32 -> 32 -> heads] geometric bias MLP (relation_module.py:29-37)."""
    return nn.Sequential(
        nn.Linear(4, 32, device=device), nn.ReLU(),
        nn.LayerNorm(32, eps=1e-5, device=device),
        nn.Linear(32, 32, device=device), nn.ReLU(),
        nn.LayerNorm(32, eps=1e-5, device=device),
        nn.Linear(32, heads, device=device),
    )


class RelationModule(nn.Module):
    def __init__(self, hidden_size: int = 128, det_channel: int = 128,
                 heads: int = 4, depth: int = 2, *, multiview_offset: int = 6,
                 multiview_dim: int = 128, reference_obj_gather: bool = False,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.depth = depth
        self.reference_obj_gather = reference_obj_gather
        self.multiview_offset, self.multiview_dim = (multiview_offset,
                                                     multiview_dim)
        self.features_concat = nn.Sequential(
            PointwiseConv(det_channel, hidden_size, device=device),
            BatchNorm(hidden_size, device=device),
            PReLU(hidden_size, device=device),
            PointwiseConv(hidden_size, hidden_size, device=device),
        )
        self.self_attn_fc = nn.ModuleList(
            _dist_mlp(heads, device) for _ in range(depth))
        self.self_attn = nn.ModuleList(
            MultiHeadAttention(hidden_size, heads, device=device)
            for _ in range(depth))
        self.obj_embedding = nn.ModuleList(
            nn.Linear(multiview_dim, hidden_size, device=device)
            for _ in range(depth))
        self.bbox_embedding = nn.ModuleList(
            nn.Linear(27, hidden_size, device=device) for _ in range(depth))

    def forward(self, proposal_features, pred_center, pred_size, pred_heading,
                point_clouds, seed_inds, aggregated_vote_inds) -> dict:
        features = self.features_concat(proposal_features)

        # multiview per-proposal feature: point_clouds -> seed -> proposal
        off = self.multiview_offset
        obj_feat = point_clouds[..., off:off + self.multiview_dim]
        point_idx = torch.gather(seed_inds, 1, aggregated_vote_inds.long())
        if self.reference_obj_gather:
            b, n, c = obj_feat.shape
            table = obj_feat.transpose(1, 2).contiguous().view(1, b * n, c)
            rows = point_idx + torch.arange(
                b, device=point_idx.device, dtype=point_idx.dtype)[:, None] * c
            proposal_mv = gather_points(table, rows.reshape(1, -1)).view(
                b, -1, c)
        else:
            proposal_mv = gather_points(obj_feat, point_idx)  # (B, K, mv)

        # geometric attention bias inputs (centers == mean of corners)
        offsets = pred_center[:, None, :, :] - pred_center[:, :, None, :]
        dist = torch.sqrt((offsets ** 2).sum(-1, keepdim=True))
        # no gradient reaches the centers through the bias inputs
        geo = torch.cat([offsets, dist], dim=-1).detach()  # (B, K, K, 4)
        box_feat = torch.cat(
            [pred_center, corner_offsets_flat(pred_size, pred_heading)], -1)

        attn_maps = []
        dist_weights = None
        for i in range(self.depth):
            dist_weights = self.self_attn_fc[i](geo).permute(0, 3, 1, 2)
            features = features + self.obj_embedding[i](proposal_mv) * 0.1
            features = features + self.bbox_embedding[i](box_feat)
            features, att = self.self_attn[i](
                features, features, features, attention_weights=dist_weights,
                way="add", return_attention=True,
            )
            attn_maps.append(att)
        return {
            "bbox_feature": features,
            "dist_weights": dist_weights,
            "relation_attn": torch.cat(attn_maps, dim=1),
        }
