"""Proposal generation: vote aggregation + ROI head + box decode.

Counterpart of ``vlp3d/models/proposal.py``: vote
aggregation is an SA module (FPS ``num_proposal`` of the votes, r=0.3,
k=16, mlp [128, 128, 128], normalize_xyz); the head is 2x (conv + BN +
ReLU) and the predictors of roi_heads.py:15-147; boxes decode on device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.geometry.boxes import rotate_rotz_rows
from vlp3d_torch.models.layers import BatchNorm, PointwiseConv, SAModule


class ROIHeads(nn.Module):
    """BRNet StandardROIHeads (roi_heads.py:15-147), channels-last."""

    def __init__(self, num_heading_bin: int = 1, num_class: int = 18, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_heading_bin = num_heading_bin
        self.convs = nn.Sequential(
            PointwiseConv(128, 128, device=device),
            BatchNorm(128, device=device),
            nn.ReLU(),
            PointwiseConv(128, 128, device=device),
            BatchNorm(128, device=device),
            nn.ReLU(),
        )
        self.objectness_predictor = PointwiseConv(128, 2, device=device)
        self.box_predictor = PointwiseConv(128, 6, device=device)
        self.heading_cls_predictor = PointwiseConv(
            128, num_heading_bin, device=device)
        self.heading_reg_predictor = PointwiseConv(
            128, num_heading_bin, device=device)
        self.sem_cls_predictor = PointwiseConv(128, num_class, device=device)

    def forward(self, features: torch.Tensor) -> dict:
        x = self.convs(features)
        heading_reg = self.heading_reg_predictor(x)
        return {
            "objectness_scores": self.objectness_predictor(x),
            "rois": torch.exp(self.box_predictor(x)),
            "heading_scores": self.heading_cls_predictor(x),
            "heading_residuals_normalized": heading_reg,
            "heading_residuals": heading_reg * (math.pi / self.num_heading_bin),
            "sem_cls_scores": self.sem_cls_predictor(x),
        }


def decode_boxes(aggregated_vote_xyz, rois, heading_scores, heading_residuals,
                 num_heading_bin: int):
    """ROI distances -> (center, size, heading) (proposal_module_fcos.py:94-131)."""
    cls = torch.argmax(heading_scores, dim=-1)
    residual = torch.gather(heading_residuals, -1, cls[..., None])[..., 0]
    heading = cls.float() * (2.0 * math.pi / num_heading_bin) + residual
    size = rois[..., 0:3] + rois[..., 3:6]
    offset = rotate_rotz_rows((rois[..., 0:3] - rois[..., 3:6]) / 2.0, heading)
    return aggregated_vote_xyz - offset, size, heading


class ProposalModule(nn.Module):
    def __init__(self, num_class: int = 18, num_heading_bin: int = 1,
                 num_proposal: int = 256, seed_feat_dim: int = 256, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_heading_bin = num_heading_bin
        self.vote_aggregation = SAModule(
            num_proposal, 0.3, 16, [128, 128, 128], seed_feat_dim,
            device=device,
        )
        self.proposal = ROIHeads(num_heading_bin, num_class, device=device)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor) -> dict:
        """xyz (B, V, 3) votes, features (B, V, C) L2-normalised vote features."""
        agg_xyz, agg_features, agg_inds = self.vote_aggregation(xyz, features)
        out = {
            "aggregated_vote_xyz": agg_xyz,
            "aggregated_vote_features": agg_features,
            "aggregated_vote_inds": agg_inds,
        }
        out.update(self.proposal(agg_features))
        center, size, heading = decode_boxes(
            agg_xyz, out["rois"], out["heading_scores"],
            out["heading_residuals"], self.num_heading_bin,
        )
        out["pred_center"] = center
        out["pred_size"] = size
        out["pred_heading"] = heading
        out["pred_bbox_feature"] = agg_features
        # argmax over the 2 objectness logits, as a float mask
        out["objectness_masks"] = torch.argmax(
            out["objectness_scores"], dim=-1).float()
        return out
