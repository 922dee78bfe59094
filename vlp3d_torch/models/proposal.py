"""Proposal generation: vote aggregation + ROI head + box decode.

Counterpart of ``vlp3d/models/proposal.py``: vote
aggregation is an SA module (FPS ``num_proposal`` of the votes, r=0.3,
k=16, mlp [128, 128, 128], normalize_xyz); the head is 2x (conv + BN +
ReLU) and the predictors of roi_heads.py:15-147; boxes decode on device.

Options (proposal_module_fcos.py, roi_heads.py):

  * ``use_vote_weight``: ``votes_weight_predictor`` (conv 128 -> BN ->
    PReLU -> conv 1 -> sigmoid) gives each vote a weight in (0, 1),
    output as ``vote_weights`` (B, V, 1); the vote aggregation groups the
    weighted features;
  * ``use_kl_loss``: the head's ``alpha_predictor`` gives ``alpha`` (B, K,
    6), sigmoid * 0.1 - 0.05, the KL loss's log-variances;
  * ``mask_box``: in training, 30% of the decoded boxes are replaced by
    random ones (:func:`mask_boxes`) before anything reads them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.geometry.boxes import rotate_rotz_rows
from vlp3d_torch.models.layers import (
    BatchNorm,
    PointwiseConv,
    PReLU,
    SAModule,
)
from vlp3d_torch.parallel.reduce import LOCAL

# share of the boxes mask_boxes replaces (proposal_module_fcos.py:161-178)
MASK_RATE = 0.3


class ROIHeads(nn.Module):
    """BRNet StandardROIHeads (roi_heads.py:15-147), channels-last."""

    def __init__(self, num_heading_bin: int = 1, num_class: int = 18, *,
                 use_kl_loss: bool = False, device=None):
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
        self.alpha_predictor = (PointwiseConv(128, 6, device=device)
                                if use_kl_loss else None)

    def forward(self, features: torch.Tensor) -> dict:
        x = self.convs(features)
        heading_reg = self.heading_reg_predictor(x)
        out = {
            "objectness_scores": self.objectness_predictor(x),
            "rois": torch.exp(self.box_predictor(x)),
            "heading_scores": self.heading_cls_predictor(x),
            "heading_residuals_normalized": heading_reg,
            "heading_residuals": heading_reg * (math.pi / self.num_heading_bin),
            "sem_cls_scores": self.sem_cls_predictor(x),
        }
        if self.alpha_predictor is not None:
            out["alpha"] = torch.sigmoid(self.alpha_predictor(x)) * 0.1 - 0.05
        return out


def decode_boxes(aggregated_vote_xyz, rois, heading_scores, heading_residuals,
                 num_heading_bin: int):
    """ROI distances -> (center, size, heading) (proposal_module_fcos.py:94-131)."""
    cls = torch.argmax(heading_scores, dim=-1)
    residual = torch.gather(heading_residuals, -1, cls[..., None])[..., 0]
    heading = cls.float() * (2.0 * math.pi / num_heading_bin) + residual
    size = rois[..., 0:3] + rois[..., 3:6]
    offset = rotate_rotz_rows((rois[..., 0:3] - rois[..., 3:6]) / 2.0, heading)
    return aggregated_vote_xyz - offset, size, heading


def box_mask_draws(b: int, k: int, generator: torch.Generator | None,
                   device) -> tuple:
    """The three draws of :func:`mask_boxes` for B x K boxes: which are
    masked (B, K, 1) bool, Bernoulli(MASK_RATE), their centres N(0, 1) / 2
    and their sizes 1 + N(0, 1), (B, K, 3) each, from ``generator``."""
    mask = torch.rand((b, k, 1), generator=generator, device=device) < MASK_RATE
    center = torch.randn((b, k, 3), generator=generator, device=device) / 2.0
    size = 1.0 + torch.randn((b, k, 3), generator=generator, device=device)
    return mask, center, size


def mask_boxes(center: torch.Tensor, size: torch.Tensor,
               generator: torch.Generator | None = None, shard=LOCAL):
    """Train-time box masking (proposal_module_fcos.py:161-178): a masked
    box gets a random centre and size (:func:`box_mask_draws`). The JAX
    package draws from its ``aug`` key; the bits differ, the distribution
    is the same. Under data parallel (``shard``) the draws are the global
    batch's and this rank keeps its rows."""
    mask, rand_center, rand_size = (shard.own(d) for d in box_mask_draws(
        center.shape[0] * shard.world, center.shape[1], generator,
        center.device))
    return (torch.where(mask, rand_center, center),
            torch.where(mask, rand_size, size))


class ProposalModule(nn.Module):
    shard = LOCAL

    def __init__(self, num_class: int = 18, num_heading_bin: int = 1,
                 num_proposal: int = 256, seed_feat_dim: int = 256, *,
                 use_vote_weight: bool = False, use_kl_loss: bool = False,
                 mask_box: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_heading_bin = num_heading_bin
        self.mask_box = mask_box
        self.votes_weight_predictor = nn.Sequential(
            PointwiseConv(seed_feat_dim, 128, device=device),
            BatchNorm(128, device=device),
            PReLU(128, device=device),
            PointwiseConv(128, 1, device=device),
        ) if use_vote_weight else None
        self.vote_aggregation = SAModule(
            num_proposal, 0.3, 16, [128, 128, 128], seed_feat_dim,
            device=device,
        )
        self.proposal = ROIHeads(num_heading_bin, num_class,
                                 use_kl_loss=use_kl_loss, device=device)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor, *,
                generator: torch.Generator | None = None) -> dict:
        """xyz (B, V, 3) votes, features (B, V, C) L2-normalised vote
        features; ``generator`` draws the training forward's box masks."""
        out = {}
        if self.votes_weight_predictor is not None:
            w = torch.sigmoid(self.votes_weight_predictor(features))
            out["vote_weights"] = w  # (B, V, 1)
            features = features * w
        agg_xyz, agg_features, agg_inds = self.vote_aggregation(xyz, features)
        out.update({
            "aggregated_vote_xyz": agg_xyz,
            "aggregated_vote_features": agg_features,
            "aggregated_vote_inds": agg_inds,
        })
        out.update(self.proposal(agg_features))
        center, size, heading = decode_boxes(
            agg_xyz, out["rois"], out["heading_scores"],
            out["heading_residuals"], self.num_heading_bin,
        )
        if self.mask_box and self.training:
            center, size = mask_boxes(center, size, generator, self.shard)
        out["pred_center"] = center
        out["pred_size"] = size
        out["pred_heading"] = heading
        out["pred_bbox_feature"] = agg_features
        # argmax over the 2 objectness logits, as a float mask
        out["objectness_masks"] = torch.argmax(
            out["objectness_scores"], dim=-1).float()
        return out
