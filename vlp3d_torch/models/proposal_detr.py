"""The DETR-style proposal head (Transformer3D-Det).

Counterpart of ``idw_attention_mask``, ``PositionalAttention``,
``DeformableDecoderLayer`` and ``DETRProposalModule`` in
``vlp3d/models/proposal_detr.py`` (the reference's
``models/proposal_module/proposal_module_detr.py:70-180`` with
``detr/{detr3d,transformer3D}.py``, a head never wired into JointNet),
in the reference's implemented configuration: 'deformable' decoder
layers with the myAdd positional attention and weighted input.

  * Vote aggregation SA (FPS ``num_proposal`` of the votes, r 0.3, k 16,
    mlp [128, 128, 128]: the port's FPS, ball query and row-gather
    kernels), then two conv + BN + ReLU.
  * ``input_proj`` to d_model; the queries are the proposals themselves.
  * Each decoder layer: positional self-attention under the additive
    mask of :func:`idw_attention_mask` (post-LN residual), the deformable
    refinement tgt_pos += linear_offset(tgt), positional
    cross-attention to the projected proposals under the mask of the
    refined against the original positions, and the exact-GELU
    feed-forward with a post-LN residual (LayerNorm eps 1e-5 throughout).
  * ``decoder_norm``, one LayerNorm shared by every layer's output; the
    outputs concatenated, ``hidden_ffn`` + ``hidden_norm`` + ReLU; the
    class head and the two-layer box MLP, decoded VoteNet-style with
    centre = aggregated xyz + offset.

Submodule names are the JAX module's (``layers.{i}`` for ``layer_{i}``,
``norm`` for each attention's LayerNorm);
:func:`vlp3d_torch.convert.detr_to_torch_state_dict` carries a JAX tree
over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import (
    BatchNorm,
    Dropout,
    PointwiseConv,
    SAModule,
)

NEAR_KTH = 5  # myAdd default (transformer3D.py:301)


@torch.no_grad()
def idw_attention_mask(tgt_pos: torch.Tensor,
                       src_pos: torch.Tensor) -> torch.Tensor:
    """The additive mask (B, 1, Kt, Ks): for each target the inverse
    distance weights of its NEAR_KTH nearest sources, 1 / (d + 0.1)
    normalised over the NEAR_KTH, and -1e9 at every other source
    (transformer3D.py:297-330). Nearest by squared distance, the lowest
    index first among equal distances, as ``lax.top_k`` picks them (a
    stable sort, not ``torch.topk``): in the first self-attention the
    targets are the sources, and duplicate proposals tie. Detached, as
    the reference's weights are."""
    d2 = ((tgt_pos[:, :, None, :] - src_pos[:, None, :, :]) ** 2).sum(-1)
    order = torch.sort(d2, dim=-1, stable=True).indices[..., :NEAR_KTH]
    dist = torch.sqrt(torch.clamp(torch.gather(d2, -1, order), min=0.0))
    recip = 1.0 / (dist + 1e-1)
    weight = recip / recip.sum(dim=-1, keepdim=True)
    mask = torch.full_like(d2, -1e9).scatter_(-1, order, weight)
    return mask[:, None]


class PositionalAttention(nn.Module):
    """Multi-head attention under an additive mask (MyMultiHeadAttention,
    way 'add'), dropout on the output projection, post-LN residual on
    the queries."""

    def __init__(self, d_model: int, heads: int, dropout: float = 0.1, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.heads = heads
        self.fc_q = nn.Linear(d_model, d_model, device=device)
        self.fc_k = nn.Linear(d_model, d_model, device=device)
        self.fc_v = nn.Linear(d_model, d_model, device=device)
        self.fc_o = nn.Linear(d_model, d_model, device=device)
        self.dropout = Dropout(dropout)
        self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, q_in, k_in, v_in, add_mask):
        b, nq, d = q_in.shape
        nk = k_in.shape[1]
        h = self.heads
        dk = d // h
        q = self.fc_q(q_in).reshape(b, nq, h, dk).transpose(1, 2)
        k = self.fc_k(k_in).reshape(b, nk, h, dk).transpose(1, 2)
        v = self.fc_v(v_in).reshape(b, nk, h, dk).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        att = torch.softmax(att + add_mask, dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, nq, d)
        return self.norm(q_in + self.dropout(self.fc_o(out)))


class DeformableDecoderLayer(nn.Module):
    """transformer3D.py's forward_post, 'deformable' branch."""

    def __init__(self, d_model: int = 288, heads: int = 8, d_ff: int = 2048,
                 dropout: float = 0.1, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.self_attn = PositionalAttention(d_model, heads, dropout,
                                             device=device)
        self.linear_offset = nn.Linear(d_model, 3, device=device)
        self.multihead_attn = PositionalAttention(d_model, heads, dropout,
                                                  device=device)
        self.linear1 = nn.Linear(d_model, d_ff, device=device)
        self.linear2 = nn.Linear(d_ff, d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, tgt, memory, tgt_pos, src_pos):
        tgt = self.self_attn(tgt, tgt, tgt,
                             idw_attention_mask(tgt_pos, tgt_pos))
        tgt_pos = tgt_pos + self.linear_offset(tgt)
        tgt = self.multihead_attn(tgt, memory, memory,
                                  idw_attention_mask(tgt_pos, src_pos))
        y = self.dropout1(F.gelu(self.linear1(tgt)))  # exact erf GELU
        y = self.dropout2(self.linear2(y))
        return self.norm3(tgt + y), tgt_pos


class DETRProposalModule(nn.Module):
    """Starts in evaluation mode; ``forward(..., train=True)`` switches
    it (batch-statistic BatchNorm, dropout) and records a graph."""

    def __init__(self, num_class: int = 18, num_heading_bin: int = 1,
                 num_size_cluster: int = 18, num_proposal: int = 256,
                 n_layers: int = 4, d_model: int = 288, heads: int = 8,
                 d_ff: int = 2048, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_class = num_class
        self.nh, self.ns = num_heading_bin, num_size_cluster
        self.vote_aggregation = SAModule(num_proposal, 0.3, 16, [128] * 3,
                                         256, device=device)
        self.conv1 = PointwiseConv(128, 128, device=device)
        self.bn1 = BatchNorm(128, device=device)
        self.conv2 = PointwiseConv(128, 128, device=device)
        self.bn2 = BatchNorm(128, device=device)
        self.input_proj = nn.Linear(128, d_model, device=device)
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(d_model, heads, d_ff, device=device)
            for _ in range(n_layers))
        self.decoder_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.hidden_ffn = nn.Linear(d_model * n_layers, d_model,
                                    device=device)
        self.hidden_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.class_head = nn.Linear(d_model, 2 + num_class, device=device)
        self.bbox_mlp0 = nn.Linear(d_model, d_model, device=device)
        self.bbox_mlp1 = nn.Linear(
            d_model, 3 + num_heading_bin * 2 + num_size_cluster * 4,
            device=device)
        self.eval()

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                mean_size_arr: torch.Tensor, *, train: bool = False) -> dict:
        """xyz (B, V, 3) votes, features (B, V, 256), mean_size_arr (NS,
        3) on their device -> the JAX module's outputs."""
        if self.training != train:
            self.train(train)
        with torch.set_grad_enabled(train):
            return self._forward(xyz, features, mean_size_arr)

    def _forward(self, xyz, features, mean):
        agg_xyz, agg_f, agg_inds = self.vote_aggregation(xyz, features)
        x = F.relu(self.bn1(self.conv1(agg_f)))
        x = F.relu(self.bn2(self.conv2(x)))
        memory = self.input_proj(x)
        tgt, tgt_pos = memory, agg_xyz
        outs, positions = [], []
        for layer in self.layers:
            tgt, tgt_pos = layer(tgt, memory, tgt_pos, agg_xyz)
            outs.append(self.decoder_norm(tgt))
            positions.append(tgt_pos)
        feat = self.hidden_ffn(torch.cat(outs, dim=-1))
        feat = F.relu(self.hidden_norm(feat))
        logits = self.class_head(feat)
        box = self.bbox_mlp1(F.relu(self.bbox_mlp0(feat)))
        nh, ns = self.nh, self.ns
        center_offset, heading_scores, heading_res_norm, size_scores, \
            size_res = box.split([3, nh, nh, ns, ns * 3], dim=-1)
        size_res_norm = size_res.reshape(*box.shape[:-1], ns, 3)
        size_cls = torch.argmax(size_scores, dim=-1)
        size_residuals = size_res_norm * mean[None, None]
        pred_size = mean[size_cls] + torch.gather(
            size_residuals, 2,
            size_cls[..., None, None].expand(-1, -1, 1, 3))[..., 0, :]
        center = agg_xyz + center_offset
        return {
            "aggregated_vote_xyz": agg_xyz,
            "aggregated_vote_features": agg_f,
            "aggregated_vote_inds": agg_inds,
            "detr_features": feat,
            "transformer_weighted_xyz": positions[-1],
            "transformer_weighted_xyz_all": torch.stack(positions),
            "objectness_scores": logits[..., :2],
            "sem_cls_scores": logits[..., 2:],
            "center": center,
            "pred_center": center,
            "heading_scores": heading_scores,
            "heading_residuals_normalized": heading_res_norm,
            "heading_residuals": heading_res_norm * (math.pi / nh),
            "size_scores": size_scores,
            "size_residuals_normalized": size_res_norm,
            "size_residuals": size_residuals,
            "pred_size": pred_size,
            "objectness_masks": torch.argmax(logits[..., :2], dim=-1).float(),
        }
