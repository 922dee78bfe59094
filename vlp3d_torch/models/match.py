"""Cross-modal match module: grounding confidence per (sentence, proposal).

Counterpart of ``vlp3d/models/match.py`` (match_module.py:10-170):
proposal features, repeated per sentence, attend through two
cross-attention decoder layers to the sentence's token features (CLS
dropped, no key mask, as the reference does), then a 3-layer GELU MLP with
two Dropout(0.5) gives ``cluster_ref``. GELU is the tanh approximation
(flax's default).

In training, with a ``random_gate`` below 0.5, each scene's non-object
proposal features are first replaced by object features pooled from the
whole batch (:func:`copy_paste_features`). The gate is the caller's one
uniform draw of the step, shared with the DIoU loss; the module never
draws its own. Under data parallel (``shard``) the pool is the global
batch in global scan order: every rank gathers the features and
objectness masks of all ranks (differentiably), pastes over the whole
batch and keeps its rows, so a scene may paste another rank's objects.

Options (match_module.py:148-168):

  * ``use_lang_emb``: each sentence's CLS embedding attends over the
    (copy-pasted) proposal features (``lang_emb_cross_attn``), and
    ``lang_emb_proj`` (conv, BN, PReLU, conv, BN, PReLU, conv to K)
    gives a second (B*L, K) score that is added to the MLP's before
    anything reads ``cluster_ref``;
  * ``use_reg_head``: ``reg_head`` (linear, BN, GELU, linear, BN, GELU,
    linear) gives ``pred_center_reg`` / ``pred_size_reg`` (B, L, K, 3),
    each sigmoid * 0.1 - 0.05: offsets the DIoU loss adds to the boxes.

The PReLUs keep one slope a channel, as the JAX module does (the
reference declares one slope; :class:`~vlp3d_torch.models.layers.PReLU`
loads that too).
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.attention import (
    CrossAttentionDecoderLayer,
    MultiHeadAttention,
)
from vlp3d_torch.models.layers import BatchNorm, Dropout, PointwiseConv, PReLU
from vlp3d_torch.parallel.reduce import LOCAL


def copy_paste_features(features: torch.Tensor,
                        obj_mask: torch.Tensor) -> torch.Tensor:
    """Fixed-shape form of the copy-paste loop (match_module.py:96-121).

    features (B, K, H); obj_mask (B, K) bool (positive objectness). Scene
    i's r-th non-object slot in scan order receives pooled object feature
    (sum(obj_lens[:i+1]) + r) mod total_objects, and is replaced only
    while r < total_objects - obj_lens[i].
    """
    b, k, h = features.shape
    flat_mask = obj_mask.reshape(b * k)
    flat_feats = features.reshape(b * k, h)
    # objects first, in global scan order
    order = torch.argsort((~flat_mask).to(torch.int8), stable=True)
    obj_sorted = flat_feats[order]

    obj_lens = obj_mask.sum(dim=1)  # (B,)
    total_len = obj_lens.sum()
    start = torch.cumsum(obj_lens, dim=0)  # inclusive

    nonobj = ~obj_mask
    rank = torch.cumsum(nonobj.to(torch.int64), dim=1) - 1  # (B, K)
    src = (start[:, None] + rank) % torch.clamp(total_len, min=1)
    replace = nonobj & (rank < (total_len - obj_lens)[:, None])
    pasted = obj_sorted[src.reshape(-1)].reshape(b, k, h)
    return torch.where(replace[..., None], pasted, features)


class MatchModule(nn.Module):
    shard = LOCAL

    def __init__(self, hidden_size: int = 128, depth: int = 2, heads: int = 4,
                 *, num_proposals: int = 256, use_lang_emb: bool = False,
                 use_reg_head: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        h = hidden_size
        self.grounding_cross_attn = nn.ModuleList(
            CrossAttentionDecoderLayer(h, heads=heads, device=device)
            for _ in range(depth))
        self.match = nn.Sequential(
            nn.Linear(h, h, device=device), nn.GELU(approximate="tanh"),
            Dropout(0.5),
            nn.Linear(h, h, device=device), nn.GELU(approximate="tanh"),
            Dropout(0.5),
            nn.Linear(h, 1, device=device),
        )
        self.lang_emb_cross_attn = self.lang_emb_proj = self.reg_head = None
        if use_lang_emb:
            self.lang_emb_cross_attn = MultiHeadAttention(h, heads,
                                                          device=device)
            self.lang_emb_proj = nn.Sequential(
                PointwiseConv(h, h, device=device), BatchNorm(h, device=device),
                PReLU(h, device=device),
                PointwiseConv(h, h, device=device), BatchNorm(h, device=device),
                PReLU(h, device=device),
                PointwiseConv(h, num_proposals, device=device),
            )
        if use_reg_head:
            self.reg_head = nn.Sequential(
                nn.Linear(h, h, device=device), BatchNorm(h, device=device),
                nn.GELU(approximate="tanh"),
                nn.Linear(h, h, device=device), BatchNorm(h, device=device),
                nn.GELU(approximate="tanh"),
                nn.Linear(h, 6, device=device),
            )

    def forward(self, bbox_feature: torch.Tensor, lang_fea: torch.Tensor,
                objectness_masks: torch.Tensor | None = None,
                *, lang_num_max: int, random_gate=None,
                lang_emb: torch.Tensor | None = None) -> dict:
        """bbox_feature (B, K, H); lang_fea (B*L, T, H); objectness_masks
        (B, K) float and random_gate (a scalar in [0, 1)) drive the
        train-time copy-paste; lang_emb (B*L, H), the CLS embeddings, feeds
        ``use_lang_emb`` -> cluster_ref (B*L, K), cross_box_feature (B*L,
        K, H)[, pred_center_reg, pred_size_reg (B, L, K, 3)]."""
        b, k, h = bbox_feature.shape
        l = lang_num_max
        features = bbox_feature
        if self.training and random_gate is not None:
            pasted = self.shard.own(copy_paste_features(
                self.shard.cat(features),
                self.shard.cat(objectness_masks) > 0))
            gate = torch.as_tensor(random_gate, device=features.device)
            features = torch.where(gate < 0.5, pasted, features)
        feature1 = features[:, None].expand(b, l, k, h).reshape(b * l, k, h)
        tokens = lang_fea[:, 1:]  # drop CLS (match_module.py:129)
        for layer in self.grounding_cross_attn:
            feature1 = layer(feature1, tokens, tokens)
        confidence = self.match(feature1).reshape(b * l, k)
        out = {"cross_box_feature": feature1}
        if self.lang_emb_proj is not None:
            le = self.lang_emb_cross_attn(lang_emb.reshape(b, l, h), features,
                                          features)
            confidence = confidence + self.lang_emb_proj(le.reshape(b * l, h))
        out["cluster_ref"] = confidence
        if self.reg_head is not None:
            reg = torch.sigmoid(self.reg_head(feature1.reshape(b * l * k, h)))
            reg = (reg * 0.1 - 0.05).reshape(b, l, k, 6)
            out["pred_center_reg"] = reg[..., 0:3]
            out["pred_size_reg"] = reg[..., 3:6]
        return out
