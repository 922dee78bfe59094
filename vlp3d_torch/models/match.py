"""Cross-modal match module: grounding confidence per (sentence, proposal).

Counterpart of ``vlp3d/models/match.py`` (match_module.py:10-170) at
inference: proposal features, repeated per sentence, attend through two
cross-attention decoder layers to the sentence's token features (CLS
dropped, no key mask, as the reference does), then a 3-layer GELU MLP
gives ``cluster_ref``. GELU is the tanh approximation (flax's default).
The train-time copy-paste augmentation waits for slice 2 (ROADMAP queue
A item 9a).
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.attention import CrossAttentionDecoderLayer


class MatchModule(nn.Module):
    def __init__(self, hidden_size: int = 128, depth: int = 2, heads: int = 4,
                 *, device=None):
        super().__init__()
        device = resolve_device(device)
        h = hidden_size
        self.grounding_cross_attn = nn.ModuleList(
            CrossAttentionDecoderLayer(h, heads=heads, device=device)
            for _ in range(depth))
        self.match = nn.Sequential(
            nn.Linear(h, h, device=device), nn.GELU(approximate="tanh"),
            nn.Dropout(0.5),
            nn.Linear(h, h, device=device), nn.GELU(approximate="tanh"),
            nn.Dropout(0.5),
            nn.Linear(h, 1, device=device),
        )

    def forward(self, bbox_feature: torch.Tensor, lang_fea: torch.Tensor,
                *, lang_num_max: int) -> dict:
        """bbox_feature (B, K, H); lang_fea (B*L, T, H) ->
        cluster_ref (B*L, K), cross_box_feature (B*L, K, H)."""
        b, k, h = bbox_feature.shape
        l = lang_num_max
        feature1 = bbox_feature[:, None].expand(b, l, k, h).reshape(b * l, k, h)
        tokens = lang_fea[:, 1:]  # drop CLS (match_module.py:129)
        for layer in self.grounding_cross_attn:
            feature1 = layer(feature1, tokens, tokens)
        confidence = self.match(feature1).reshape(b * l, k)
        return {"cross_box_feature": feature1, "cluster_ref": confidence}
