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
draws its own.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.attention import CrossAttentionDecoderLayer
from vlp3d_torch.models.layers import Dropout


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
            Dropout(0.5),
            nn.Linear(h, h, device=device), nn.GELU(approximate="tanh"),
            Dropout(0.5),
            nn.Linear(h, 1, device=device),
        )

    def forward(self, bbox_feature: torch.Tensor, lang_fea: torch.Tensor,
                objectness_masks: torch.Tensor | None = None,
                *, lang_num_max: int, random_gate=None) -> dict:
        """bbox_feature (B, K, H); lang_fea (B*L, T, H); objectness_masks
        (B, K) float and random_gate (a scalar in [0, 1)) drive the
        train-time copy-paste ->
        cluster_ref (B*L, K), cross_box_feature (B*L, K, H)."""
        b, k, h = bbox_feature.shape
        l = lang_num_max
        features = bbox_feature
        if self.training and random_gate is not None:
            pasted = copy_paste_features(features, objectness_masks > 0)
            gate = torch.as_tensor(random_gate, device=features.device)
            features = torch.where(gate < 0.5, pasted, features)
        feature1 = features[:, None].expand(b, l, k, h).reshape(b * l, k, h)
        tokens = lang_fea[:, 1:]  # drop CLS (match_module.py:129)
        for layer in self.grounding_cross_attn:
            feature1 = layer(feature1, tokens, tokens)
        confidence = self.match(feature1).reshape(b * l, k)
        return {"cross_box_feature": feature1, "cluster_ref": confidence}
