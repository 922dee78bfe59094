"""VQA answer head: attention-flatten over the cross-modal proposal
features, then a classifier over the answer vocabulary.

Counterpart of ``vlp3d/models/answer.py`` (the reference's
``models/answer_module/answer_module.py:10-114``, whose live path is
AttFlat over ``cross_box_feature`` -> ``answer_cls``, with AttFlat from
``models/vqa/mcan_module.py:74-109``: hidden 128, flat_mlp 512, glimpses
1, flat_out 512, dropout 0.1). GELU is the tanh approximation, flax's
default. Module names are the reference checkpoint's
(``attflat_visual.mlp.fc.linear``, ``attflat_visual.mlp.linear``,
``attflat_visual.linear_merge``, ``answer_cls.0`` / ``answer_cls.3``).
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import Dropout


HIDDEN = 128  # cross_box_feature's width
FLAT_MLP = 512
FLAT_OUT = 512
PDROP = 0.1


class _FC(nn.Module):
    """MCAN's FC: linear, activation, dropout (``mlp.fc``)."""

    def __init__(self, device):
        super().__init__()
        self.linear = nn.Linear(HIDDEN, FLAT_MLP, device=device)
        self.act = nn.GELU(approximate="tanh")
        self.dropout = Dropout(PDROP)

    def forward(self, x):
        return self.dropout(self.act(self.linear(x)))


class _MLP(nn.Module):
    """MCAN's MLP: FC then a linear to one glimpse (``attflat_visual.mlp``)."""

    def __init__(self, device):
        super().__init__()
        self.fc = _FC(device)
        self.linear = nn.Linear(FLAT_MLP, 1, device=device)

    def forward(self, x):
        return self.linear(self.fc(x))


class AttFlat(nn.Module):
    def __init__(self, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.mlp = _MLP(device)
        self.linear_merge = nn.Linear(HIDDEN, FLAT_OUT, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, K, HIDDEN) -> (N, FLAT_OUT): one softmax glimpse over
        all K proposals (the reference's forward passes no mask)."""
        att = torch.softmax(self.mlp(x), dim=1)  # (N, K, 1)
        return self.linear_merge(torch.einsum("nk,nkh->nh", att[..., 0], x))


class AnswerModule(nn.Module):
    def __init__(self, num_answers: int, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.attflat_visual = AttFlat(device=device)
        self.answer_cls = nn.Sequential(
            nn.Linear(FLAT_OUT, HIDDEN, device=device),
            nn.GELU(approximate="tanh"),
            Dropout(PDROP),
            nn.Linear(HIDDEN, num_answers, device=device),
        )

    def forward(self, cross_box_feature: torch.Tensor) -> torch.Tensor:
        """cross_box_feature (B*L, K, HIDDEN) -> answer_scores (B*L,
        num_answers), logits."""
        return self.answer_cls(self.attflat_visual(cross_box_feature))
