"""Index gather/group ops, channels-last, forward only.

Counterpart of ``vlp3d/ops/grouping.py`` (``gather_points``,
``group_points``). These are plain PyTorch indexing on every device for
now; the hand kernel, fused with the SA first layer, and its scatter-add
backward are ROADMAP queue B item 3.
"""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, c] = points[b, idx[b, m], c]; (B, N, C), (B, M) -> (B, M, C)."""
    c = points.shape[-1]
    index = idx.long()[:, :, None].expand(-1, -1, c)
    return torch.gather(points, 1, index)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, k, c] = points[b, idx[b, m, k], c];
    (B, N, C), (B, M, K) -> (B, M, K, C)."""
    b, m, k = idx.shape
    return gather_points(points, idx.reshape(b, m * k)).reshape(
        b, m, k, points.shape[-1]
    )
