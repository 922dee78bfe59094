"""Chamfer nearest-neighbour distance and the huber loss.

Counterpart of ``vlp3d/geometry/nn_distance.py`` (utils/nn_distance.py of
the reference).
"""

from __future__ import annotations

import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """0.5 x^2 for |x| <= delta, else 0.5 delta^2 + delta (|x| - delta)."""
    abs_error = error.abs()
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, *,
                l1smooth: bool = False, delta: float = 1.0, l1: bool = False):
    """Bidirectional nearest-neighbour distance: pc1 (B, N, C), pc2
    (B, M, C) -> dist1 (B, N), idx1 (B, N) int32, dist2 (B, M), idx2
    (B, M) int32. The distance is squared L2, L1 (``l1``) or summed huber
    (``l1smooth``); ties go to the lowest index."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]  # (B, N, M, C)
    if l1smooth:
        d = huber_loss(diff, delta).sum(dim=-1)
    elif l1:
        d = diff.abs().sum(dim=-1)
    else:
        d = (diff ** 2).sum(dim=-1)
    dist1, idx1 = _min_first(d, 2)
    dist2, idx2 = _min_first(d, 1)
    return dist1, idx1, dist2, idx2


def _min_first(d: torch.Tensor, dim: int):
    """min over ``dim`` and the lowest index that attains it."""
    dist = d.amin(dim=dim)
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    lane = torch.arange(n, device=d.device).reshape(shape)
    idx = torch.where(d == dist.unsqueeze(dim), lane, n).amin(dim=dim)
    return dist, idx.to(torch.int32)
