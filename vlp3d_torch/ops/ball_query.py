"""Fixed-shape radius neighbourhood search (ball query).

Counterpart of ``vlp3d/ops/ball_query.py``: for each center, the first
``nsample`` point indices in scan order with d^2 < r^2 (d^2 summed as
(dx*dx + dy*dy) + dz*dz, r^2 rounded to float32 as JAX does), padded with
the first hit, all zeros for an empty ball.

A CUDA tensor goes to the hand-written kernel (``csrc/ball_query.cu``),
a CPU tensor to :func:`ball_query_plain`; there is no fallback between
the two.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops.grouping import group_points

# centers per plain-version chunk are sized to keep the (B, chunk, N)
# distance tile under this many elements
_PLAIN_TILE = 1 << 25


def _r2(radius: float) -> float:
    # JAX squares the Python float in double precision, then compares in
    # float32
    return float(np.float32(radius * radius))


def ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """Plain PyTorch ball query -> (idx (B, M, nsample) i32, count (B, M) i32)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    xyz, new_xyz = xyz.float(), new_xyz.float()
    r2 = _r2(radius)
    lane = torch.arange(n, device=xyz.device)
    slots = torch.arange(nsample, device=xyz.device)
    chunk = max(1, _PLAIN_TILE // max(b * n, 1))
    idx_parts, cnt_parts = [], []
    for s in range(0, m, chunk):
        c = new_xyz[:, s:s + chunk]
        dx = c[:, :, None, 0] - xyz[:, None, :, 0]
        dy = c[:, :, None, 1] - xyz[:, None, :, 1]
        dz = c[:, :, None, 2] - xyz[:, None, :, 2]
        in_ball = (dx * dx + dy * dy) + dz * dz < r2  # (B, c, N)
        count = in_ball.sum(-1)
        # in-ball points keep their index, the rest sort after them
        key = torch.where(in_ball, lane, n)
        if n < nsample:
            key = F.pad(key, (0, nsample - n), value=n)
        first_k = torch.topk(key, nsample, dim=-1, largest=False).values
        first = torch.where(count > 0, first_k[..., 0], 0)
        idx = torch.where(slots < count[..., None], first_k, first[..., None])
        idx_parts.append(idx)
        cnt_parts.append(count)
    return (torch.cat(idx_parts, 1).to(torch.int32),
            torch.cat(cnt_parts, 1).to(torch.int32))


def _ball_query_cuda(radius, nsample, xyz, new_xyz, with_count):
    _kernels.require(xyz, "xyz", torch.float32, 3, 3)
    _kernels.require(new_xyz, "new_xyz", torch.float32, 3, 3)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if new_xyz.shape[0] != b:
        raise ValueError("xyz and new_xyz batch sizes differ")
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    count = (torch.empty((b, m), dtype=torch.int32, device=xyz.device)
             if with_count else None)
    if b * m == 0:
        return idx, count
    with _kernels.on_device(xyz):
        rc = _kernels.function("ball_query", "vlp3d_ball_query")(
            xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, _r2(radius),
            nsample, idx.data_ptr(),
            None if count is None else count.data_ptr(),
            _kernels.stream_ptr(xyz),
        )
        _kernels.check(rc, "ball query kernel")
    _kernels.launches["ball_query"] += 1
    return idx, count


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) points, new_xyz (B, M, 3) centers -> (B, M, nsample)
    int32 indices into N."""
    with torch.no_grad():
        if _kernels.cuda_or_cpu(xyz):
            return _ball_query_cuda(radius, nsample, xyz.contiguous(),
                                    new_xyz.contiguous(), False)[0]
        return ball_query_plain(radius, nsample, xyz, new_xyz)[0]


def ball_query_with_count(radius: float, nsample: int, xyz: torch.Tensor,
                          new_xyz: torch.Tensor):
    """Like :func:`ball_query`, plus the uncapped in-ball count (B, M) int32."""
    with torch.no_grad():
        if _kernels.cuda_or_cpu(xyz):
            return _ball_query_cuda(radius, nsample, xyz.contiguous(),
                                    new_xyz.contiguous(), True)
        return ball_query_plain(radius, nsample, xyz, new_xyz)


def query_and_group(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor, features: torch.Tensor | None = None,
                    *, use_xyz: bool = True, normalize_xyz: bool = False):
    """Ball query + grouping, channels-last (QueryAndGroup,
    pointnet2_utils.py:290-372).

    Returns (grouped (B, M, nsample, 3 + C) or (..., C) without xyz,
    grouped_xyz (B, M, nsample, 3)), coordinates recentred on the query
    point and divided by the radius when ``normalize_xyz``.
    """
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = group_points(xyz, idx, new_xyz)
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        if not use_xyz:
            raise ValueError("need features when use_xyz=False")
        return grouped_xyz, grouped_xyz
    grouped_feats = group_points(features, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1), grouped_xyz
    return grouped_feats, grouped_xyz
