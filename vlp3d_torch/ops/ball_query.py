"""Fixed-shape radius neighbourhood search (ball query).

Counterpart of ``vlp3d/ops/ball_query.py``: for each center, the first
``nsample`` point indices in scan order with d^2 < r^2 (d^2 summed as
(dx*dx + dy*dy) + dz*dz, r^2 rounded to float32 as JAX does), padded with
the first hit, all zeros for an empty ball.

A CUDA tensor goes to the hand-written kernels (``csrc/ball_query.cu``),
a CPU tensor to :func:`ball_query_plain`; there is no fallback between
the two. On the card the shape picks the kernel (:func:`_ball_query_plan`):
the tile kernel (centres in registers, points streamed through shared
memory, a row's points split over the blocks of a thread-block cluster)
where one of its plans beat the first, warp-a-centre kernel on an H100,
else that first kernel. A launch the card refuses raises.
"""

from __future__ import annotations

import functools

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


# bytes of shared memory a block may have (sm_90)
MAX_SMEM = 232448
# the tile kernel's shapes that chip_smoke.py sweeps at every call site
# and the card tests run: (threads a block, one centre each; blocks a
# cluster; tile points)
TILE_PLANS = tuple((threads, segs, tile) for threads in (64, 128, 256)
                   for segs in (1, 2, 4, 8, 16) for tile in (256, 512))


def plan_smem_bytes(plan, n: int, nsample: int) -> int:
    """Shared memory of one block of the tile kernel under ``plan`` for
    rows of ``n`` points (``tile_smem_bytes`` in csrc/ball_query.cu): two
    point tiles (cut to a segment), a centre's count, offset, total and
    first block, and its hit list of ``nsample | 1`` entries, 2 bytes
    each where a segment has at most 65536 points, else 4."""
    threads, segs, tile = plan
    seg = -(-n // segs)
    tile = max(4, min(tile, -(-seg // 4) * 4))
    entry = 2 if seg <= 65536 else 4
    return 4 * (6 * tile + 4 * threads) + entry * threads * (nsample | 1)


def tile_plans(n: int, nsample: int):
    """The plans of :data:`TILE_PLANS` the card takes for rows of ``n``
    points and ``nsample`` slots: within shared memory, and no segment
    shorter than 64 points."""
    for plan in TILE_PLANS:
        segs = plan[1]
        if (plan_smem_bytes(plan, n, nsample) <= MAX_SMEM
                and (segs == 1 or -(-n // segs) >= 64)):
            yield plan


@functools.lru_cache(maxsize=None)
def _ball_query_plan(n: int, nsample: int):
    """(threads, blocks a cluster, tile points) of the tile kernel for
    rows of ``n`` points and ``nsample`` slots, or None for the
    warp-a-centre kernel. A row is split over a
    cluster so that a batch of a few rows fills the card: 16 segments of
    a long row (SA1), 8 of a 2048-point row (SA2). Shorter rows keep the
    first kernel, which stops a centre's scan at its nsample-th hit and
    there beat every tile plan (chip_smoke.py prints the sweep of both on
    an H100)."""
    if n < 2048 or nsample < 1:
        return None
    plan = (128, 16, 256) if n >= 16384 else (128, 8, 256)
    if plan_smem_bytes(plan, n, nsample) > MAX_SMEM:
        return None
    return plan


def _ball_query_cuda(radius, nsample, xyz, new_xyz, with_count, plan=None):
    """``plan`` is for measurements only: a tuple of the tile kernel (see
    :func:`_ball_query_plan`) or "warp" for the first kernel; callers
    leave it None and the shape decides."""
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
    if plan is None:
        plan = _ball_query_plan(n, nsample) or "warp"
    args = (xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, _r2(radius),
            nsample, idx.data_ptr(),
            None if count is None else count.data_ptr())
    with _kernels.on_device(xyz):
        if plan == "warp":
            rc = _kernels.function("ball_query", "vlp3d_ball_query")(
                *args, _kernels.stream_ptr(xyz))
        else:
            rc = _kernels.function("ball_query", "vlp3d_ball_query_tile")(
                *args, *plan, _kernels.stream_ptr(xyz))
        if rc != 0:
            _kernels.check(rc, f"ball query kernel ({plan})")
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
