"""Point-axis (sequence) parallel: the raw-point stage sharded over ranks.

Counterpart of ``vlp3d/parallel/point_parallel.py``. Rank ``i`` of a
point group of W ranks owns the contiguous global slab ``[i * Nl, (i +
1) * Nl)`` of the point axis (Nl = N / W); the group is the second axis
of a :func:`~vlp3d_torch.parallel.tensor_parallel.make_grid` grid, whose
first axis shards the batch (JAX's ``(data, point)`` mesh). Because rank
order is global index order, every "first in scan order" rule of the
dense ops merges exactly across the slabs, and the outputs equal the
dense ops' on the whole cloud bit for bit:

  * :func:`fps_sharded`: start at global index 0, skip points with
    ``|p|^2 <= 1e-3``, take the largest running distance, the lowest
    global index on ties, index 0 everywhere for an all-invalid row. Each
    iteration is one launch of :func:`fps_shard_step` (the
    ``fps_shard_step`` kernel of ``csrc/point_parallel.cu``) and one
    all-gather of the candidates (JAX runs a ``pmax``, a ``pmin`` and a
    ``psum`` an iteration). Sequential in npoint: ~npoint launches and
    collectives a call, bound by the host and the collective's latency,
    not by the card's rates;
  * :func:`ball_query_sharded`: ``ball_query.cu``'s count variant on the
    slab (the first ``nsample`` in-ball local indices and the count), an
    all-gather of both, and :func:`ball_query_merge` (the
    ``ball_query_merge`` kernel): strict ``d^2 < r^2`` with the
    ``(dx^2 + dy^2) + dz^2`` order, padding with the first hit, all zeros
    for an empty ball;
  * :func:`gather_points_sharded` / :func:`group_points_sharded`: the rows
    this rank owns (:func:`gather_owned`, the ``gather_owned`` kernel;
    zeros elsewhere) summed over the group. Every rank then holds every
    row and computes the same loss, so the backward passes each rank the
    output gradient unsummed and scatters it into the rows it owns
    (``grouping.cu``'s backward, which drops indices outside [0, Nl)).

The front end (:func:`large_scene_front`) and
:func:`apply_backbone_large_scene` put them together as SA1's FPS,
centre gather and grouped neighbourhoods, the only stage that touches the
raw N-point cloud: only O(npoint x nsample) rows ever sit on one rank.
A CUDA tensor takes the kernels and NCCL, a CPU tensor the plain versions
beside them and gloo; without a process group (a group of one) the
collectives are the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops.ball_query import ball_query_with_count
from vlp3d_torch.ops.grouping import (
    _group_points_grad_cuda,
    group_points_grad_plain,
)
from vlp3d_torch.parallel.tensor_parallel import ModelGroup

LOCAL_POINTS = ModelGroup()
"""A point group of one rank and no process group: the collectives are the
identity."""

_MIN_SQ_NORM = 1e-3  # sampling_gpu.cu:105-106
_INF = 1e10
_EMPTY = -3.0  # a chunk with no points: below any real candidate (-1)
_NO_INDEX = 2 ** 31 - 1
FPS_THREADS = 256  # threads a block of the FPS step kernel
_FPS_BLOCKS = 264  # blocks an FPS step aims for (2 an SM of an H100)
_FPS_MIN_CHUNK = 256  # points a block takes at least


# ------------------------------------------------------------ collectives


def _gather(x: torch.Tensor, point: ModelGroup) -> torch.Tensor:
    """The group's ``x`` stacked in rank order along a new first axis
    (``x`` itself with one axis more without a process group)."""
    x = x.contiguous()
    if point.group is None:
        return x[None]
    import torch.distributed as dist

    out = torch.empty((point.world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=point.group)
    return out.view((point.world,) + tuple(x.shape))


def _sum(x: torch.Tensor, point: ModelGroup) -> torch.Tensor:
    if point.group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, group=point.group)
    return x


# ------------------------------------------------------------------ FPS


def fps_groups(b: int, nl: int) -> int:
    """Chunks of a row that the FPS step takes, one block each: enough
    blocks over the batch to fill the card, at least
    :data:`_FPS_MIN_CHUNK` points a chunk."""
    return max(1, min(-(-_FPS_BLOCKS // max(b, 1)),
                      -(-nl // _FPS_MIN_CHUNK)))


def _seed(xyz: torch.Tensor, rank: int) -> torch.Tensor:
    """Each rank's candidate before the first iteration (1, B, 5): rank 0
    offers global point 0, which every rank then picks; the others offer
    nothing."""
    b = xyz.shape[0]
    cand = torch.zeros((1, b, 5), dtype=torch.int32, device=xyz.device)
    as_float = cand.view(torch.float32)
    if rank == 0:
        as_float[0, :, 0] = 1.0
        as_float[0, :, 2:5] = xyz[:, 0, :]
    else:
        as_float[0, :, 0] = _EMPTY
        cand[0, :, 1] = _NO_INDEX
    return cand


def fps_shard_step_plain(xyz, temp, cands, offset: int, groups: int, t: int,
                         last: bool, out_idx):
    """Plain PyTorch FPS step: the kernel's arithmetic. ``cands`` (C, B, 5)
    int32 (distance bits, global index, x, y, z bits) of the previous
    iteration; writes the winner into ``out_idx[:, t]`` and, unless
    ``last``, min-updates ``temp`` (B, Nl) in place and returns this
    rank's candidates (groups, B, 5), one a chunk."""
    b, nl, _ = xyz.shape
    vals = cands.view(torch.float32)[..., 0]
    idx = cands[..., 1]
    top = vals.max(0).values
    at = vals == top
    win = torch.where(at, idx, _NO_INDEX).min(0).values
    row = (at & (idx == win)).int().argmax(0)
    p = cands.view(torch.float32)[row, torch.arange(b, device=xyz.device),
                                  2:5]
    out_idx[:, t] = win
    if last:
        return None
    x, y, z = xyz.unbind(-1)
    dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
    torch.minimum(temp, (dx * dx + dy * dy) + dz * dz, out=temp)
    cand = torch.where((x * x + y * y) + z * z > _MIN_SQ_NORM, temp,
                       torch.tensor(-1.0, device=xyz.device))
    chunk = -(-nl // groups)
    cp = F.pad(cand, (0, groups * chunk - nl), value=_EMPTY).view(
        b, groups, chunk)
    best = cp.max(-1).values  # (B, G)
    local = (cp == best[..., None]).int().argmax(-1) + torch.arange(
        groups, device=xyz.device)[None] * chunk
    real = local < nl
    safe = torch.where(real, local, 0)
    coords = torch.gather(xyz, 1, safe[..., None].expand(-1, -1, 3))
    out = torch.empty((groups, b, 5), dtype=torch.int32, device=xyz.device)
    out.view(torch.float32)[..., 0] = best.t()
    out[..., 1] = torch.where(real, local + offset, _NO_INDEX).t()
    out.view(torch.float32)[..., 2:5] = torch.where(
        real[..., None], coords, 0.0).transpose(0, 1)
    return out


def fps_shard_step(xyz, temp, cands, offset: int, groups: int, t: int,
                   npoint: int, last: bool, out_idx):
    """One FPS iteration on a slab (see :func:`fps_shard_step_plain`): the
    ``fps_shard_step`` kernel for CUDA tensors, the plain version for CPU
    ones."""
    if not _kernels.cuda_or_cpu(xyz):
        return fps_shard_step_plain(xyz, temp, cands, offset, groups, t,
                                    last, out_idx)
    _kernels.require(xyz, "xyz", torch.float32, 3, 3)
    _kernels.require(temp, "temp", torch.float32, 2)
    _kernels.require(cands, "cands", torch.int32, 3, 5)
    _kernels.require(out_idx, "out_idx", torch.int32, 2)
    b, nl, _ = xyz.shape
    if temp.shape != (b, nl) or cands.shape[1] != b or out_idx.shape != (
            b, npoint):
        raise ValueError("fps_shard_step: the shapes of xyz, temp, cands "
                         "and out_idx disagree")
    mine = torch.empty((groups, b, 5), dtype=torch.int32, device=xyz.device)
    with _kernels.on_device(xyz):
        rc = _kernels.function("point_parallel", "vlp3d_fps_shard_step")(
            xyz.data_ptr(), temp.data_ptr(), cands.data_ptr(),
            cands.shape[0], b, nl, offset, groups, -(-nl // groups),
            FPS_THREADS, t, npoint, int(last), out_idx.data_ptr(),
            mine.data_ptr(), _kernels.stream_ptr(xyz))
        if rc != 0:
            _kernels.check(rc, "fps shard step kernel")
    _kernels.launches["fps_shard_step"] += 1
    return None if last else mine


def fps_sharded(xyz: torch.Tensor, npoint: int,
                point: ModelGroup = LOCAL_POINTS) -> torch.Tensor:
    """FPS over a point-sharded cloud: xyz (B, Nl, 3), this rank's slab
    of the global (B, N, 3) -> (B, npoint) int32 global indices, the same
    on every rank of ``point``. No gradient."""
    with torch.no_grad():
        xyz = xyz.float().contiguous()
        b, nl, _ = xyz.shape
        out = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
        if b == 0 or npoint == 0:
            return out
        groups = fps_groups(b, nl)
        temp = torch.full((b, nl), _INF, dtype=torch.float32,
                          device=xyz.device)
        cand = _seed(xyz, point.rank)
        for t in range(npoint):
            cands = _gather(cand, point).view(-1, b, 5)
            cand = fps_shard_step(xyz, temp, cands, point.rank * nl, groups,
                                  t, npoint, t == npoint - 1, out)
        return out


# ---------------------------------------------------------- ball query


def ball_query_merge_plain(all_idx: torch.Tensor, all_cnt: torch.Tensor,
                           nl: int, nsample: int) -> torch.Tensor:
    """Plain PyTorch merge (JAX's arithmetic): all_idx (W, B, M, S) local
    first-k indices, all_cnt (W, B, M) in-ball counts -> (B, M, S) int32
    global indices."""
    w = all_idx.shape[0]
    cnt = all_cnt.long().clamp(max=nsample)
    ends = cnt.cumsum(0)
    starts = ends - cnt
    total = ends[-1]
    s = torch.arange(nsample, device=all_idx.device)
    owner = (ends[..., None] <= s).sum(0).clamp(max=w - 1)  # (B, M, S)
    start_sel = torch.gather(starts[..., None].expand(-1, -1, -1, nsample),
                             0, owner[None])[0]
    t = (s - start_sel).clamp(0, nsample - 1)
    per_shard = torch.gather(all_idx.long(), 3, t[None].expand(w, -1, -1, -1))
    picked = torch.gather(per_shard, 0, owner[None])[0]
    gidx = picked + owner * nl
    first = torch.where(total[..., None] > 0, gidx[..., :1], 0)
    return torch.where(s < total[..., None], gidx, first).to(torch.int32)


def ball_query_merge(all_idx: torch.Tensor, all_cnt: torch.Tensor, nl: int,
                     nsample: int) -> torch.Tensor:
    """The per-shard ball queries merged into global slots: the
    ``ball_query_merge`` kernel for CUDA tensors, the plain version for CPU
    ones."""
    if not _kernels.cuda_or_cpu(all_idx):
        return ball_query_merge_plain(all_idx, all_cnt, nl, nsample)
    _kernels.require(all_idx, "all_idx", torch.int32, 4, nsample)
    _kernels.require(all_cnt, "all_cnt", torch.int32, 3)
    w, b, m, _ = all_idx.shape
    if all_cnt.shape != (w, b, m):
        raise ValueError("ball_query_merge: all_idx and all_cnt disagree")
    out = torch.empty((b, m, nsample), dtype=torch.int32,
                      device=all_idx.device)
    if out.numel() == 0:
        return out
    with _kernels.on_device(all_idx):
        rc = _kernels.function("point_parallel", "vlp3d_ball_query_merge")(
            all_idx.data_ptr(), all_cnt.data_ptr(), w, b, m, nsample, nl,
            out.data_ptr(), _kernels.stream_ptr(all_idx))
        if rc != 0:
            _kernels.check(rc, "ball query merge kernel")
    _kernels.launches["ball_query_merge"] += 1
    return out


def ball_query_sharded(radius: float, nsample: int, xyz: torch.Tensor,
                       new_xyz: torch.Tensor,
                       point: ModelGroup = LOCAL_POINTS) -> torch.Tensor:
    """Ball query with the support points sharded over ``point``: xyz
    (B, Nl, 3) this rank's slab, new_xyz (B, M, 3) the centres, the same
    on every rank -> (B, M, nsample) int32 global indices, the same on
    every rank, equal to the dense ball query on the whole cloud."""
    with torch.no_grad():
        idx, cnt = ball_query_with_count(radius, nsample, xyz, new_xyz)
        return ball_query_merge(_gather(idx, point), _gather(cnt, point),
                                xyz.shape[1], nsample)


# ------------------------------------------- ranks emulated in one process


def fps_emulated(xyz: torch.Tensor, w: int, npoint: int) -> list:
    """:func:`fps_sharded` over ``w`` ranks emulated in one process, the
    all-gather a concatenation of the ranks' candidates: xyz (B, N, 3)
    the whole cloud -> every rank's (B, npoint) int32 indices. Checks the
    FPS step's merge across slabs without a process group."""
    with torch.no_grad():
        b, n, _ = xyz.shape
        nl = n // w
        slabs = [xyz[:, i * nl:(i + 1) * nl].contiguous() for i in range(w)]
        outs = [torch.zeros((b, npoint), dtype=torch.int32,
                            device=xyz.device) for _ in range(w)]
        temps = [torch.full((b, nl), _INF, dtype=torch.float32,
                            device=xyz.device) for _ in range(w)]
        groups = fps_groups(b, nl)
        cands = [_seed(s, i) for i, s in enumerate(slabs)]
        for t in range(npoint):
            gathered = torch.cat(cands)
            cands = [fps_shard_step(slabs[i], temps[i], gathered, i * nl,
                                    groups, t, npoint, t == npoint - 1,
                                    outs[i]) for i in range(w)]
        return outs


def ball_query_emulated(radius: float, nsample: int, xyz: torch.Tensor,
                        new_xyz: torch.Tensor, w: int,
                        merge=ball_query_merge) -> torch.Tensor:
    """:func:`ball_query_sharded` over ``w`` ranks emulated in one process
    (the all-gather a stack), with ``merge`` (:func:`ball_query_merge` or
    its plain version) -> (B, M, nsample) int32 global indices."""
    with torch.no_grad():
        nl = xyz.shape[1] // w
        parts = [ball_query_with_count(
            radius, nsample, xyz[:, i * nl:(i + 1) * nl].contiguous(),
            new_xyz) for i in range(w)]
        return merge(torch.stack([p[0] for p in parts]),
                     torch.stack([p[1] for p in parts]), nl, nsample)


# --------------------------------------------------------- owned rows


def gather_owned_plain(points: torch.Tensor, gidx: torch.Tensor,
                       offset: int) -> torch.Tensor:
    """Plain PyTorch owned-rows gather: points (B, Nl, C), gidx (B, R)
    global -> (B, R, C), zeros where another rank owns the index."""
    b, nl, c = points.shape
    local = gidx.long() - offset
    own = (local >= 0) & (local < nl)
    rows = torch.gather(points, 1, torch.where(own, local, 0)[..., None]
                        .expand(-1, -1, c))
    return torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def gather_owned(points: torch.Tensor, gidx: torch.Tensor,
                 offset: int) -> torch.Tensor:
    """The rows of this rank's slab at global indices (see
    :func:`gather_owned_plain`): the ``gather_owned`` kernel for CUDA
    tensors, the plain version for CPU ones. No autograd (see
    :func:`group_points_sharded`)."""
    if not _kernels.cuda_or_cpu(points):
        return gather_owned_plain(points, gidx, offset)
    points = points.contiguous()
    _kernels.require(points, "points", torch.float32, 3)
    _kernels.require(gidx, "gidx", torch.int32, 2)
    b, nl, c = points.shape
    r = gidx.shape[1]
    out = torch.empty((b, r, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    with _kernels.on_device(points):
        rc = _kernels.function("point_parallel", "vlp3d_gather_owned")(
            points.data_ptr(), gidx.data_ptr(), b, nl, r, c, offset,
            out.data_ptr(), _kernels.stream_ptr(points))
        if rc != 0:
            _kernels.check(rc, "gather owned kernel")
    _kernels.launches["gather_owned"] += 1
    return out


class _OwnedRows(torch.autograd.Function):
    """The owned rows summed over the point group. Every rank computes the
    same loss from the replicated sum, so the backward scatters the output
    gradient, unsummed, into the rows this rank owns."""

    @staticmethod
    def forward(ctx, points, gidx, point):
        offset = point.rank * points.shape[1]
        ctx.save_for_backward(gidx)
        ctx.offset, ctx.n = offset, points.shape[1]
        return _sum(gather_owned(points, gidx, offset), point)

    @staticmethod
    def backward(ctx, grad):
        (gidx,) = ctx.saved_tensors
        local = (gidx - ctx.offset).to(torch.int32)
        grad = grad.contiguous()
        if grad.is_cuda:
            dpoints = _group_points_grad_cuda(grad, local.contiguous(), ctx.n)
        else:
            dpoints = group_points_grad_plain(grad, local, ctx.n)
        return dpoints, None, None


def group_points_sharded(points: torch.Tensor, gidx: torch.Tensor,
                         point: ModelGroup = LOCAL_POINTS) -> torch.Tensor:
    """out[b, ..., c] = global_points[b, gidx[b, ...], c] for a table
    sharded over ``point`` (points (B, Nl, C), gidx (B, M) or (B, M, K)
    global) -> gidx.shape + (C,), the same on every rank; differentiable
    in ``points``."""
    b = gidx.shape[0]
    flat = gidx.reshape(b, -1).to(torch.int32).contiguous()
    points = points.float()
    if torch.is_grad_enabled() and points.requires_grad:
        out = _OwnedRows.apply(points, flat, point)
    else:
        out = _sum(gather_owned(points, flat, point.rank * points.shape[1]),
                   point)
    return out.reshape(*gidx.shape, points.shape[-1])


gather_points_sharded = group_points_sharded
"""out[b, m, c] = global_points[b, gidx[b, m], c] for a sharded table (the
K = 1 form of :func:`group_points_sharded`)."""


# ---------------------------------------------------------- the front


def query_and_group_sharded(radius: float, nsample: int, xyz, new_xyz,
                            features=None, *, use_xyz: bool = True,
                            normalize_xyz: bool = False,
                            point: ModelGroup = LOCAL_POINTS):
    """Point-sharded ``query_and_group`` (xyz and features sharded, the
    centres and outputs replicated) -> (grouped (B, M, nsample, 3[+C]),
    grouped_xyz (B, M, nsample, 3))."""
    idx = ball_query_sharded(radius, nsample, xyz, new_xyz, point)
    grouped_xyz = group_points_sharded(xyz, idx, point) - new_xyz[:, :, None]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        if not use_xyz:
            raise ValueError("need features when use_xyz=False")
        return grouped_xyz, grouped_xyz
    grouped_feats = group_points_sharded(features, idx, point)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1), grouped_xyz
    return grouped_feats, grouped_xyz


def large_scene_front(point: ModelGroup, npoint: int, radius: float,
                      nsample: int, *, use_xyz: bool = True,
                      normalize_xyz: bool = True):
    """The point-sharded SA front end: ``run(xyz (B, Nl, 3), features
    (B, Nl, C) | None) -> (new_xyz (B, npoint, 3), grouped (B, npoint,
    nsample, 3[+C]), fps_inds (B, npoint))`` on this rank's slab of each
    of this data rank's scenes; every output is the same on every rank of
    ``point`` and equals the dense SA1 inputs on the whole cloud."""

    def run(xyz, features=None):
        fps_idx = fps_sharded(xyz, npoint, point)
        new_xyz = gather_points_sharded(xyz, fps_idx, point)
        grouped, _ = query_and_group_sharded(
            radius, nsample, xyz, new_xyz, features, use_xyz=use_xyz,
            normalize_xyz=normalize_xyz, point=point)
        return new_xyz, grouped, fps_idx

    return run


def apply_backbone_large_scene(backbone, point_clouds: torch.Tensor,
                               point: ModelGroup = LOCAL_POINTS) -> dict:
    """The backbone on a scene sharded over ``point``: point_clouds (B,
    Nl, 3 + C) this rank's slab. SA1's FPS, ball query and grouping run
    point-sharded (:func:`large_scene_front`), the rest of the backbone on
    their small outputs with the same parameters as a dense forward
    (``sa1_precomputed``); returns the dense forward's dict."""
    sa1 = backbone.sa1
    front = large_scene_front(point, sa1.npoint, sa1.radius, sa1.nsample)
    features = point_clouds[..., 3:] if point_clouds.shape[-1] > 3 else None
    return backbone(point_clouds,
                    sa1_precomputed=front(point_clouds[..., :3], features))

