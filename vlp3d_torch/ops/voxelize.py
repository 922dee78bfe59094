"""Dynamic and hard voxelization (PointPillars).

Counterpart of ``vlp3d/ops/voxelize.py``:

  * dynamic: each point's integer voxel (x, y, z), -1 on every axis when
    it lies outside the range, and the grid;
  * hard: voxels allocated in point-scan order (the first point of a new
    cell allocates the next voxel id), each keeping its first
    ``max_points`` points in scan order, allocation stopping at
    ``max_voxels``; outputs padded to ``max_voxels`` with a count and a
    mask, as JAX returns them.

A cell is ``floor((p - lo) / vs)`` in float32 with a true division, the
grid ``round((hi - lo) / vs)`` (half to even) computed once on the host
in float32. A leading batch axis is vmapped: points (B, N, C) give
outputs with B in front, in one launch of each kernel.

A CUDA tensor goes to the hand-written kernels (``csrc/voxelize.cu``), a
CPU tensor to :func:`dynamic_voxelize_plain` / :func:`hard_voxelize_plain`;
there is no fallback between the two. The hard kernel's cell table holds
:func:`table_slots` entries a batch row, sized by the points and never by
the grid: a grid of no more cells addresses it by the cell key (direct),
a larger one hashes the key into it, chosen from the grid before the
launch. So both paths take any grid of JAX's int32 cell keys: up to :data:`MAX_GRID_CELLS` cells, past which JAX's sentinel
key ``cells + 1`` overflows and both raise (ROADMAP C28); the plain path
finds each cell's first point by a stable sort of the keys, as JAX does,
in memory that grows with the points. ``voxels`` carries a gradient to
``points``: a kept point gets its slot's gradient, a dropped point 0, as
JAX's scatter gives.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vlp3d_torch.ops import _kernels

# the largest grid JAX's int32 keys take: its sentinel key for a point
# outside the range is cells + 1
MAX_GRID_CELLS = 2 ** 31 - 2
# points a tile of the kernel's prefix sum (kTile in csrc/voxelize.cu)
VOXEL_TILE = 2048


def grid_cells(grid) -> int:
    """Cells of ``grid`` (gx, gy, gz); raises past :data:`MAX_GRID_CELLS`,
    where JAX's int32 keys stop (ROADMAP C28)."""
    cells = int(grid[0]) * int(grid[1]) * int(grid[2])
    if cells > MAX_GRID_CELLS:
        raise ValueError(f"a grid of {cells} cells is past JAX's int32 cell "
                         f"keys ({MAX_GRID_CELLS} cells at most, ROADMAP C28)")
    return cells


def table_slots(n: int) -> int:
    """Entries of the hard kernel's cell table a batch row of ``n`` points:
    the power of two of at least 2 n and at least 64, at most 2^31 (past
    2^30 points more than half full, and still never full: a row holds
    fewer than 2^31 points). The kernel takes exactly this rule."""
    return min(1 << 31, max(64, 1 << max(0, 2 * n - 1).bit_length()))


def hard_workspace_ints(b: int, n: int, max_voxels: int) -> int:
    """int32 words of the hard kernel's workspace for B rows of n points:
    the keys and segments a point, the scan's status words (two ints a
    tile) and ticket, the cell table (tag, head, count a slot), up to
    three ints of padding, four ints a voxel. The grid plays no part."""
    tiles = -(-n // VOXEL_TILE)
    return (2 * b * n + 2 * b * tiles + 2 + 3 * b * table_slots(n) + 3
            + 4 * b * max_voxels)


def _grid(voxel_size, coors_range):
    """(lo, vs, grid): the range's low corner and the voxel size rounded
    to float32, and the grid round((hi - lo) / vs) computed in float32,
    half to even, as JAX computes it; worked out once a configuration."""
    return _grid_of(tuple(map(float, voxel_size)),
                    tuple(map(float, coors_range)))


@functools.lru_cache(maxsize=64)
def _grid_of(voxel_size: tuple, coors_range: tuple):
    vs = np.asarray(voxel_size, np.float32)
    lo = np.asarray(coors_range[:3], np.float32)
    hi = np.asarray(coors_range[3:], np.float32)
    grid = np.round((hi - lo) / vs).astype(np.int32)
    return (tuple(float(x) for x in lo), tuple(float(x) for x in vs),
            tuple(int(x) for x in grid))


_grid_tensors: dict = {}


def _grid_tensor(grid, device) -> torch.Tensor:
    """The (3,) int32 grid on ``device``, made once (a copy from the host
    a call would wait for the stream)."""
    key = (tuple(grid), str(device))
    t = _grid_tensors.get(key)
    if t is None:
        t = _grid_tensors[key] = torch.tensor(key[0], dtype=torch.int32,
                                              device=device)
    return t


def dynamic_voxelize_plain(points, voxel_size, coors_range):
    """Plain PyTorch :func:`dynamic_voxelize` (any leading axes)."""
    lo, vs, grid = _grid(voxel_size, coors_range)
    f32 = dict(dtype=torch.float32, device=points.device)
    p = points[..., :3].detach().float()
    c = torch.floor((p - torch.tensor(lo, **f32)) / torch.tensor(vs, **f32))
    valid = ((c >= 0) & (c < torch.tensor(grid, **f32))).all(-1)
    coords = torch.where(valid[..., None], c, torch.full_like(c, -1.0))
    return coords.to(torch.int32), _grid_tensor(grid, points.device)


def _dynamic_cuda(points, voxel_size, coors_range):
    lo, vs, grid = _grid(voxel_size, coors_range)
    _kernels.require(points, "points", torch.float32, points.dim())
    c = points.shape[-1]
    if c < 3:
        raise ValueError(f"points have {c} channels, need x, y, z")
    coords = torch.empty(points.shape[:-1] + (3,), dtype=torch.int32,
                         device=points.device)
    total = points.numel() // c
    with _kernels.on_device(points):
        rc = _kernels.function("voxelize", "vlp3d_dynamic_voxelize")(
            points.data_ptr(), total, c, *lo, *vs, *grid, coords.data_ptr(),
            _kernels.stream_ptr(points))
        _kernels.check(rc, "dynamic_voxelize kernel")
    _kernels.launches["dynamic_voxelize"] += 1
    return coords, _grid_tensor(grid, points.device)


def dynamic_voxelize(points, voxel_size, coors_range):
    """points (..., N, >=3) -> coords (..., N, 3) i32 in (x, y, z), -1 if
    outside; grid (3,) i32. No gradient."""
    with torch.no_grad():
        if _kernels.cuda_or_cpu(points):
            return _dynamic_cuda(points.contiguous(), voxel_size,
                                 coors_range)
        return dynamic_voxelize_plain(points, voxel_size, coors_range)


def _hard_plain(points, coords, grid, max_points, max_voxels):
    """One batch row: (voxels, coors, num, voxel_num, mask, slot) where
    slot (N,) is each point's voxel * max_points + rank, -1 if dropped."""
    n, c_feat = points.shape
    dev = points.device
    g = [int(x) for x in grid]
    valid = coords[:, 0] >= 0
    key = ((coords[:, 2].long() * g[1] + coords[:, 1]) * g[0]
           + coords[:, 0])
    key = torch.where(valid, key, grid_cells(g))  # outside: a spare cell
    idx = torch.arange(n, device=dev)
    # each cell's first point, the head of its run in a stable sort of the
    # keys; heads ranked in point order are voxel ids
    key_s, order = torch.sort(key, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = key_s[1:] != key_s[:-1]
    first = torch.empty_like(idx)
    first[order] = order[new][torch.cumsum(new.long(), 0) - 1]
    is_head = valid & (first == idx)
    vid = torch.where(valid, (torch.cumsum(is_head.long(), 0) - 1)[first],
                      -1)
    kept = valid & (vid < max_voxels)
    # rank within the voxel in point order: a stable sort by voxel id
    by_voxel, order = torch.sort(torch.where(kept, vid, max_voxels),
                                 stable=True)
    start = torch.searchsorted(by_voxel, by_voxel)
    rank = torch.empty_like(idx)
    rank[order] = idx - start
    kept = kept & (rank < max_points)
    slot = torch.where(kept, vid * max_points + rank, torch.full_like(idx, -1))
    voxels = torch.zeros((max_voxels * max_points, c_feat), dtype=points.dtype,
                         device=dev)
    voxels[slot[kept]] = points[kept]
    n_cells = int(is_head.sum())
    voxel_num = min(n_cells, max_voxels)
    num = torch.zeros(max_voxels, dtype=torch.long, device=dev)
    num.index_add_(0, vid[kept], torch.ones_like(vid[kept]))
    coors = torch.full((max_voxels, 3), -1, dtype=torch.int32, device=dev)
    heads = is_head & (vid < max_voxels)
    coors[vid[heads]] = coords[heads]
    mask = torch.arange(max_voxels, device=dev) < voxel_num
    return (voxels.view(max_voxels, max_points, c_feat), coors,
            num.to(torch.int32), voxel_num, mask, slot.to(torch.int32))


def hard_voxelize_plain(points, voxel_size, coors_range, max_points,
                        max_voxels):
    """Plain PyTorch hard voxelization of (B, N, C) points: the outputs of
    :func:`hard_voxelize` stacked over B, and each point's slot."""
    grid_cells(_grid(voxel_size, coors_range)[2])
    if points.shape[0] == 0:
        return _empty(points, max_points, max_voxels)
    coords, grid = dynamic_voxelize_plain(points, voxel_size, coors_range)
    rows = [_hard_plain(points[b], coords[b], grid, max_points, max_voxels)
            for b in range(points.shape[0])]
    voxels, coors, num, mask, slot = (torch.stack([r[k] for r in rows])
                                      for k in (0, 1, 2, 4, 5))
    voxel_num = torch.tensor([r[3] for r in rows], dtype=torch.int32,
                             device=points.device)
    return voxels, coors, num, voxel_num, mask, slot


def _empty(points, max_points, max_voxels):
    b, n, c = points.shape
    dev = points.device
    return (torch.zeros((b, max_voxels, max_points, c), dtype=points.dtype,
                        device=dev),
            torch.full((b, max_voxels, 3), -1, dtype=torch.int32, device=dev),
            torch.zeros((b, max_voxels), dtype=torch.int32, device=dev),
            torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.zeros((b, max_voxels), dtype=torch.bool, device=dev),
            torch.full((b, n), -1, dtype=torch.int32, device=dev))


def _hard_cuda(points, voxel_size, coors_range, max_points, max_voxels):
    _kernels.require(points, "points", torch.float32, 3)
    b, n, c = points.shape
    g = _grid(voxel_size, coors_range)[2]
    cells = grid_cells(g)
    if b * n >= 2 ** 31 or b * max_voxels >= 2 ** 31 \
            or b * max_voxels * max_points * c >= 2 ** 40:
        raise ValueError(f"points {tuple(points.shape)} too large")
    if b == 0:
        return _empty(points, max_points, max_voxels)
    coords, _ = _dynamic_cuda(points, voxel_size, coors_range)
    dev = points.device
    voxels = torch.empty((b, max_voxels, max_points, c), dtype=torch.float32,
                         device=dev)
    coors = torch.empty((b, max_voxels, 3), dtype=torch.int32, device=dev)
    num = torch.empty((b, max_voxels), dtype=torch.int32, device=dev)
    voxel_num = torch.empty((b,), dtype=torch.int32, device=dev)
    mask = torch.empty((b, max_voxels), dtype=torch.bool, device=dev)
    slot = torch.empty((b, n), dtype=torch.int32, device=dev)
    work = torch.empty(hard_workspace_ints(b, n, max_voxels),
                       dtype=torch.int32, device=dev)
    slots = table_slots(n)
    with _kernels.on_device(points):
        rc = _kernels.function("voxelize", "vlp3d_hard_voxelize")(
            points.data_ptr(), coords.data_ptr(), b, n, c, *g, slots,
            cells <= slots, max_points, max_voxels, work.data_ptr(),
            voxels.data_ptr(), coors.data_ptr(), num.data_ptr(),
            voxel_num.data_ptr(), mask.data_ptr(), slot.data_ptr(),
            _kernels.stream_ptr(points))
        _kernels.check(rc, "hard_voxelize kernel")
    _kernels.launches["hard_voxelize"] += 1
    return voxels, coors, num, voxel_num, mask, slot


class _HardVoxelize(torch.autograd.Function):
    """``voxels`` with a gradient to ``points``: the backward gathers each
    kept point's slot of the incoming gradient (JAX computes it in XLA,
    outside any kernel, so plain indexing here too)."""

    @staticmethod
    def forward(ctx, points, voxel_size, coors_range, max_points,
                max_voxels):
        with torch.no_grad():
            if _kernels.cuda_or_cpu(points):
                out = _hard_cuda(points.contiguous(), voxel_size,
                                 coors_range, max_points, max_voxels)
            else:
                out = hard_voxelize_plain(points, voxel_size, coors_range,
                                          max_points, max_voxels)
        ctx.save_for_backward(out[5])
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, grad_voxels, *_):
        (slot,) = ctx.saved_tensors
        b, v, p, c = grad_voxels.shape
        flat = grad_voxels.reshape(b, v * p, c)
        kept = (slot >= 0)[..., None]
        rows = slot.clamp(min=0).long()[..., None].expand(-1, -1, c)
        grad = torch.gather(flat, 1, rows) * kept
        return grad, None, None, None, None


def hard_voxelize(points, voxel_size, coors_range, max_points: int = 35,
                  max_voxels: int = 20000):
    """Fixed-shape hard voxelization of points (N, C) or (B, N, C).

    Returns dict: voxels (max_voxels, max_points, C); coors
    (max_voxels, 3) i32 (x, y, z), -1 padded; num_points_per_voxel
    (max_voxels,) i32; voxel_num () i32; voxel_mask (max_voxels,) bool;
    each with B in front for batched points.
    """
    single = points.dim() == 2
    pts = points[None] if single else points
    voxels, coors, num, voxel_num, mask, _ = _HardVoxelize.apply(
        pts, tuple(voxel_size), tuple(coors_range), int(max_points),
        int(max_voxels))
    out = {"voxels": voxels, "coors": coors, "num_points_per_voxel": num,
           "voxel_num": voxel_num, "voxel_mask": mask}
    return {k: v[0] for k, v in out.items()} if single else out
