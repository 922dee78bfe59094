"""Furthest point sampling (FPS).

Counterpart of ``vlp3d/ops/sampling.py``: start at index 0, never pick a
point with squared norm <= 1e-3, pick the masked argmax of the running
min squared distance each step, lowest index on ties; forward only.

A CUDA tensor goes to the hand-written kernels (``csrc/fps.cu``), a CPU
tensor to :func:`fps_plain`; there is no fallback between the two. On the
card the row length alone picks the kernel (:func:`_fps_plan`): one small
block a row with the points in registers, one thread-block cluster a row
for long rows, and the one-block kernel with a global scratch for rows
too long for a cluster. A launch the card refuses raises.
"""

from __future__ import annotations

import torch

from vlp3d_torch.ops import _kernels

_MIN_SQ_NORM = 1e-3
_INF = 1e10


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS over a batch. xyz (B, N, 3) f32 -> (B, npoint) i32."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    valid = (x * x + y * y) + z * z > _MIN_SQ_NORM
    temp = torch.full((b, n), _INF, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    old = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    neg = torch.tensor(-1.0, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, old]  # (B, 3)
        dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
        temp = torch.minimum(temp, (dx * dx + dy * dy) + dz * dz)
        # torch.argmax returns the first maximal index
        old = torch.argmax(torch.where(valid, temp, neg), dim=1)
        out[:, j] = old
    return out.to(torch.int32)


# points a thread of fps_regs_kernel may hold, and the most threads a
# block may then have (the limits of csrc/fps.cu)
_REGS_THREADS = {2: 1024, 4: 1024, 8: 512, 16: 512, 32: 256}
# rows up to this length go to one block, longer ones to a cluster
_ONE_BLOCK_N = 4096
_CLUSTER = 16


def _fps_plan(n: int) -> tuple[int, int] | None:
    """(blocks a row, points a thread) of the points-in-registers kernel
    for rows of ``n`` points; None where a row is too long for it. A step
    is bound by latency, so a thread holds as few points as fit in 512
    threads a block; chosen by timing each main-path row length on an
    H100 (chip_smoke.py prints the sweep)."""
    blocks = 1 if n <= _ONE_BLOCK_N else _CLUSTER
    share = -(-n // blocks)
    for points, most in _REGS_THREADS.items():
        if -(-share // points) <= min(most, 512):
            return blocks, points
    return None


def _fps_cuda(xyz: torch.Tensor, npoint: int,
              plan: tuple[int, int] | str | None = None) -> torch.Tensor:
    """``plan`` is for measurements only: (blocks a row, points a thread)
    of the points-in-registers kernel, or "shared" / "global" for the
    one-block-a-row kernel with its distances there; callers leave it
    None and the row length decides."""
    _kernels.require(xyz, "xyz", torch.float32, 3, 3)
    b, n, _ = xyz.shape
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0 or npoint == 0:
        return out
    if n == 0:
        return out.zero_()
    if plan is None:
        plan = _fps_plan(n) or "global"
    with _kernels.on_device(xyz):
        if isinstance(plan, tuple):
            rc = _kernels.function("fps", "vlp3d_fps_regs")(
                xyz.data_ptr(), b, n, npoint, out.data_ptr(), plan[0],
                plan[1], _kernels.stream_ptr(xyz))
        else:
            # rows too long for registers: running distances in a scratch
            temp = (torch.empty((b, n), dtype=torch.float32,
                                device=xyz.device)
                    if plan == "global" else None)
            rc = _kernels.function("fps", "vlp3d_fps")(
                xyz.data_ptr(), b, n, npoint, out.data_ptr(),
                None if temp is None else temp.data_ptr(),
                _kernels.stream_ptr(xyz))
        if rc != 0:
            _kernels.check(rc, f"fps kernel ({plan})")
    _kernels.launches["fps"] += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative furthest point sampling.

    xyz: (B, N, 3) float32. Returns (B, npoint) int32 indices into N.
    No gradient flows through this op.
    """
    with torch.no_grad():
        if _kernels.cuda_or_cpu(xyz):
            return _fps_cuda(xyz.contiguous(), npoint)
        return fps_plain(xyz, npoint)
