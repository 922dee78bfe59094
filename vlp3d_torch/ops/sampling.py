"""Furthest point sampling (FPS).

Counterpart of ``vlp3d/ops/sampling.py``: start at index 0, never pick a
point with squared norm <= 1e-3, pick the masked argmax of the running
min squared distance each step, lowest index on ties; forward only.

A CUDA tensor goes to the hand-written kernel (``csrc/fps.cu``), a CPU
tensor to :func:`fps_plain`; there is no fallback between the two.
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


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    _kernels.require(xyz, "xyz", torch.float32, 3, 3)
    b, n, _ = xyz.shape
    lib = _kernels.library("fps")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0 or npoint == 0:
        return out
    with torch.cuda.device(xyz.device):
        temp = None
        if n * 4 > lib.vlp3d_fps_smem_limit():
            # too many points for shared memory: global scratch
            temp = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
        rc = lib.vlp3d_fps(
            xyz.data_ptr(), b, n, npoint, out.data_ptr(),
            None if temp is None else temp.data_ptr(),
            _kernels.stream_ptr(xyz),
        )
        _kernels.check(rc, "fps kernel")
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
