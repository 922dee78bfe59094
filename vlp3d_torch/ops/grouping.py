"""Index gather/group ops, channels-last, with their backward.

Counterpart of ``vlp3d/ops/grouping.py`` (``gather_points``,
``group_points`` and their custom VJPs). ``gather_points`` is the K = 1
case of ``group_points``; both go through one row gather.

A CUDA tensor goes to the hand-written kernels (``csrc/grouping.cu``): the
forward row gather and, under autograd, the atomic scatter-add backward,
bound in one :class:`torch.autograd.Function`. A CPU tensor goes to the
plain version (``torch.gather``, whose autograd backward is the ordered
scatter-add). There is no fallback between the two. Indices carry no
gradient and must lie in [0, N): on the CPU ``torch.gather`` raises for
one that does not, on the card the kernels never follow it (the output
row is zeros, the gradient row is dropped) rather than spend a
synchronising check on every call.

The atomic backward sums colliding rows in an order that changes from
launch to launch: it agrees with :func:`group_points_grad_plain` up to
float32 rounding of a reordered sum (:data:`GRAD_RTOL` of the largest
absolute row sum), not bit for bit.
"""

from __future__ import annotations

import torch

from vlp3d_torch.ops import _kernels

# backward tolerance against the ordered plain sum, relative to the sum of
# absolute values that meet in one source row: float32 rounding (6e-8 a
# step) over the at most few hundred colliding rows of a neighbourhood
# table, with a wide margin
GRAD_RTOL = 1e-5


def group_points_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch row gather: (B, N, C), (B, R) -> (B, R, C)."""
    index = idx.long()[:, :, None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, index)


def group_points_grad_plain(grad: torch.Tensor, idx: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Plain PyTorch backward: sum grad rows (B, R, C) into a zeroed
    (B, n, C) table at idx (B, R)."""
    b, r, c = grad.shape
    offs = torch.arange(b, device=idx.device)[:, None] * n
    flat = (idx.long() + offs).reshape(-1)
    out = torch.zeros((b * n, c), dtype=grad.dtype, device=grad.device)
    out.index_add_(0, flat, grad.reshape(b * r, c))
    return out.reshape(b, n, c)


def _aligned(*addresses: int) -> bool:
    return all(a % 16 == 0 for a in addresses)


def _group_points_cuda(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C) f32 with unit channel stride (rows and batches may
    be strided: a channel slice of a wider tensor), idx (B, R) i32."""
    _kernels.require(idx, "idx", torch.int32, 2)
    if not points.is_cuda or points.dtype != torch.float32 or points.dim() != 3:
        raise ValueError(f"points must be a CUDA float32 (B, N, C) tensor, "
                         f"got {points.dtype} {tuple(points.shape)} on "
                         f"{points.device}")
    b, n, c = points.shape
    r = idx.shape[1]
    if idx.shape[0] != b:
        raise ValueError("points and idx batch sizes differ")
    if b * r >= 2 ** 31:
        raise ValueError(f"{b * r} output rows exceed the kernel's int32 range")
    if c > 0 and n > 0 and points.stride(2) != 1:
        points = points.contiguous()
    out = torch.empty((b, r, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    row_stride, batch_stride = points.stride(1), points.stride(0)
    vec = (c % 4 == 0 and row_stride % 4 == 0 and batch_stride % 4 == 0
           and _aligned(points.data_ptr(), out.data_ptr()))
    lib = _kernels.library("grouping")
    with torch.cuda.device(points.device):
        rc = lib.vlp3d_group_points(
            points.data_ptr(), idx.data_ptr(), b, n, r, c, row_stride,
            batch_stride, int(vec), out.data_ptr(),
            _kernels.stream_ptr(points),
        )
        _kernels.check(rc, "group_points kernel")
    _kernels.launches["group_points"] += 1
    return out


def _group_points_grad_cuda(grad: torch.Tensor, idx: torch.Tensor,
                            n: int) -> torch.Tensor:
    """grad (B, R, C) f32 contiguous, idx (B, R) i32 -> (B, n, C)."""
    _kernels.require(grad, "grad", torch.float32, 3)
    _kernels.require(idx, "idx", torch.int32, 2)
    b, r, c = grad.shape
    if idx.shape != (b, r):
        raise ValueError("grad and idx shapes differ")
    dpoints = torch.zeros((b, n, c), dtype=torch.float32, device=grad.device)
    if grad.numel() == 0 or n == 0:
        return dpoints
    vec = c % 4 == 0 and _aligned(grad.data_ptr(), dpoints.data_ptr())
    lib = _kernels.library("grouping")
    with torch.cuda.device(grad.device):
        rc = lib.vlp3d_group_points_grad(
            grad.data_ptr(), idx.data_ptr(), b, r, c, n, int(vec),
            dpoints.data_ptr(), _kernels.stream_ptr(grad),
        )
        _kernels.check(rc, "group_points_grad kernel")
    _kernels.launches["group_points_grad"] += 1
    return dpoints


class _GroupPointsCuda(torch.autograd.Function):
    """Row gather on the card: forward and backward are the two kernels
    of ``csrc/grouping.cu``."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return _group_points_cuda(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _group_points_grad_cuda(grad.contiguous(), idx, ctx.n), None


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if _kernels.cuda_or_cpu(points):
        return _GroupPointsCuda.apply(points, idx.to(torch.int32).contiguous())
    return group_points_plain(points, idx)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, c] = points[b, idx[b, m], c]; (B, N, C), (B, M) -> (B, M, C)."""
    return _gather_rows(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, k, c] = points[b, idx[b, m, k], c];
    (B, N, C), (B, M, K) -> (B, M, K, C)."""
    b, m, k = idx.shape
    return _gather_rows(points, idx.reshape(b, m * k)).reshape(
        b, m, k, points.shape[-1]
    )
