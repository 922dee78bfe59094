"""Index gather/group ops, channels-last, with their backward.

Counterpart of ``vlp3d/ops/grouping.py`` (``gather_points``,
``group_points`` and their custom VJPs). ``gather_points`` is the K = 1
case of ``group_points``; both go through one row gather.

A CUDA tensor goes to the hand-written kernels (``csrc/grouping.cu``): the
forward row gather (which can subtract a row a centre on the way) and,
where an input needs a gradient, the scatter-add backward, bound in one
:class:`torch.autograd.Function`. A CPU tensor goes to the
plain version (``torch.gather``, whose autograd backward is the ordered
scatter-add). There is no fallback between the two. Indices carry no
gradient. An index outside [0, N) follows the JAX package's
``gather_points`` on both paths, in its own batch row, with no
synchronising check: one in [-N, 0) reads row index + N, any other gives
a row of NaN (the subtrahend does not change that), and the backward
passes a gradient only to indices in [0, N), so a wrapped index reads
its row but sends nothing back. JAX's ``group_points`` differs where it
gathers several batch rows from one flattened table (B > 1 and tables
under 2^18 rows, as at every ``group_points`` site of the main path):
there such an index reads a row of another batch row. The port keeps
the per-row rule (ROADMAP.md C4).

The backward's shape picks its kernel (:func:`_grad_plan`): the sorted
kernel (a counting sort of the indices in shared memory, then one sum a
source row in ascending gradient-row order, every row written once, so
no zeroed table and the same bits from every launch), or, for tables too
large for its index passes, the atomic kernel into a zeroed table, whose
order changes from launch to launch. Both agree with
:func:`group_points_grad_plain` up to float32 rounding of a reordered sum
(:data:`GRAD_RTOL` of the absolute sum meeting in a row), not bit for
bit.
"""

from __future__ import annotations

import functools

import torch

from vlp3d_torch.ops import _kernels

# backward tolerance against the ordered plain sum, relative to the sum of
# absolute values that meet in one source row: float32 rounding (6e-8 a
# step) over the at most few hundred colliding rows of a neighbourhood
# table, with a wide margin
GRAD_RTOL = 1e-5


def group_points_plain(points: torch.Tensor, idx: torch.Tensor,
                       sub: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch row gather: points (B, N, C), idx (B, R) or
    (B, M, K) -> idx.shape + (C,), minus ``sub`` (B, M, C) broadcast over
    K where given. Out-of-range indices as the module docstring says."""
    b, n, c = points.shape
    flat = idx.reshape(b, -1).long()
    rows = torch.where(flat < 0, flat + n, flat)
    exists = (rows >= 0) & (rows < n)
    index = torch.where(exists, rows, 0)[:, :, None].expand(-1, -1, c)
    out = torch.gather(points, 1, index)
    if out.requires_grad:
        # a wrapped index reads its row and passes no gradient back
        out = torch.where((flat >= 0)[:, :, None], out, out.detach())
    out = torch.where(exists[:, :, None], out, float("nan"))
    out = out.reshape(*idx.shape, c)
    if sub is not None:
        out = out - sub[:, :, None, :]
    return out


def group_points_grad_plain(grad: torch.Tensor, idx: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Plain PyTorch backward: sum grad rows (B, R, C) into a zeroed
    (B, n, C) table at idx (B, R); rows of indices outside [0, n) go to a
    spare row that is dropped."""
    b, r, c = grad.shape
    offs = torch.arange(b, device=idx.device)[:, None] * n
    live = (idx >= 0) & (idx < n)
    flat = torch.where(live, idx.long() + offs, b * n).reshape(-1)
    out = torch.zeros((b * n + 1, c), dtype=grad.dtype, device=grad.device)
    out.index_add_(0, flat, grad.reshape(b * r, c))
    return out[:b * n].reshape(b, n, c)


def _group_points_cuda(points: torch.Tensor, idx: torch.Tensor,
                       sub: torch.Tensor | None = None) -> torch.Tensor:
    """points (B, N, C) f32 with unit channel stride (rows and batches may
    be strided: a channel slice of a wider tensor), idx (B, R) or
    (B, M, K) i32 contiguous, sub None or (B, M, C) f32 contiguous with a
    3-D idx -> idx.shape + (C,)."""
    if not (points.is_cuda and points.dtype == torch.float32
            and points.dim() == 3):
        raise ValueError(f"points must be a CUDA float32 (B, N, C) tensor, "
                         f"got {points.dtype} {tuple(points.shape)} on "
                         f"{points.device}")
    if not (idx.is_cuda and idx.dtype == torch.int32 and idx.is_contiguous()
            and idx.dim() in (2, 3)):
        raise ValueError(f"idx must be a contiguous CUDA int32 (B, R) or "
                         f"(B, M, K) tensor, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    b, n, c = points.shape
    if idx.shape[0] != b:
        raise ValueError("points and idx batch sizes differ")
    k = idx.shape[2] if idx.dim() == 3 else 1
    r = idx.shape[1] * k
    if b * r >= 2 ** 31:
        raise ValueError(f"{b * r} output rows exceed the kernel's int32 range")
    sub_ptr = None
    if sub is not None:
        if not (idx.dim() == 3 and sub.is_cuda and sub.dtype == torch.float32
                and sub.is_contiguous()
                and sub.shape == (b, idx.shape[1], c)):
            raise ValueError(f"sub must be a contiguous CUDA float32 "
                             f"(B, M, C) tensor beside a (B, M, K) idx, got "
                             f"{sub.dtype} {tuple(sub.shape)} on {sub.device}")
        sub_ptr = sub.data_ptr()
    if c > 0 and n > 0 and points.stride(2) != 1:
        points = points.contiguous()
    out = torch.empty((*idx.shape, c), dtype=torch.float32,
                      device=points.device)
    if out.numel() == 0:
        return out
    row_stride, batch_stride = points.stride(1), points.stride(0)
    vec = (c % 4 == 0 and row_stride % 4 == 0 and batch_stride % 4 == 0
           and points.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
           and (sub_ptr is None or sub_ptr % 16 == 0))
    with _kernels.on_device(points):
        rc = _kernels.function("grouping", "vlp3d_group_points")(
            points.data_ptr(), idx.data_ptr(), sub_ptr, b, n, r, k, c,
            row_stride, batch_stride, vec, out.data_ptr(),
            _kernels.stream_ptr(points))
        _kernels.check(rc, "group_points kernel")
    _kernels.launches["group_points"] += 1
    return out


# source rows a batch row past which the backward takes the atomic
# kernel: each block of the sorted kernel reads the batch row's whole
# index table twice, so the index traffic grows with n / rows a block
SORTED_MAX_N = 16384
# list entries a block of the sorted kernel holds in shared memory (a
# longer list is taken in windows)
SORTED_CAP = 4096


def sorted_smem_bytes(warps: int, rows: int, cap: int = SORTED_CAP) -> int:
    """Shared memory of one block of the sorted backward kernel
    (``sorted_smem_bytes`` in csrc/grouping.cu)."""
    return 4 * (2 * warps * rows + rows + 1 + cap + 32)


@functools.lru_cache(maxsize=None)
def _grad_plan(b: int, n: int, c: int, r: int):
    """(source rows a block, channel slices, warps a block, list capacity)
    of the sorted backward kernel for a (B, R, C) gradient into
    (B, n, C), or None for the atomic kernel (tables of more than
    SORTED_MAX_N rows a batch row). Blocks of 32 warps, about one an SM
    of an H100: rows a block halve from 128 while the grid has fewer than
    128 blocks; rows of more than 128 channels take two channel slices;
    a gradient of under 64K floats a batch row takes 8 warps a block
    (the plans that won the sweep chip_smoke.py prints)."""
    if n > SORTED_MAX_N or n == 0:
        return None
    slices = 2 if c > 128 else 1
    rows = 128
    while rows > 16 and b * -(-n // rows) * slices < 128:
        rows //= 2
    return rows, slices, 32 if r * c >= 65536 else 8, SORTED_CAP


def _group_points_grad_cuda(grad: torch.Tensor, idx: torch.Tensor,
                            n: int, plan=None) -> torch.Tensor:
    """grad (B, R, C) f32 contiguous, idx (B, R) i32 -> (B, n, C).
    ``plan`` is for measurements only: a tuple of the sorted kernel (see
    :func:`_grad_plan`) or "atomic"; callers leave it None and the shape
    decides."""
    _kernels.require(grad, "grad", torch.float32, 3)
    _kernels.require(idx, "idx", torch.int32, 2)
    b, r, c = grad.shape
    if idx.shape != (b, r):
        raise ValueError("grad and idx shapes differ")
    if plan is None:
        plan = _grad_plan(b, n, c, r) or "atomic"
    if plan == "atomic" or grad.numel() == 0:
        dpoints = torch.zeros((b, n, c), dtype=torch.float32,
                              device=grad.device)
        if grad.numel() == 0 or n == 0:
            return dpoints
    else:
        dpoints = torch.empty((b, n, c), dtype=torch.float32,
                              device=grad.device)
    vec = (c % 4 == 0 and grad.data_ptr() % 16 == 0
           and dpoints.data_ptr() % 16 == 0)
    with _kernels.on_device(grad):
        if plan == "atomic":
            rc = _kernels.function("grouping", "vlp3d_group_points_grad")(
                grad.data_ptr(), idx.data_ptr(), b, r, c, n, vec,
                dpoints.data_ptr(), _kernels.stream_ptr(grad))
        else:
            rows, slices, warps, cap = plan
            units = c // 4 if vec else c
            rc = _kernels.function(
                "grouping", "vlp3d_group_points_grad_sorted")(
                grad.data_ptr(), idx.data_ptr(), b, r, c, n, vec, rows,
                -(-units // slices), warps, cap, dpoints.data_ptr(),
                _kernels.stream_ptr(grad))
        if rc != 0:
            _kernels.check(rc, f"group_points_grad kernel ({plan})")
    _kernels.launches["group_points_grad"] += 1
    return dpoints


class _GroupPointsCuda(torch.autograd.Function):
    """Row gather on the card: forward and backward are the kernels of
    ``csrc/grouping.cu``; the gradient of ``sub`` (minus the sum over the
    K rows of a centre) is plain PyTorch."""

    @staticmethod
    def forward(ctx, points, idx, sub):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return _group_points_cuda(points, idx, sub)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        dpoints = dsub = None
        if ctx.needs_input_grad[0]:
            b = idx.shape[0]
            dpoints = _group_points_grad_cuda(
                grad.contiguous().view(b, -1, grad.shape[-1]),
                idx.view(b, -1), ctx.n)
        if ctx.needs_input_grad[2]:
            dsub = -grad.sum(dim=2)
        return dpoints, None, dsub


def _gather_rows(points: torch.Tensor, idx: torch.Tensor,
                 sub: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of points (B, N, C) at idx (B, M) or (B, M, K), minus sub
    (B, M, C) where given -> idx.shape + (C,)."""
    if not _kernels.cuda_or_cpu(points):
        return group_points_plain(points, idx, sub)
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        idx = idx.to(torch.int32).contiguous()
    if sub is not None and not sub.is_contiguous():
        sub = sub.contiguous()
    if torch.is_grad_enabled() and (
            points.requires_grad or (sub is not None and sub.requires_grad)):
        return _GroupPointsCuda.apply(points, idx, sub)
    return _group_points_cuda(points, idx, sub)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, c] = points[b, idx[b, m], c]; (B, N, C), (B, M) -> (B, M, C)."""
    return _gather_rows(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor,
                 sub: torch.Tensor | None = None) -> torch.Tensor:
    """out[b, m, k, c] = points[b, idx[b, m, k], c] - sub[b, m, c];
    (B, N, C), (B, M, K)[, (B, M, C)] -> (B, M, K, C). ``sub`` (a row a
    centre, e.g. the SA first layer's centre term) is optional; with it
    the result equals ``group_points(points, idx) - sub[:, :, None, :]``
    bit for bit, in one pass over the output."""
    return _gather_rows(points, idx, sub)
