"""Three-nearest-neighbour feature interpolation.

Counterpart of ``vlp3d/ops/interpolate.py``: ``three_nn`` returns the
three smallest squared distances, ascending, lowest index on ties (d^2
summed as (dx*dx + dy*dy) + dz*dz); ``interpolate_features`` weights the
three neighbours by 1/(sqrt(d^2) + 1e-8), normalised, as the FP module
does, and sums their feature rows.

A CUDA tensor goes to the hand-written kernels, a CPU tensor to the plain
versions beside them (:func:`three_nn_plain`,
:func:`interpolate_features_plain`); there is no fallback between the
two. On the card ``interpolate_features`` is one launch of the team
kernel of ``csrc/three_nn.cu`` (three-NN, the weights and the weighted
sum, no (B, N, 3, C) tensor) and, where the known features need a
gradient, one launch of ``three_interpolate_grad_kernel`` of
``csrc/grouping.cu`` in its backward, both bound in one
:class:`torch.autograd.Function`. Only the known features receive a
gradient, as in the JAX op, which stops the gradient at the distances;
indices are integers. The shape picks the team kernel's plan
(:func:`_three_nn_plan`); the first, one-thread-a-point kernel stays
callable as plan "serial", for measurements only.
"""

from __future__ import annotations

import functools

import torch

from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops.grouping import (
    group_points,
    group_points_grad_plain,
    group_points_plain,
)

# the team kernel's shapes that chip_smoke.py sweeps at the FP sites and
# the card tests run: (lanes a point, points a block), whole warps of at
# most 1024 threads
TEAM_PLANS = tuple((lanes, points) for lanes in (4, 8, 16, 32)
                   for points in (8, 16, 32, 64)
                   if 32 <= lanes * points <= 1024)


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    """Plain PyTorch three-NN -> (dist2 (B, N, 3) f32, idx (B, N, 3) i32)."""
    unknown, known = unknown.float(), known.float()
    m = known.shape[1]
    dx = unknown[:, :, None, 0] - known[:, None, :, 0]
    dy = unknown[:, :, None, 1] - known[:, None, :, 1]
    dz = unknown[:, :, None, 2] - known[:, None, :, 2]
    cur = (dx * dx + dy * dy) + dz * dz  # (B, N, M)
    lane = torch.arange(m, device=cur.device)
    dists, idxs = [], []
    for _ in range(3):  # min, then its lowest index, then mask it out
        mn = cur.min(dim=-1, keepdim=True).values
        ix = torch.where(cur == mn, lane, m).min(dim=-1).values
        dists.append(mn[..., 0])
        idxs.append(ix)
        cur = torch.where(lane == ix[..., None], torch.inf, cur)
    return torch.stack(dists, -1), torch.stack(idxs, -1).to(torch.int32)


def interpolation_weights(dist2: torch.Tensor) -> torch.Tensor:
    """1/(sqrt(d^2) + 1e-8), normalised over the three neighbours."""
    recip = 1.0 / (torch.sqrt(dist2) + 1e-8)
    return recip / recip.sum(dim=-1, keepdim=True)


def three_interpolate_plain(features: torch.Tensor, idx: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch weighted sum: (B, M, C), (B, N, 3), (B, N, 3) ->
    (B, N, C)."""
    gathered = group_points_plain(features, idx)  # (B, N, 3, C)
    return (gathered * weight[..., None]).sum(dim=2)


def interpolate_features_plain(unknown: torch.Tensor, known: torch.Tensor,
                               known_feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch three-NN, weighting and weighted sum; autograd gives
    the known features' gradient (a scatter-add of the weighted rows)."""
    with torch.no_grad():
        dist2, idx = three_nn_plain(unknown, known)
        weight = interpolation_weights(dist2)
    return three_interpolate_plain(known_feats, idx, weight)


def three_interpolate_grad_plain(grad: torch.Tensor, idx: torch.Tensor,
                                 weight: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch backward of the weighted sum with respect to the
    features: the rows weight[b, i, k] * grad[b, i, :] summed into a
    zeroed (B, m, C) table at idx[b, i, k], in ascending 3 i + k
    (``index_add_``)."""
    b, n, c = grad.shape
    rows = (grad[:, :, None, :] * weight[..., None]).reshape(b, 3 * n, c)
    return group_points_grad_plain(rows, idx.reshape(b, 3 * n), m)


def _check_team_plan(plan) -> tuple[int, int]:
    """(lanes, points) of a team-kernel plan, or ValueError for one the
    kernel does not take: lanes 4, 8, 16 or 32, whole warps, at most 1024
    threads a block."""
    if not (isinstance(plan, tuple) and len(plan) == 2
            and all(isinstance(v, int) for v in plan)):
        raise ValueError(f"three-NN plan {plan!r} is not (lanes, points)")
    lanes, points = plan
    threads = lanes * points
    if (lanes not in (4, 8, 16, 32) or points < 1 or threads % 32
            or threads > 1024):
        raise ValueError(f"three-NN plan {plan!r}: lanes must be 4, 8, 16 "
                         "or 32 and lanes x points whole warps of at most "
                         "1024 threads")
    return lanes, points


@functools.lru_cache(maxsize=None)
def _three_nn_plan(b: int, n: int, m: int) -> tuple[int, int]:
    """(lanes a point, points a block) of the team kernel for ``n``
    unknown and ``m`` known points a batch row, ``b`` rows: 16 lanes a
    point, 32 points a block (128 blocks of 512 threads at FP1, 256 at
    FP2). In the sweep of every plan of :data:`TEAM_PLANS` that
    chip_smoke.py prints, on an H100, it was the fastest or within 4% of
    it at both FP sites, fused and alone; 4 lanes were the slowest, 32
    lost at FP2. Shapes the kernel does not take raise."""
    if m < 3:
        raise ValueError(f"three_nn needs at least 3 known points, got {m}")
    if not 1 <= b <= 65535 or n < 0:
        raise ValueError(f"three_nn: {b} batch rows of {n} points are "
                         "outside the kernel's grid")
    return 16, 32


def _shapes(unknown: torch.Tensor, known: torch.Tensor):
    _kernels.require(unknown, "unknown", torch.float32, 3, 3)
    _kernels.require(known, "known", torch.float32, 3, 3)
    b, n, _ = unknown.shape
    m = known.shape[1]
    if known.shape[0] != b:
        raise ValueError("unknown and known batch sizes differ")
    return b, n, m


def _three_nn_cuda(unknown: torch.Tensor, known: torch.Tensor, plan=None):
    """``plan`` is for measurements only: a team-kernel plan (see
    :func:`_three_nn_plan`) or "serial" for the first, one-thread-a-point
    kernel; callers leave it None and the shape decides."""
    b, n, m = _shapes(unknown, known)
    dist2 = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    if b * n == 0:
        return dist2, idx
    if plan is None:
        plan = _three_nn_plan(b, n, m)
    with _kernels.on_device(unknown):
        if plan == "serial":
            rc = _kernels.function("three_nn", "vlp3d_three_nn")(
                unknown.data_ptr(), known.data_ptr(), b, n, m,
                dist2.data_ptr(), idx.data_ptr(),
                _kernels.stream_ptr(unknown))
        else:
            lanes, points = _check_team_plan(plan)
            rc = _kernels.function("three_nn", "vlp3d_three_nn_team")(
                unknown.data_ptr(), known.data_ptr(), None, b, n, m, 0,
                lanes, lanes * points, 0, dist2.data_ptr(), idx.data_ptr(),
                None, None, _kernels.stream_ptr(unknown))
        if rc != 0:
            _kernels.check(rc, f"three_nn kernel ({plan})")
    _kernels.launches["three_nn"] += 1
    return dist2, idx


def _interpolate_cuda(unknown: torch.Tensor, known: torch.Tensor,
                      feats: torch.Tensor, plan=None,
                      with_dist2: bool = False):
    """One launch of the team kernel with the interpolation: (out
    (B, N, C), idx (B, N, 3) i32, weight (B, N, 3)), plus dist2 (B, N, 3)
    when ``with_dist2`` (for checks; the FP module does not need it).
    ``plan`` is for measurements only."""
    b, n, m = _shapes(unknown, known)
    _kernels.require(feats, "known_feats", torch.float32, 3)
    c = feats.shape[2]
    if feats.shape[:2] != (b, m) or c == 0:
        raise ValueError(f"known_feats has shape {tuple(feats.shape)}, "
                         f"expected ({b}, {m}, C), C >= 1")
    dev = unknown.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=dev)
    weight = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    dist2 = (torch.empty((b, n, 3), dtype=torch.float32, device=dev)
             if with_dist2 else None)
    if b * n > 0:
        lanes, points = _check_team_plan(
            _three_nn_plan(b, n, m) if plan is None else plan)
        vec = (c % 4 == 0 and feats.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
        with _kernels.on_device(unknown):
            rc = _kernels.function("three_nn", "vlp3d_three_nn_team")(
                unknown.data_ptr(), known.data_ptr(), feats.data_ptr(), b, n,
                m, c, lanes, lanes * points, vec,
                None if dist2 is None else dist2.data_ptr(), idx.data_ptr(),
                weight.data_ptr(), out.data_ptr(),
                _kernels.stream_ptr(unknown))
            if rc != 0:
                _kernels.check(rc, f"three_nn interpolation kernel ({plan})")
        _kernels.launches["three_nn"] += 1
    return (out, idx, weight) + ((dist2,) if with_dist2 else ())


# the backward's plans that chip_smoke.py sweeps at the FP sites and the
# card tests run: (known rows a block, one a warp; channel units a lane)
INTERP_GRAD_PLANS = tuple((warps, lane_units) for warps in (4, 8, 16)
                          for lane_units in (1, 2))


def _check_interp_grad_plan(plan) -> tuple[int, int]:
    """(warps, lane_units) of a backward plan, or ValueError for one the
    kernel does not take: 1 to 16 warps (known rows) a block, 1 or 2
    channel units (float4, or float) a lane."""
    if not (isinstance(plan, tuple) and len(plan) == 2
            and all(isinstance(v, int) for v in plan)):
        raise ValueError(f"interpolation backward plan {plan!r} is not "
                         "(warps, lane_units)")
    warps, lane_units = plan
    if not 1 <= warps <= 16 or lane_units not in (1, 2):
        raise ValueError(f"interpolation backward plan {plan!r}: warps must "
                         "be 1 to 16 and lane_units 1 or 2")
    return warps, lane_units


@functools.lru_cache(maxsize=None)
def _interp_grad_plan(b: int, m: int, c: int, r: int) -> tuple[int, int]:
    """Plan of ``three_interpolate_grad_kernel`` for a (B, R = 3N, C)
    table of weighted rows into (B, m, C): (known rows a block, channel
    units a lane). 2 units a lane (C = 256 in float4 in one slice; a
    wider row takes more slices) unless one covers the row; 8 rows a
    block, so the FP sites run 256 and 512 blocks of 256 threads. In the
    sweep chip_smoke.py prints, on an H100, it was the fastest plan at
    both FP sites."""
    units = c // 4 if c % 4 == 0 else c
    return 8, 1 if units <= 32 else 2


def _three_interpolate_grad_cuda(grad: torch.Tensor, idx: torch.Tensor,
                                 weight: torch.Tensor, m: int,
                                 plan=None) -> torch.Tensor:
    """grad (B, N, C), idx (B, N, 3) i32, weight (B, N, 3), all contiguous
    -> the known features' gradient (B, m, C), every row written, the same
    bits from every launch. ``plan`` is for measurements only."""
    _kernels.require(grad, "grad", torch.float32, 3)
    _kernels.require(idx, "idx", torch.int32, 3, 3)
    _kernels.require(weight, "weight", torch.float32, 3, 3)
    b, n, c = grad.shape
    if idx.shape[:2] != (b, n) or weight.shape[:2] != (b, n):
        raise ValueError("grad, idx and weight shapes differ")
    if grad.numel() == 0 or m == 0:
        return torch.zeros((b, m, c), dtype=torch.float32, device=grad.device)
    if b > 65535 or 3 * n >= 2 ** 31:
        raise ValueError(f"three_interpolate_grad: {b} batch rows of {n} "
                         "points are outside the kernel's grid")
    warps, lane_units = _check_interp_grad_plan(
        _interp_grad_plan(b, m, c, 3 * n) if plan is None else plan)
    dfeats = torch.empty((b, m, c), dtype=torch.float32, device=grad.device)
    vec = (c % 4 == 0 and grad.data_ptr() % 16 == 0
           and dfeats.data_ptr() % 16 == 0)
    with _kernels.on_device(grad):
        rc = _kernels.function("grouping", "vlp3d_three_interpolate_grad")(
            grad.data_ptr(), idx.data_ptr(), weight.data_ptr(), b, n, c, m,
            vec, warps, lane_units, dfeats.data_ptr(),
            _kernels.stream_ptr(grad))
        if rc != 0:
            _kernels.check(rc, f"three_interpolate_grad kernel ({plan})")
    _kernels.launches["three_interpolate_grad"] += 1
    return dfeats


class _InterpolateCuda(torch.autograd.Function):
    """The FP module's interpolation on the card: forward the team kernel
    with the interpolation, backward ``three_interpolate_grad_kernel``,
    for the known features only."""

    @staticmethod
    def forward(ctx, unknown, known, known_feats):
        out, idx, weight = _interpolate_cuda(unknown, known, known_feats)
        ctx.save_for_backward(idx, weight)
        ctx.m = known_feats.shape[1]
        return out

    @staticmethod
    def backward(ctx, grad):
        dfeats = None
        if ctx.needs_input_grad[2]:
            idx, weight = ctx.saved_tensors
            dfeats = _three_interpolate_grad_cuda(grad.contiguous(), idx,
                                                  weight, ctx.m)
        return None, None, dfeats


def _interpolate_features_cuda(unknown: torch.Tensor, known: torch.Tensor,
                               known_feats: torch.Tensor) -> torch.Tensor:
    unknown, known = unknown.contiguous(), known.contiguous()
    known_feats = known_feats.contiguous()
    if torch.is_grad_enabled() and known_feats.requires_grad:
        return _InterpolateCuda.apply(unknown, known, known_feats)
    return _interpolate_cuda(unknown, known, known_feats)[0]


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest ``known`` points (B, M, 3), M >= 3, of each ``unknown``
    point (B, N, 3). Returns (dist2 (B, N, 3) ascending, idx (B, N, 3) i32)."""
    if known.shape[1] < 3:
        raise ValueError(f"three_nn needs at least 3 known points, got "
                         f"{known.shape[1]}")
    with torch.no_grad():
        if _kernels.cuda_or_cpu(unknown):
            return _three_nn_cuda(unknown.contiguous(), known.contiguous())
        return three_nn_plain(unknown, known)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 neighbour features: (B, M, C), (B, N, 3), (B, N, 3)
    -> (B, N, C), through :func:`~vlp3d_torch.ops.grouping.group_points`
    (on the card its gather kernel and scatter-add backward)."""
    gathered = group_points(features, idx)  # (B, N, 3, C)
    return (gathered * weight[..., None]).sum(dim=2)


def interpolate_features(unknown: torch.Tensor, known: torch.Tensor,
                         known_feats: torch.Tensor) -> torch.Tensor:
    """three_nn + inverse-distance weighting (pointnet2_modules.py:393-401):
    unknown (B, N, 3), known (B, M, 3), M >= 3, known_feats (B, M, C) ->
    (B, N, C)."""
    if known.shape[1] < 3:
        raise ValueError(f"three_nn needs at least 3 known points, got "
                         f"{known.shape[1]}")
    if _kernels.cuda_or_cpu(unknown):
        return _interpolate_features_cuda(unknown, known, known_feats)
    return interpolate_features_plain(unknown, known, known_feats)
