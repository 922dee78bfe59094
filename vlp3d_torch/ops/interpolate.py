"""Three-nearest-neighbour feature interpolation.

Counterpart of ``vlp3d/ops/interpolate.py``: ``three_nn`` returns the
three smallest squared distances, ascending, lowest index on ties (d^2
summed as (dx*dx + dy*dy) + dz*dz); ``interpolate_features`` weights the
three neighbours by 1/(sqrt(d^2) + 1e-8), normalised, as the FP module
does.

``three_nn`` on a CUDA tensor runs the hand-written kernel
(``csrc/three_nn.cu``), on a CPU tensor :func:`three_nn_plain`; there is
no fallback between the two. The weighting and the weighted sum are
plain PyTorch on both (the neighbour rows come through
:func:`~vlp3d_torch.ops.grouping.group_points`, so on the card their
gradient is the scatter-add kernel). Indices and distances carry no
gradient: only the known features receive one, as in the JAX op, which
stops the gradient at the distances.
"""

from __future__ import annotations

import torch

from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops.grouping import group_points


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


def _three_nn_cuda(unknown: torch.Tensor, known: torch.Tensor):
    _kernels.require(unknown, "unknown", torch.float32, 3, 3)
    _kernels.require(known, "known", torch.float32, 3, 3)
    b, n, _ = unknown.shape
    m = known.shape[1]
    if known.shape[0] != b:
        raise ValueError("unknown and known batch sizes differ")
    dist2 = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    if b * n == 0:
        return dist2, idx
    with _kernels.on_device(unknown):
        rc = _kernels.function("three_nn", "vlp3d_three_nn")(
            unknown.data_ptr(), known.data_ptr(), b, n, m,
            dist2.data_ptr(), idx.data_ptr(), _kernels.stream_ptr(unknown),
        )
        _kernels.check(rc, "three_nn kernel")
    _kernels.launches["three_nn"] += 1
    return dist2, idx


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
    -> (B, N, C)."""
    gathered = group_points(features, idx)  # (B, N, 3, C)
    return (gathered * weight[..., None]).sum(dim=2)


def interpolate_features(unknown: torch.Tensor, known: torch.Tensor,
                         known_feats: torch.Tensor) -> torch.Tensor:
    """three_nn + inverse-distance weighting (pointnet2_modules.py:393-401)."""
    dist2, idx = three_nn(unknown, known)  # computed under no_grad
    recip = 1.0 / (torch.sqrt(dist2) + 1e-8)
    weight = recip / recip.sum(dim=-1, keepdim=True)
    return three_interpolate(known_feats, idx, weight)
