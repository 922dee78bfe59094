"""Box geometry on tensors: the closed forms the proposal path needs and
the axis-aligned IoU / DIoU of the grounding and contrast losses.

Counterparts of ``corner_offsets_flat``, ``rotate_rotz_rows``,
``box3d_diou``, ``box3d_iou_aabb``, ``corners_to_aabb``,
``box3d_iou_corners`` and ``get_3d_box_batch`` in
``vlp3d/geometry/boxes.py``. ``get_3d_box_batch`` keeps the JAX
function's two forms: numpy in, numpy out (the data path), and tensors in,
a tensor out (CapNet's local-context masks).
"""

from __future__ import annotations

import numpy as np
import torch

# reference corner sign pattern (get_3d_box_batch, box_util.py)
CORNER_SIGNS = (
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
)


def get_3d_box_batch(box_size, heading_angle, center):
    """Box parameters -> (..., 8, 3) corners: box_size (..., 3) as (l, w,
    h), heading_angle (...,), center (..., 3). signs * size/2 rotated by
    roty(heading) (the reference's convention) plus center. Where any
    input is a tensor the corners are a tensor (differentiable, on the
    inputs' device); otherwise numpy, computed in float32 whatever the
    inputs' dtype, as the JAX package's host branch casts them."""
    if any(torch.is_tensor(a) for a in (box_size, heading_angle, center)):
        return _box_corners_tensor(torch.as_tensor(box_size),
                                   torch.as_tensor(heading_angle),
                                   torch.as_tensor(center))
    box_size = np.asarray(box_size).astype(np.float32, copy=False)
    heading_angle = np.asarray(heading_angle).astype(np.float32, copy=False)
    center = np.asarray(center).astype(np.float32, copy=False)
    signs = np.asarray(CORNER_SIGNS, np.float32)
    half = box_size[..., None, :] * signs / 2.0  # (..., 8, 3)
    c = np.cos(heading_angle)[..., None]
    s = np.sin(heading_angle)[..., None]
    hx, hy, hz = half[..., 0], half[..., 1], half[..., 2]
    # half @ roty(t)^T with roty rows [(c,0,s), (0,1,0), (-s,0,c)]
    out = np.stack([hx * c + hz * s, hy, -hx * s + hz * c], axis=-1)
    return out + center[..., None, :]


def _box_corners_tensor(box_size, heading_angle, center):
    signs = torch.tensor(CORNER_SIGNS, dtype=box_size.dtype,
                         device=box_size.device)
    half = box_size[..., None, :] * signs / 2.0  # (..., 8, 3)
    c = torch.cos(heading_angle)[..., None]
    s = torch.sin(heading_angle)[..., None]
    hx, hy, hz = half[..., 0], half[..., 1], half[..., 2]
    out = torch.stack([hx * c + hz * s, hy, -hx * s + hz * c], dim=-1)
    return out + center[..., None, :]


def corner_offsets_flat(box_size: torch.Tensor,
                        heading_angle: torch.Tensor) -> torch.Tensor:
    """(corners - center) of roty-rotated boxes, flattened to (..., 24)
    in get_3d_box_batch's C order [dx0, dy0, dz0, dx1, ...]."""
    c, s = torch.cos(heading_angle), torch.sin(heading_angle)
    hl = box_size[..., 0] / 2.0
    hw = box_size[..., 1] / 2.0
    hh = box_size[..., 2] / 2.0
    comps = []
    for sx, sy, sz in CORNER_SIGNS:
        # (sx*hl, sy*hw, sz*hh) @ roty(t)^T, elementwise
        comps += [
            sx * hl * c + sz * hh * s,
            sy * hw,
            -sx * hl * s + sz * hh * c,
        ]
    return torch.stack(comps, dim=-1)


def rotate_rotz_rows(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Row-vector product v @ rotz(t): v (..., 3), t (...,)."""
    c, s = torch.cos(t), torch.sin(t)
    vx, vy, vz = v.unbind(-1)
    return torch.stack([vx * c + vy * s, -vx * s + vy * c, vz], dim=-1)


def _aabb_inter(center1, size1, center2, size2):
    min1, max1 = center1 - size1 / 2.0, center1 + size1 / 2.0
    min2, max2 = center2 - size2 / 2.0, center2 + size2 / 2.0
    inter = torch.clamp(torch.minimum(max1, max2) - torch.maximum(min1, min2),
                        min=0.0).prod(dim=-1)
    return inter, (min1, max1, min2, max2)


def box3d_iou_aabb(center1, size1, center2, size2) -> torch.Tensor:
    """Axis-aligned IoU of aligned pairs of boxes, each a center (..., 3)
    and a size (..., 3); broadcasts over leading dims."""
    inter, _ = _aabb_inter(center1, size1, center2, size2)
    return inter / (size1.prod(dim=-1) + size2.prod(dim=-1) - inter)


def box3d_diou(center1, size1, center2, size2):
    """Axis-aligned IoU and DIoU (box3d_diou_batch_tensor,
    box_util.py:488-529): diou = iou - 1.5 * center_dist^2 /
    enclosing_diag^2, clamped to [-1, 1]. Returns (iou, diou)."""
    inter, (min1, max1, min2, max2) = _aabb_inter(center1, size1, center2,
                                                  size2)
    iou = inter / (size1.prod(dim=-1) + size2.prod(dim=-1) - inter)
    inter_diag = ((center1 - center2) ** 2).sum(dim=-1)
    outer = torch.clamp(torch.maximum(max1, max2) - torch.minimum(min1, min2),
                        min=0.0)
    outer_diag = (outer ** 2).sum(dim=-1)
    diou = torch.clamp(iou - 1.5 * inter_diag / outer_diag, -1.0, 1.0)
    return iou, diou


def corners_to_aabb(corners: torch.Tensor):
    """(..., 8, 3) corners -> (center, size) of the axis-aligned hull."""
    cmin = corners.amin(dim=-2)
    cmax = corners.amax(dim=-2)
    return (cmin + cmax) / 2.0, cmax - cmin


def box3d_iou_corners(corners1: torch.Tensor,
                      corners2: torch.Tensor) -> torch.Tensor:
    """AABB IoU of boxes given by their corners (broadcasting over leading
    dims); exact on ScanNet, where every heading is 0."""
    c1, s1 = corners_to_aabb(corners1)
    c2, s2 = corners_to_aabb(corners2)
    return box3d_iou_aabb(c1, s1, c2, s2)
