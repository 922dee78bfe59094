"""Box geometry on tensors: the two closed forms the proposal path needs.

Counterparts of ``corner_offsets_flat`` and ``rotate_rotz_rows`` in
``vlp3d/geometry/boxes.py``.
"""

from __future__ import annotations

import torch

# reference corner sign pattern (get_3d_box_batch, box_util.py)
CORNER_SIGNS = (
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
)


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
