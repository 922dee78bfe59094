"""Host-side corner-based 3D box IoU (numpy).

The port's own copy of ``vlp3d/eval/box_iou.py``.

Reproduces `utils/box_util.py`'s box3d_iou semantics (polygon clipping of
the two top-face rectangles in the x-y plane + z-interval overlap), used
by the grounding evaluator (`eval_ref_one_sample`, lib/joint/
eval_ground.py:20-30) and benchmark/eval.py. Corner convention: (8, 3)
arrays from get_3d_box-style generators — corners 0-3 share one z face and
4-7 the other.
"""

from __future__ import annotations

import numpy as np


def polygon_clip(subject, clip):
    """Sutherland-Hodgman convex clip. Both polygons are lists of (x, y)
    vertices; clip must be convex. Returns vertex list or None."""

    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) > (b[1] - a[1]) * (p[0] - a[0])

    def intersection(a, b, p, q):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p[0] - q[0], p[1] - q[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p[0] * q[1] - p[1] * q[0]
        n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
        return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)

    output = list(subject)
    a = clip[-1]
    for b in clip:
        if not output:
            return None
        inputs = output
        output = []
        s = inputs[-1]
        for e in inputs:
            if inside(e, a, b):
                if not inside(s, a, b):
                    output.append(intersection(a, b, s, e))
                output.append(e)
            elif inside(s, a, b):
                output.append(intersection(a, b, s, e))
            s = e
        a = b
    return output if output else None


def poly_area(x, y):
    return 0.5 * np.abs(
        np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))
    )


def convex_hull_intersection(p1, p2):
    inter = polygon_clip(p1, p2)
    if inter is None:
        return None, 0.0
    xs = np.array([p[0] for p in inter])
    ys = np.array([p[1] for p in inter])
    return inter, poly_area(xs, ys)


def box3d_vol(corners):
    a = np.linalg.norm(corners[0] - corners[1])
    b = np.linalg.norm(corners[1] - corners[2])
    c = np.linalg.norm(corners[0] - corners[4])
    return a * b * c


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """3D IoU of two (8, 3) corner boxes.

    The reference's live implementation is the CORNER-AABB IoU — the
    rotated polygon-clipping path is commented out (box_util.py:97-135) —
    with a +1e-8 union epsilon. Reproduced exactly; works on (..., 8, 3)
    batches too."""
    min1 = np.min(corners1, axis=-2)
    max1 = np.max(corners1, axis=-2)
    min2 = np.min(corners2, axis=-2)
    max2 = np.max(corners2, axis=-2)
    inter = np.prod(
        np.maximum(np.minimum(max1, max2) - np.maximum(min1, min2), 0.0),
        axis=-1,
    )
    vol1 = np.prod(max1 - min1, axis=-1)
    vol2 = np.prod(max2 - min2, axis=-1)
    return inter / (vol1 + vol2 - inter + 1e-8)


def get_3d_box(box_size, heading_angle, center) -> np.ndarray:
    """Single-box corner generator matching the reference's roty convention
    (box_util.py:341-359)."""
    c, s = np.cos(heading_angle), np.sin(heading_angle)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    l, w, h = box_size
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    z = [h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2]
    corners = np.dot(r, np.vstack([x, y, z]))
    corners += np.asarray(center)[:, None]
    return corners.T


def construct_bbox_corners(center, box_size) -> np.ndarray:
    """Axis-aligned corner construction used for the dumped boxes
    (eval_ground.py:33-45)."""
    return get_3d_box(box_size, 0.0, center)
