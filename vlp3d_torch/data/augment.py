"""Host-side scene augmentations (numpy, seeded rng).

The port's own copy of ``vlp3d/data/augment.py``: the same rng draws in
the same order and the same float32 rounding points, so a seed gives
the two packages the same augmented scene bit for bit.

Ports of `utils/utils_fn.py:28-142` and
`data/scannet/model_util_scannet.py:48-80`, preserving the reference's rng
draw ORDER so fixed seeds reproduce the same augmentation streams:
flip (two p=0.3 draws) -> rotate (x/y/z each U(-5deg, +5deg)) ->
scale (exp(U(-0.1, 0.1)) diagonal) -> translate (U{-0.5..0.5 step .001}).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AugmentParams:
    """One item's drawn augmentation: two flips, the combined point
    rotation (rotx^T @ roty^T @ rotz^T), the diagonal scale matrix, and
    the translation — enough to replay the point transform anywhere
    (numpy here, or fused into the native gather, loader.c)."""

    flip0: bool
    flip1: bool
    rot: np.ndarray  # (3, 3) f64
    scale: np.ndarray  # (3, 3) f64, diagonal
    trans: np.ndarray  # (3,) f64


def apply_mat3_points(points_xyz, mat):
    """Elementwise-f64 replacement for ``np.dot(points[:, :3], mat)``
    with a fixed, FMA-free summation order ``(x*m0j + y*m1j) + z*m2j``.

    np.dot routes through BLAS dgemm, which may use FMA instructions
    whose f64-internal rounding differs from separate mul+add; after the
    f32 store-round the results agree except on ~2^-30-probability
    rounding-boundary ties — harmless numerically, but the native fused
    loader (loader.c:gather_augment_rows, built with -ffp-contract=off)
    must reproduce the numpy path BIT-FOR-BIT, so both use this form.
    """
    x = points_xyz[:, 0].astype(np.float64)
    y = points_xyz[:, 1].astype(np.float64)
    z = points_xyz[:, 2].astype(np.float64)
    out = np.empty((points_xyz.shape[0], 3), np.float64)
    for j in range(3):
        out[:, j] = (x * mat[0, j] + y * mat[1, j]) + z * mat[2, j]
    return out


def rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rotate_aligned_boxes_along_axis(input_boxes, rot_mat, axis):
    """Axis-aligned box re-fit after rotation
    (model_util_scannet.py:48-80, including its corner-projection quirks)."""
    centers, lengths = input_boxes[:, 0:3], input_boxes[:, 3:6]
    new_centers = np.dot(centers, np.transpose(rot_mat))

    if axis == "x":
        d1, d2 = lengths[:, 1] / 2.0, lengths[:, 2] / 2.0
    elif axis == "y":
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 2] / 2.0
    else:
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0

    new_1 = np.zeros((d1.shape[0], 4))
    new_2 = np.zeros((d1.shape[0], 4))
    for i, crnr in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.zeros((d1.shape[0], 3))
        crnrs[:, 0] = crnr[0] * d1
        crnrs[:, 1] = crnr[1] * d2
        crnrs = np.dot(crnrs, np.transpose(rot_mat))
        new_1[:, i] = crnrs[:, 0]
        new_2[:, i] = crnrs[:, 1]
    new_d1 = 2.0 * np.max(new_1, 1)
    new_d2 = 2.0 * np.max(new_2, 1)

    if axis == "x":
        new_lengths = np.stack((lengths[:, 0], new_d1, new_d2), axis=1)
    elif axis == "y":
        new_lengths = np.stack((new_d1, lengths[:, 1], new_d2), axis=1)
    else:
        new_lengths = np.stack((new_d1, new_d2, lengths[:, 2]), axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)


def draw_augment(rng, target_bboxes):
    """Draw one item's augmentation (the reference's exact rng ORDER:
    flip d1, flip d2, ax, ay, az, scale U(-0.1,0.1,(3,3)), 3× translate
    choice — utils_fn.py:28-142) and apply the BOX transforms in place.

    Returns (AugmentParams, transformed boxes). The point transform is
    applied separately — numpy (:func:`apply_augment_points`) or fused
    into the native gather (loader.c:gather_augment_rows) — so the
    loader can do the wide per-point work in one C pass."""
    flip0 = bool(rng.random() > 0.7)
    if flip0:
        target_bboxes[:, 0] = -target_bboxes[:, 0]
    flip1 = bool(rng.random() > 0.7)
    if flip1:
        target_bboxes[:, 1] = -target_bboxes[:, 1]

    ax = (rng.random() * np.pi / 18) - np.pi / 36
    mx = rotx(ax)
    target_bboxes = rotate_aligned_boxes_along_axis(target_bboxes, mx, "x")
    ay = (rng.random() * np.pi / 18) - np.pi / 36
    my = roty(ay)
    target_bboxes = rotate_aligned_boxes_along_axis(target_bboxes, my, "y")
    az = (rng.random() * np.pi / 18) - np.pi / 36
    mz = rotz(az)
    target_bboxes = rotate_aligned_boxes_along_axis(target_bboxes, mz, "z")
    rot = np.dot(np.transpose(mx), np.transpose(my))
    rot = np.dot(rot, np.transpose(mz))

    scale = rng.uniform(-0.1, 0.1, (3, 3))
    scale = np.exp(scale) * np.eye(3)
    target_bboxes[:, 0:3] = np.dot(target_bboxes[:, 0:3], scale)
    target_bboxes[:, 3:6] = np.dot(target_bboxes[:, 3:6], scale)

    grid = np.arange(-0.5, 0.501, 0.001)
    trans = np.array([rng.choice(grid, size=1)[0] for _ in range(3)])
    target_bboxes[:, :3] += trans
    return AugmentParams(flip0, flip1, rot, scale, trans), target_bboxes


def apply_augment_points(point_cloud, params, use_height):
    """Apply a drawn augmentation to points in place, rounding to f32 at
    exactly the reference chain's store points: flip → rotate (store) →
    scale (store; col 3 scaled in an f32 loop — the python-float scalar
    is weak under NEP 50) → translate (f64 loop, f32 store)."""
    if params.flip0:
        point_cloud[:, 0] = -point_cloud[:, 0]
    if params.flip1:
        point_cloud[:, 1] = -point_cloud[:, 1]
    point_cloud[:, 0:3] = apply_mat3_points(point_cloud, params.rot)
    point_cloud[:, 0:3] = apply_mat3_points(point_cloud, params.scale)
    if use_height:
        point_cloud[:, 3] = point_cloud[:, 3] * float(params.scale[2, 2])
    point_cloud[:, :3] += params.trans
    return point_cloud


def augment_scene(point_cloud, target_bboxes, use_height, rng):
    """Full train-time augmentation chain (dataset.py:653-661)."""
    params, target_bboxes = draw_augment(rng, target_bboxes)
    point_cloud = apply_augment_points(point_cloud, params, use_height)
    return point_cloud, target_bboxes
