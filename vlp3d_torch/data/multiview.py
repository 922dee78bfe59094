"""Multiview 2D features projected onto 3D points (numpy).

The port's own copy of ``vlp3d/data/multiview.py`` (the reference's
``scripts/multiview_compute/{compute_multiview_features,
project_multiview_features,project_multiview_labels}.py``): each point is
projected into every frame with the depth camera's intrinsics and pose,
checked against the frame's depth map, and its feature is the max over
the frames that see it (``enet_feats_maxpool.hdf5``), or its label the
majority vote. The CNN that makes the feature maps runs elsewhere
(:mod:`vlp3d_torch.cli.compute_multiview`, ENet on the card).
"""

from __future__ import annotations

import numpy as np

DEFAULT_INTRINSICS = np.array(
    [[37.01983, 0, 20, 0], [0, 38.52470, 15.5, 0], [0, 0, 1, 0],
     [0, 0, 0, 1]],
    np.float64,
)  # 41x32 feature-map intrinsics (project_multiview_features.py:28-29)


class ProjectionHelper:
    def __init__(self, intrinsics=DEFAULT_INTRINSICS, depth_min=0.1,
                 depth_max=4.0, image_dims=(41, 32), occ_threshold=0.05):
        self.intrinsics = np.asarray(intrinsics, np.float64)
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.image_dims = image_dims  # (W, H)
        self.occ_threshold = occ_threshold

    def project_points(self, points, world_to_camera):
        """points (N, 3); world_to_camera (4, 4).

        Returns (u, v, z): integer pixel coords + camera-space depth."""
        n = points.shape[0]
        hom = np.concatenate([points, np.ones((n, 1))], axis=1)
        cam = hom @ world_to_camera.T  # (N, 4)
        z = cam[:, 2]
        safe_z = np.where(np.abs(z) < 1e-8, 1e-8, z)
        u = (
            self.intrinsics[0, 0] * cam[:, 0] / safe_z + self.intrinsics[0, 2]
        )
        v = (
            self.intrinsics[1, 1] * cam[:, 1] / safe_z + self.intrinsics[1, 2]
        )
        return np.round(u).astype(int), np.round(v).astype(int), z

    def valid_mask(self, u, v, z, depth_map):
        w, h = self.image_dims
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        inside &= (z >= self.depth_min) & (z <= self.depth_max)
        uu = np.clip(u, 0, w - 1)
        vv = np.clip(v, 0, h - 1)
        d = depth_map[vv, uu]
        visible = np.abs(d - z) <= self.occ_threshold
        return inside & visible


def project_frame_features(
    points: np.ndarray,  # (N, 3)
    feature_map: np.ndarray,  # (H, W, C)
    depth_map: np.ndarray,  # (H, W)
    camera_pose: np.ndarray,  # (4, 4) camera-to-world
    projector: ProjectionHelper | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One frame -> (features (N, C), valid (N,))."""
    projector = projector or ProjectionHelper(
        image_dims=(feature_map.shape[1], feature_map.shape[0])
    )
    world_to_camera = np.linalg.inv(camera_pose)
    u, v, z = projector.project_points(points, world_to_camera)
    valid = projector.valid_mask(u, v, z, depth_map)
    w, h = projector.image_dims
    uu = np.clip(u, 0, w - 1)
    vv = np.clip(v, 0, h - 1)
    feats = feature_map[vv, uu]
    return feats * valid[:, None], valid


def project_frame_labels(
    points: np.ndarray,  # (N, 3)
    label_map: np.ndarray,  # (H, W) int semantic labels
    depth_map: np.ndarray,  # (H, W)
    camera_pose: np.ndarray,  # (4, 4) camera-to-world
    projector: ProjectionHelper | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One frame -> (labels (N,) int, valid (N,)). Invalid points get 0
    ('unannotated'). Label analogue of project_frame_features
    (scripts/multiview_compute/project_multiview_labels.py:189-213)."""
    projector = projector or ProjectionHelper(
        image_dims=(label_map.shape[1], label_map.shape[0])
    )
    world_to_camera = np.linalg.inv(camera_pose)
    u, v, z = projector.project_points(points, world_to_camera)
    valid = projector.valid_mask(u, v, z, depth_map)
    w, h = projector.image_dims
    uu = np.clip(u, 0, w - 1)
    vv = np.clip(v, 0, h - 1)
    labels = label_map[vv, uu].astype(np.int64)
    return labels * valid, valid


def vote_multiview_labels(
    points: np.ndarray,
    frames: list,  # [(label_map, depth_map, camera_pose), ...]
    num_labels: int = 41,
    projector: ProjectionHelper | None = None,
) -> np.ndarray:
    """Per-point majority vote over the frames in which the point is
    visible (the reference's --maxpool 'majority voting in label
    projection mode', project_multiview_labels.py:233-235); points never
    seen stay 0 ('unannotated')."""
    n = points.shape[0]
    votes = np.zeros((n, num_labels), np.int32)
    for label_map, depth_map, pose in frames:
        labels, valid = project_frame_labels(
            points, label_map, depth_map, pose, projector
        )
        votes[np.arange(n), labels] += valid.astype(np.int32)
    seen = votes.sum(axis=1) > 0
    return np.argmax(votes, axis=1) * seen


def maxpool_multiview_features(
    points: np.ndarray,
    frames: list,  # [(feature_map, depth_map, camera_pose), ...]
    projector: ProjectionHelper | None = None,
) -> np.ndarray:
    """Per-point max over all frames in which the point is visible; points
    never seen get zeros (the reference's maxpool aggregation)."""
    n = points.shape[0]
    c = frames[0][0].shape[-1]
    out = np.zeros((n, c), np.float32)
    seen = np.zeros(n, bool)
    for feature_map, depth_map, pose in frames:
        feats, valid = project_frame_features(
            points, feature_map, depth_map, pose, projector
        )
        out = np.where(
            valid[:, None], np.maximum(out, feats.astype(np.float32)), out
        )
        seen |= valid
    return out * seen[:, None]
