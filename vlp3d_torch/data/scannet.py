"""Preprocessed ScanNet scenes: the layout check the scene loader runs.

The port's own copy of ``check_preprocess_layout`` from
``vlp3d/data/scannet.py``. The rest of that module (the ScanNet export
and preprocessing CLI) is ROADMAP.md queue A item A22.
"""

from __future__ import annotations

import numpy as np


def check_preprocess_layout(point_cloud: np.ndarray, path: str = "") -> None:
    """Detect stale `_preprocess_*.npy` caches written with the old fuse
    order [xyz, color?, multiview, normal] (normals LAST). The current
    order is [xyz, color?, normal, multiview] (normals before multiview,
    vlp3d/data/scannet.py build_preprocess); both layouts have identical
    shapes, so a stale cache would silently feed multiview channels into
    the relation module's channel-6 slice. Heuristic: face-accumulated
    normals are (near-)unit or zero vectors, multiview activations are
    not. Raises only when the expected block clearly fails AND the
    trailing block clearly passes."""
    width = point_cloud.shape[1]
    if width == 134:  # xyz + normal(3) + multiview(128)
        expect = point_cloud[:, 3:6]
    elif width == 137:  # xyz + color(3) + normal(3) + multiview(128)
        expect = point_cloud[:, 6:9]
    else:
        return

    def unit_or_zero_frac(block):
        n = np.linalg.norm(block, axis=1)
        return float(np.mean((np.abs(n - 1.0) < 0.05) | (n < 1e-6)))

    def strictly_unit_frac(block):
        # zero rows deliberately NOT counted: dead post-ReLU multiview
        # channels are all-zero and must not pass as "normals" (a valid
        # [xyz, color, multiview] width-134 cache would otherwise be
        # rejected when its trailing ENet channels are dead)
        n = np.linalg.norm(block, axis=1)
        return float(np.mean(np.abs(n - 1.0) < 0.05))

    if (unit_or_zero_frac(expect) < 0.5
            and strictly_unit_frac(point_cloud[:, -3:]) > 0.9):
        raise ValueError(
            f"stale preprocess cache {path or '(array)'}: normals found in "
            "the trailing columns (old fuse order [xyz, color?, multiview, "
            "normal]); regenerate with vlp3d-preprocess / "
            "scannet.build_preprocess, which writes [xyz, color?, normal, "
            "multiview]"
        )
