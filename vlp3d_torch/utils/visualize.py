"""Scene dumps for viewers: the ASCII PLY writer of
``vlp3d/utils/visualize.py`` (the port's own copy)."""

from __future__ import annotations

import numpy as np


def write_ply_points(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """xyz (N, 3) float; rgb (N, 3) uint8 optional -> ascii PLY."""
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{xyz[i,0]:.4f} {xyz[i,1]:.4f} {xyz[i,2]:.4f}"
            if rgb is not None:
                row += f" {int(rgb[i,0])} {int(rgb[i,1])} {int(rgb[i,2])}"
            f.write(row + "\n")
