"""Inputs where the point-sharded FPS step and the ball-query merge are
likely to go wrong, shared by the CPU tests (against the dense ops) and
the card's smoke (against the kernels' plain versions). numpy only: no
JAX, no torch.
"""

from __future__ import annotations

import numpy as np


def merge_cases():
    """(xyz (1, 64, 3), centres (1, 3, 3)), float32: a ball wholly in
    shard 1 of 4 (16 points a shard), one with a hit in each of the four
    shards, an empty one."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(5.0, 9.0, (1, 64, 3)).astype(np.float32)
    xyz[0, 20:24] = [0.1, 0.0, 0.0]
    xyz[0, [3, 18, 40, 63]] = [-3.0, 0.0, 0.0]
    centers = np.array([[[0.1, 0.0, 0.0], [-3.0, 0.0, 0.05],
                         [50.0, 50.0, 50.0]]], np.float32)
    return xyz, centers


def fps_cases():
    """xyz (2, 64, 3) float32: a row whose points repeat across the
    shards (ties at the shard boundaries: each shard of 4 holds the same
    points) and an all-invalid row (every point at the origin)."""
    rng = np.random.default_rng(4)
    xyz = np.zeros((2, 64, 3), np.float32)
    xyz[0] = np.tile(rng.standard_normal((16, 3)).astype(np.float32),
                     (4, 1))
    return xyz
