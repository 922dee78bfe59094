"""Rotated BEV boxes for the IoU and NMS checks, numpy only (the card's
tests and chip_smoke.py load it without JAX).

Boxes are [x1, y1, x2, y2, angle], float32.
"""

import numpy as np


def bev_boxes(n: int, seed: int, spread: float = 6.0,
              size=(0.3, 2.0)) -> np.ndarray:
    """n seeded boxes: centres uniform over [0, spread)^2, sides uniform
    over ``size``, angles over [-pi, pi)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, spread, (n, 2))
    s = rng.uniform(size[0], size[1], (n, 2))
    a = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([c - s / 2, c + s / 2, a], 1).astype(np.float32)


def edge_boxes() -> np.ndarray:
    """Identical, edge-sharing, nested and zero-area boxes (a zero union
    gives an IoU of 2e8: the union is clipped at 1e-8), and angles at
    multiples of pi / 2."""
    q = np.pi / 2
    return np.array([
        [0, 0, 2, 1, 0.7], [0, 0, 2, 1, 0.7], [2, 0, 4, 1, 0],
        [0.5, 0.25, 1.5, 0.75, 0], [0, 0, 2, 1, 0], [0, 0, 0, 0, 0],
        [0, 0, 2, 1, q], [0, 0, 2, 1, 2 * q], [1, 1, 1, 1, 0.3],
        [0, 0, 2, 1, -q], [0, 1, 2, 2, 0], [0, 0, 2, 1, 3 * q],
    ], np.float32)
