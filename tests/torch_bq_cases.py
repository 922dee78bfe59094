"""Inputs where the ball-query tile kernel and the sorted scatter-add
backward are likely to go wrong, shared by the CPU tests (against the
JAX package) and the card tests (against the plain versions). numpy only:
no JAX, no torch.

Ball query. Background points lie in [10, 16]^3, centres in
[0.4, 0.6]^3 and the chosen hit points in [0.45, 0.55]^3, so every chosen
point lies in every ball (radius 0.3) and nothing else does: the hits of
a case are exactly its chosen indices, placed against the segment
boundaries of the tile kernel's plans (rows of 4096 points split in 2,
3, 4, 8 or 16 segments: boundaries at 256-point multiples and at 1366,
2731).
"""

from __future__ import annotations

import numpy as np

BQ_CASES = ("straddle", "fill_at_segment_end", "last_segment", "empty",
            "dense", "n_below_nsample", "n33", "ragged", "exact_radius")


def ball_query_case(name: str):
    """(xyz (B, N, 3), centers (B, M, 3), radius, nsample), float32."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, n, m, radius, nsample = 2, 4096, 70, 0.3, 32
    hits: np.ndarray | list = []
    if name == "straddle":  # runs of hits across 512, 1024 and 1366
        hits = np.r_[500:530, 1020:1030, 1360:1370]
        nsample = 48
    elif name == "fill_at_segment_end":
        # exactly nsample hits ending at the last point of a segment (1023
        # for 4, 8 and 16 segments), then hits that no slot takes
        hits = np.r_[1024 - 32:1024, 3000:3010]
    elif name == "last_segment":
        hits = np.r_[n - 20:n]
    elif name == "empty":
        pass
    elif name == "dense":  # balls fill early: the early stop
        hits = np.sort(rng.choice(n, n // 2, replace=False))
    elif name == "n_below_nsample":
        n, hits = 20, np.r_[3:17]
    elif name == "n33":
        n, hits = 33, [0, 5, 32]
    elif name == "ragged":  # neither n nor m a multiple of any tile
        n, m = 4093, 77
        hits = np.sort(rng.choice(n, 40, replace=False))
    elif name == "exact_radius":
        pass
    else:
        raise KeyError(name)
    xyz = rng.uniform(10.0, 16.0, size=(b, n, 3))
    centers = rng.uniform(0.4, 0.6, size=(b, m, 3))
    xyz[:, hits] = rng.uniform(0.45, 0.55, size=(b, len(hits), 3))
    if name == "exact_radius":
        # radius 0.5: r^2 = 0.25 exactly; d^2 = 0.25 is out, just below in
        radius, nsample = 0.5, 16
        centers[:] = 1.0
        pts = np.array([[1.5, 1.0, 1.0], [1.0, 0.5, 1.0], [1.25, 1.25, 1.25],
                        [1.0, 1.0, np.nextafter(np.float32(1.5), 0)],
                        [1.0, 1.0, 1.5], [0.75, 1.0, 1.0]])
        at = np.sort(rng.choice(n, len(pts), replace=False))
        xyz[:, at] = pts
        centers[1, 5:] = 30.0  # empty balls beside full ones
    return (xyz.astype(np.float32), centers.astype(np.float32), radius,
            nsample)


# (b, n, c, m, k) of the seven row gathers that have a backward in one
# train step: sa2, sa3, sa4 rows (the first layer's 128 channels), the
# two three-NN gathers (256 channels), the proposal centres (K = 1,
# xyz) and the proposal rows
GRAD_SITES = ((8, 2048, 128, 1024, 32), (8, 1024, 128, 512, 16),
              (8, 512, 128, 256, 16), (8, 256, 256, 512, 3),
              (8, 512, 256, 1024, 3), (8, 1024, 3, 256, 1),
              (8, 1024, 128, 256, 16))

GRAD_CASES = ("all_k_equal", "all_rows_into_one", "untouched_rows", "c3",
              "c135", "out_of_range")


def grad_case(name: str):
    """(idx (B, R) int32, grad (B, R, C) float32, n) of one backward case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, n, c, m, k = 3, 600, 64, 100, 16
    if name == "c3":
        c = 3
    elif name == "c135":
        c = 135
    idx = rng.integers(0, n, size=(b, m, k))
    if name == "all_k_equal":  # unfilled balls: one row K times
        idx[:] = idx[:, :, :1]
    elif name == "all_rows_into_one":
        idx[:] = 7
        idx[1] = 0
        idx[2] = n - 1
    elif name == "untouched_rows":  # odd rows: nothing points at them
        idx = idx // 2 * 2
    elif name == "out_of_range":  # dropped, never followed
        idx[0, 0, 0], idx[1, 3, 2], idx[2, 9, 15] = n, -1, n + 1000
    elif name not in ("c3", "c135"):
        raise KeyError(name)
    grad = rng.standard_normal((b, m * k, c)).astype(np.float32)
    return idx.reshape(b, m * k).astype(np.int32), grad, n
