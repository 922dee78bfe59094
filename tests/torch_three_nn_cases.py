"""Inputs where the three-NN team kernel and its fused interpolation are
likely to go wrong, shared by the CPU tests (against the JAX package) and
the card tests (against the plain versions). numpy only: no JAX, no torch.

The team kernel splits a row's known points over L lanes (j = t mod L),
keeps a top 3 a lane and merges the lanes' lists under the order (d, then
j); the cases put ties across and inside lanes (duplicated known points,
points at one exact distance, an all-zero row, unknown points on known
points), m below, at and off a multiple of L, n off a multiple of the
points a block, squared distances that overflow to inf, channel widths
that take the scalar path (3, 5, 13) and the float4 path (8 to 256), and
B = 1, 3, 9. Every unknown point has at least one finite distance, so the
weights stay finite.
"""

from __future__ import annotations

import numpy as np

NN_CASES = ("random", "duplicated_known", "all_zero_known",
            "unknown_on_known", "equidistant", "m3", "m_below_lanes",
            "ragged", "huge", "fp_subset", "b1", "b3", "b9", "c256")


def nn_case(name: str):
    """(unknown (B, N, 3), known (B, M, 3), feats (B, M, C)), float32."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, n, m, c = 2, 70, 25, 16
    if name == "b1":
        b, n, m, c = 1, 100, 48, 8
    elif name == "b3":
        b, n, m, c = 3, 100, 48, 8
    elif name == "b9":
        b, n, m, c = 9, 100, 48, 8
    elif name == "c256":
        n, m, c = 200, 96, 256
    elif name == "m3":
        n, m, c = 33, 3, 5
    elif name == "m_below_lanes":
        n, m, c = 40, 5, 3
    elif name == "ragged":  # neither n nor m a multiple of a lane or block
        n, m, c = 45, 37, 13
    elif name == "equidistant":
        n, m, c = 40, 70, 13
    elif name == "duplicated_known":
        m = 40
    elif name == "all_zero_known":
        m, c = 50, 8
    elif name == "unknown_on_known":
        n, m, c = 130, 64, 256
    elif name == "fp_subset":
        n, m, c = 128, 64, 32
    elif name == "huge":
        n, m, c = 30, 20, 4
    elif name != "random":
        raise KeyError(name)
    unknown = rng.normal(size=(b, n, 3))
    known = rng.normal(size=(b, m, 3))
    if name == "duplicated_known":
        # j and j + 20 (one lane for L = 4, others above), j and j + 1
        # (neighbouring lanes)
        known[:, 20:] = known[:, :20]
        known[:, 11] = known[:, 10]
    elif name == "all_zero_known":  # every distance of row 1 ties
        known[1] = 0.0
    elif name == "unknown_on_known":
        # d^2 = 0, twice where two known points coincide
        known[:, 40] = known[:, 5]
        unknown[:, :m] = known[:, rng.permutation(m)]
    elif name == "equidistant":
        # points at (+-1, +-2, +-2) around an unknown point at the origin:
        # d^2 = 9 exactly in every summation order, spread over the lanes
        signs = np.array([[x, y, z] for x in (1, -1) for y in (1, -1)
                          for z in (1, -1)])
        ring = np.concatenate([signs * p for p in ([1, 2, 2], [2, 1, 2],
                                                   [2, 2, 1])])  # 24 points
        known = rng.uniform(3.5, 6.0, size=(b, m, 3))
        at = np.sort(rng.choice(m, len(ring), replace=False))
        known[:, at] = ring
        unknown[:, :10] = 0.0
    elif name == "fp_subset":  # the FP2 shape: known a subset of unknown
        unknown[:, ::2] = known
    elif name == "huge":
        # squared distances that overflow float32 to inf: known points
        # at +-1e20 lie at inf from every ordinary unknown point; unknown
        # points on a huge known point have one finite distance (0)
        known[:, 3] = 1e20
        known[:, 7] = -1e20
        known[:, 15] = [1e20, -1e20, 1e20]
        unknown[:, 5] = 1e20
        unknown[:, 6] = -1e20
        unknown[:, 20] = [1e20, -1e20, 1e20]
    feats = rng.normal(size=(b, m, c))
    return (unknown.astype(np.float32), known.astype(np.float32),
            feats.astype(np.float32))
