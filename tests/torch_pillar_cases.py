"""Rotated BEV boxes for the IoU and NMS checks, and counts of how the
kernels' clip settles their pairs (the card's tests and chip_smoke.py
load it without JAX; torch is imported inside the counting functions).

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


def _steps(angle: float, k: int) -> np.float32:
    """float32 ``angle`` moved k representable values up (k > 0) or down."""
    a = np.float32(angle)
    toward = np.float32(np.inf if k > 0 else -np.inf)
    for _ in range(abs(k)):
        a = np.nextafter(a, toward)
    return a


def overflow_boxes() -> np.ndarray:
    """35 equal 1 mm squares at one corner, turned by a quarter, a half or
    a whole turn, each angle up to 3 float32 steps either side. Their
    corners lie within rounding of each other's edges, so a clip emits
    near-duplicate vertices on both sides of a line: hundreds of pairs'
    clips pass 8 vertices (9 at most; no box pair found passes 16)."""
    return np.array([[0.0, 0.0, 1e-3, 1e-3, _steps(base, k)]
                     for base in (-np.pi / 2, np.pi / 2, np.pi, -np.pi,
                                  2 * np.pi)
                     for k in range(-3, 4)], np.float32)


# screen_stages' codes: where the kernels settle a pair (csrc/iou3d.cu)
STAGES = ("empty", "inside", "second_screen", "clip", "past_8")


def _side(pb, k, p):
    """Signed distances (P, V) of points p (P, V, 2) from edge k of the
    corner sets pb (P, 4, 2), in the kernels' arithmetic."""
    a = pb[:, k]
    d = pb[:, (k + 1) % 4] - a
    return (d[:, None, 0] * (p[..., 1] - a[:, None, 1])
            - d[:, None, 1] * (p[..., 0] - a[:, None, 0]))


def _clip_counts(pa, pb):
    """(P,): the most vertices any of a pair's four clips emits, by the
    plain clip (before its 16-slot buffer drops any)."""
    import torch

    from vlp3d_torch.ops import iou3d

    verts = pa.new_zeros((pa.shape[0], 16, 2))
    verts[:, :4] = pa
    count = torch.full((pa.shape[0],), 4, dtype=torch.long, device=pa.device)
    most = count.clone()
    for k in range(4):
        verts, count, _ = iou3d._clip_halfplane(verts, count, pb[:, k],
                                                pb[:, (k + 1) % 4])
        most = torch.maximum(most, count)
    return most


def _pairs(boxes_a, boxes_b, chunk):
    """The pairs' corner sets, (rows, m) pairs at a time: (i0, i1, pa,
    pb), pa / pb (P, 4, 2)."""
    from vlp3d_torch.ops import iou3d

    ca = iou3d.box_to_corners(boxes_a.float())
    cb = iou3d.box_to_corners(boxes_b.float())
    m = cb.shape[0]
    rows = max(1, chunk // max(m, 1))
    for i0 in range(0, ca.shape[0], rows):
        i1 = min(i0 + rows, ca.shape[0])
        yield (i0, i1, ca[i0:i1, None].expand(-1, m, 4, 2).reshape(-1, 4, 2),
               cb[None].expand(i1 - i0, m, 4, 2).reshape(-1, 4, 2))


def max_clip_counts(boxes_a, boxes_b, chunk: int = 1 << 20):
    """(N, M): the most vertices any of a pair's four clips emits. The
    kernels clip a pair in 8 register slots and give one past 8 to JAX's
    16-slot routine."""
    import torch

    out = torch.empty((boxes_a.shape[0], boxes_b.shape[0]), dtype=torch.long,
                      device=boxes_a.device)
    for i0, i1, pa, pb in _pairs(boxes_a, boxes_b, chunk):
        out[i0:i1] = _clip_counts(pa, pb).view(i1 - i0, -1)
    return out


def _stages(pa, pb):
    """screen_stages of the pairs (P, 4, 2), as codes into STAGES."""
    import torch

    p = pa.shape[0]
    # the first screen: clip by clip while A's corners are all inside
    stage = torch.ones(p, dtype=torch.int8, device=pa.device)
    k0 = torch.full((p,), -1, dtype=torch.long, device=pa.device)
    open_ = torch.ones(p, dtype=torch.bool, device=pa.device)
    for k in range(4):
        n_in = (_side(pb, k, pa) >= 0).sum(1)
        stage[open_ & (n_in == 0)] = 0
        k0[open_ & (n_in > 0) & (n_in < 4)] = k
        open_ &= n_in == 4
    # the second screen: the points the clip at k0 emits, against the
    # later edges (exactly two crossings, else the ordered clip)
    for k in range(4):
        sel = (k0 == k).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        qa, qb = pa[sel], pb[sel]
        s = _side(qb, k, qa)
        inside = s >= 0
        cross = inside != inside.roll(-1, 1)
        den = s - s.roll(-1, 1)
        den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
        t = s / den
        pts = torch.cat([qa, qa + (qa.roll(-1, 1) - qa) * t[..., None]], 1)
        live = torch.cat([inside, cross], 1)
        res = torch.full((sel.numel(),), 3, dtype=torch.int8,
                         device=pa.device)
        going = cross.sum(1) == 2
        for kk in range(k + 1, 4):
            n_in = ((_side(qb, kk, pts) >= 0) & live).sum(1)
            res[going & (n_in == 0)] = 2
            going &= n_in == live.sum(1)
        stage[sel] = res
    # the ordered clip: in 8 register slots, or past 8 the 16-slot routine
    clip = (stage == 3).nonzero().squeeze(1)
    if clip.numel():
        past = _clip_counts(pa[clip], pb[clip]) > 8
        stage[clip[past]] = 4
    return stage


def screen_stages(boxes_a, boxes_b, chunk: int = 1 << 20):
    """(N, M) int8 codes into STAGES: where csrc/iou3d.cu's pair routine
    settles each pair, by its screens in PyTorch on the plain corners
    (the card's corners may differ in the last bit: a count, not a
    check). 0 A's corners all outside an edge, 1 all inside every edge
    (A inside B), 2 the second screen (the points the first straddled
    clip emits all outside a later edge), 3 the ordered clip in
    registers, 4 a clip past 8 vertices (the 16-slot routine)."""
    import torch

    out = torch.empty((boxes_a.shape[0], boxes_b.shape[0]), dtype=torch.int8,
                      device=boxes_a.device)
    for i0, i1, pa, pb in _pairs(boxes_a, boxes_b, chunk):
        out[i0:i1] = _stages(pa, pb).view(i1 - i0, -1)
    return out


def stage_shares(boxes_a, boxes_b) -> dict:
    """The share of pairs each stage of STAGES settles."""
    import torch

    codes = screen_stages(boxes_a, boxes_b)
    counts = torch.bincount(codes.flatten().long(), minlength=len(STAGES))
    return {name: float(c) / codes.numel()
            for name, c in zip(STAGES, counts.tolist())}
