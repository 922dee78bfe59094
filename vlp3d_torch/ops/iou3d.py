"""Rotated bird's-eye-view box overlap, IoU and NMS.

Counterpart of ``vlp3d/ops/iou3d.py`` (boxes [x1, y1, x2, y2, angle],
rotated about their centre): the intersection of two boxes is box A's
4-gon clipped against box B's four half-planes in a fixed 16-slot vertex
buffer, with JAX's arithmetic and its buffer's rules (an emission past
slot 15 is dropped while the count goes on; a read past slot 15 reads
slot 15). NMS is greedy in score order over the ranked IoU matrix and,
as JAX does, suppresses over a kept box's whole row, earlier boxes
included (ROADMAP C23): where the matrix is asymmetric a later kept box
can drop an earlier kept one.

A CUDA tensor goes to the hand-written kernels (``csrc/iou3d.cu``: a
corner table, then tiles of screened pairs, the clip in registers;
NMS's mask by warp ballot and a scan over 64-row blocks), a CPU tensor
to the ``*_plain`` functions; there is no fallback between the two.
Ranking is ``torch.argsort(-scores, stable=True)``, JAX's stable
``jnp.argsort(-scores)``, outside the kernels as in JAX.
"""

from __future__ import annotations

import torch

from vlp3d_torch.ops import _kernels

_MAXV = 16
# the NMS scan keeps its removed bitmap, a word per 64 boxes, in shared
# memory (with its 2 x 64 diagonal words: 49 KB here)
MAX_NMS_BOXES = 64 * (48 * 1024 // 8)
_CORNERS = 9  # a corner table's row: x0..x3, y0..y3, area
# pairs a chunk of the plain overlap (its buffers are 16 slots a pair)
_PLAIN_PAIRS = 1 << 20


def box_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x1, y1, x2, y2, angle] -> (..., 4, 2) corners,
    counter-clockwise."""
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    hx = (boxes[..., 2] - boxes[..., 0]) / 2.0
    hy = (boxes[..., 3] - boxes[..., 1]) / 2.0
    c, s = torch.cos(boxes[..., 4]), torch.sin(boxes[..., 4])
    sx = boxes.new_tensor([-1.0, 1.0, 1.0, -1.0])
    sy = boxes.new_tensor([-1.0, -1.0, 1.0, 1.0])
    lx, ly = sx * hx[..., None], sy * hy[..., None]
    c, s = c[..., None], s[..., None]
    x = (lx * c - ly * s) + cx[..., None]
    y = (lx * s + ly * c) + cy[..., None]
    return torch.stack([x, y], dim=-1)


def _next_slot(count: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(_MAXV, device=count.device)
    nxt = torch.where(idx + 1 >= count[:, None], 0, idx + 1)
    return nxt.clamp(max=_MAXV - 1)  # a read past the end reads slot 15


def _clip_halfplane(verts, count, a, b):
    """Clip the padded polygons (P, 16, 2) with counts (P,) by the
    half-plane left of each pair's edge a -> b (P, 2); returns the
    clipped polygons, their counts and the edges that crossed (P,)."""
    d = b - a
    idx = torch.arange(_MAXV, device=verts.device)
    nxt = _next_slot(count)
    nxt_v = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))

    def signed(p):
        return (d[:, None, 0] * (p[..., 1] - a[:, None, 1])
                - d[:, None, 1] * (p[..., 0] - a[:, None, 0]))

    s_cur, s_nxt = signed(verts), signed(nxt_v)
    inside_cur, inside_nxt = s_cur >= 0, s_nxt >= 0
    den = s_cur - s_nxt
    t = s_cur / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12),
                            den)
    inter = verts + (nxt_v - verts) * t[..., None]
    live = idx < count[:, None]
    emit = torch.stack([inside_cur & live, (inside_cur != inside_nxt) & live],
                       dim=2).reshape(-1, 2 * _MAXV)
    pts = torch.stack([verts, inter], dim=2).reshape(-1, 2 * _MAXV, 2)
    pos = torch.cumsum(emit.long(), 1) - 1
    # an emission past slot 15 goes to a spare row, sliced off
    at = torch.where(emit & (pos < _MAXV), pos, _MAXV)
    out = verts.new_zeros((verts.shape[0], _MAXV + 1, 2))
    out.scatter_(1, at[..., None].expand(-1, -1, 2), pts)
    return out[:, :_MAXV], emit.sum(1), emit[:, 1::2].sum(1)


def _poly_area(verts, count):
    idx = torch.arange(_MAXV, device=verts.device)
    nxt_v = torch.gather(verts, 1, _next_slot(count)[..., None].expand(
        -1, -1, 2))
    cross = verts[..., 0] * nxt_v[..., 1] - nxt_v[..., 0] * verts[..., 1]
    cross = torch.where(idx < count[:, None], cross, 0.0)
    total = torch.zeros_like(cross[:, 0])
    for k in range(_MAXV):  # in vertex order, as the kernel sums
        total = total + cross[:, k]
    return total.abs() / 2.0


# fp32 operations of the clip's arithmetic (csrc/iou3d.cu's pair_overlap):
# a vertex's signed distance (5) and inside test (2, for it and its
# successor); an edge that crosses, its denominator and its test (2), t
# and the intersection (7); a vertex of the area's sum; the edge vector
# of each clip; |sum| / 2 and the IoU
OPS_VERTEX, OPS_CROSSING, OPS_AREA_VERTEX, OPS_CLIP, OPS_PAIR = 7, 9, 4, 2, 6


def _pair_overlap(ca, cb, ops=None):
    """Intersection areas of corner sets ca, cb (P, 4, 2). ``ops``, a
    list, receives the fp32 operations the pairs' clips need (for a
    bound on the card): the vertices each clip walks and the edges that
    cross depend on the data."""
    p = ca.shape[0]
    verts = ca.new_zeros((p, _MAXV, 2))
    verts[:, :4] = ca
    count = torch.full((p,), 4, dtype=torch.long, device=ca.device)
    for k in range(4):
        walked = count.clamp(max=_MAXV)
        verts, count, crossed = _clip_halfplane(verts, count, cb[:, k],
                                                cb[:, (k + 1) % 4])
        if ops is not None:
            ops.append(OPS_CLIP * p + OPS_VERTEX * walked.sum()
                       + OPS_CROSSING * crossed.sum())
    if ops is not None:
        ops.append(OPS_PAIR * p + OPS_AREA_VERTEX * torch.where(
            count >= 3, count.clamp(max=_MAXV), 0).sum())
    return torch.where(count >= 3, _poly_area(verts, count), 0.0)


def boxes_overlap_bev_plain(boxes_a, boxes_b, ops=None):
    """Plain PyTorch :func:`boxes_overlap_bev`, in chunks of rows
    (``ops``: see :func:`_pair_overlap`)."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    ca, cb = box_to_corners(boxes_a.float()), box_to_corners(boxes_b.float())
    out = ca.new_zeros((n, m))
    rows = max(1, _PLAIN_PAIRS // max(m, 1))
    for i in range(0, n, rows):
        a = ca[i:i + rows]
        r = a.shape[0]
        pa = a[:, None].expand(r, m, 4, 2).reshape(-1, 4, 2)
        pb = cb[None].expand(r, m, 4, 2).reshape(-1, 4, 2)
        out[i:i + r] = _pair_overlap(pa, pb, ops).view(r, m)
    return out


def _areas(boxes):
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def boxes_iou_bev_plain(boxes_a, boxes_b, ops=None):
    """Plain PyTorch :func:`boxes_iou_bev` (``ops``: see
    :func:`_pair_overlap`)."""
    inter = boxes_overlap_bev_plain(boxes_a, boxes_b, ops)
    a, b = _areas(boxes_a.float()), _areas(boxes_b.float())
    return inter / torch.clamp(a[:, None] + b[None, :] - inter, min=1e-8)


def _iou_cuda(boxes_a, boxes_b, iou: bool):
    _kernels.require(boxes_a, "boxes_a", torch.float32, 2, 5)
    _kernels.require(boxes_b, "boxes_b", torch.float32, 2, 5)
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=boxes_a.device)
    tables = torch.empty((n + m, _CORNERS), dtype=torch.float32,
                         device=boxes_a.device)
    with _kernels.on_device(boxes_a):
        rc = _kernels.function("iou3d", "vlp3d_iou_bev")(
            boxes_a.data_ptr(), boxes_b.data_ptr(), n, m, int(iou),
            tables.data_ptr(), out.data_ptr(), _kernels.stream_ptr(boxes_a))
        _kernels.check(rc, "iou_bev kernel")
    _kernels.launches["boxes_iou_bev"] += 1
    return out


def boxes_overlap_bev(boxes_a: torch.Tensor,
                      boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) rotated intersection areas."""
    with torch.no_grad():
        if _kernels.cuda_or_cpu(boxes_a):
            return _iou_cuda(boxes_a.contiguous(), boxes_b.contiguous(),
                             False)
        return boxes_overlap_bev_plain(boxes_a, boxes_b)


def boxes_iou_bev(boxes_a: torch.Tensor,
                  boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) rotated BEV IoU."""
    with torch.no_grad():
        if _kernels.cuda_or_cpu(boxes_a):
            return _iou_cuda(boxes_a.contiguous(), boxes_b.contiguous(),
                             True)
        return boxes_iou_bev_plain(boxes_a, boxes_b)


def nms_scan_plain(ious: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS over a score-ranked (N, N) IoU matrix: the alive mask
    (N,) in rank order. Box i, if alive, drops every j != i of its row
    with iou[i, j] > thresh (JAX's ``fori_loop`` body)."""
    n = ious.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=ious.device)
    over = ious > torch.tensor(thresh, dtype=ious.dtype)
    over.fill_diagonal_(False)
    for i in range(n):
        alive &= ~(over[i] & alive[i])
    return alive


def rank_boxes(scores: torch.Tensor) -> torch.Tensor:
    """Rank -> box index: descending score, ties by index."""
    return torch.argsort(-scores, stable=True)


def nms_rotated_plain(boxes, scores, thresh: float):
    """Plain PyTorch :func:`nms_rotated`."""
    order = rank_boxes(scores)
    ranked = boxes.float()[order]
    alive = nms_scan_plain(boxes_iou_bev_plain(ranked, ranked), thresh)
    keep = torch.zeros_like(alive)
    keep[order] = alive
    return keep


def _nms_cuda(boxes, scores, thresh: float):
    _kernels.require(boxes, "boxes", torch.float32, 2, 5)
    n = boxes.shape[0]
    if n > MAX_NMS_BOXES:
        raise ValueError(f"{n} boxes: the NMS scan holds {MAX_NMS_BOXES}")
    order = rank_boxes(scores)
    ranked = boxes[order].contiguous()
    words = -(-n // 64)
    table = torch.empty((n, _CORNERS), dtype=torch.float32,
                        device=boxes.device)
    mask = torch.empty((n, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((n,), dtype=torch.bool, device=boxes.device)
    with _kernels.on_device(boxes):
        rc = _kernels.function("iou3d", "vlp3d_nms_bev")(
            ranked.data_ptr(), order.data_ptr(), n, float(thresh),
            table.data_ptr(), mask.data_ptr(), keep.data_ptr(),
            _kernels.stream_ptr(boxes))
        _kernels.check(rc, "nms_bev kernels")
    _kernels.launches["nms_bev"] += 1
    return keep


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                thresh: float) -> torch.Tensor:
    """Greedy rotated NMS: a keep mask (N,) bool by box."""
    with torch.no_grad():
        if _kernels.cuda_or_cpu(boxes):
            return _nms_cuda(boxes.contiguous(), scores, thresh)
        return nms_rotated_plain(boxes, scores, thresh)


def nms_normal(boxes: torch.Tensor, scores: torch.Tensor, thresh: float):
    """Axis-aligned NMS: the angle set to 0."""
    b = boxes.clone()
    b[:, 4] = 0.0
    return nms_rotated(b, scores, thresh)
