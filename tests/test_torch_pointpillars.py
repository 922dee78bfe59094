"""The port's PointPillars ops and encoder against the JAX package's, on
the CPU.

Voxelization (``vlp3d_torch.ops.voxelize``, plain path) equals
``vlp3d.ops.voxelize`` and the sequential oracle of
``tests/test_voxel_iou.py`` exactly, every output: points on cell
boundaries and at the range's upper edge, negative coordinates, the
voxel cap and the slot cap, every point out of range, one cell holding
every point; the point gradient through ``voxels`` equals ``jax.vjp``'s.
The rotated BEV overlap and IoU are within 1e-5 of JAX's (``sin`` and
``cos`` round differently in XLA and torch); NMS keep masks equal JAX's
exactly when the port's scan runs on JAX's own ranked IoU matrix, and on
the port's matrix where no ranked pair is within 1e-5 of the threshold.
C23 (the whole-row suppression) and C24 (training BatchNorm statistics
over empty voxels) are pinned. ``PillarEncoder`` through
``pillar_encoder_to_torch_state_dict``: the canvas within 1e-5 of the
largest entry in evaluation; in training the canvas within 1e-5, the
running statistics and the parameter and point gradients within 1e-4 of
the largest entry. The CPU path launches no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_voxel_iou import hard_voxelize_oracle
from torch_pillar_cases import (STAGES, bev_boxes, edge_boxes, max_clip_counts,
                                overflow_boxes, screen_stages)
from vlp3d.models.pointpillars import PillarEncoder as JaxPillarEncoder
from vlp3d.ops import iou3d as jax_iou
from vlp3d.ops import voxelize as jax_vox
from vlp3d_torch.convert import pillar_encoder_to_torch_state_dict
from vlp3d_torch.models.pointpillars import PillarEncoder
from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops import iou3d, voxelize

IOU_TOL = 1e-5
TIE_MARGIN = 1e-5
CANVAS_TOL = 1e-5  # of the largest entry
GRAD_TOL = 1e-4  # of the largest entry

# the JAX functions jitted (one compile a shape instead of one an op)
jax_hard = jax.jit(jax_vox.hard_voxelize, static_argnums=(1, 2, 3, 4))
jax_dynamic = jax.jit(jax_vox.dynamic_voxelize, static_argnums=(1, 2))
jax_nms = {"rotated": jax.jit(jax_iou.nms_rotated, static_argnums=2),
           "normal": jax.jit(jax_iou.nms_normal, static_argnums=2)}

KITTI = ((0.16, 0.16, 4.0), (0.0, -39.68, -3.0, 69.12, 39.68, 1.0))
SMALL = ((0.5, 0.5, 0.5), (0.0, 0.0, 0.0, 2.0, 2.0, 2.0))
# OpenPCDet's SECOND (kitti_models/second.yaml): 1408 x 1600 x 40 cells
SECOND = ((0.05, 0.05, 0.1), (0.0, -40.0, -3.0, 70.4, 40.0, 1.0))


def _cloud(rng, case):
    """(points (N, 4), voxel_size, coors_range, max_points, max_voxels)."""
    vs, cr = SMALL
    if case == "uniform":
        pts = rng.uniform(-1, 3, (500, 4))
        return pts, vs, cr, 8, 32
    if case == "slot_cap":
        pts = rng.uniform(0, 2, (400, 4))
        return pts, vs, cr, 3, 100
    if case == "voxel_cap":
        pts = rng.uniform(0, 2, (400, 4))
        return pts, vs, cr, 35, 20
    if case == "boundaries":
        # every coordinate on a cell boundary, the range's edges included
        # (hi is outside), a step either side of them
        # (at 0 a step of 1e-7: XLA's CPU flushes subnormals to zero)
        g = (np.arange(-2, 7) * 0.5).astype(np.float32)
        up = np.where(g == 0, np.float32(1e-7), np.nextafter(g, 9))
        g = np.concatenate([g, up, np.where(g == 0, -up, np.nextafter(
            g, -9))])
        xyz = np.stack(np.meshgrid(g, g[::5], g[::7]), -1).reshape(-1, 3)
        pts = np.concatenate([xyz, rng.normal(size=(len(xyz), 1))], 1)
        return pts[rng.permutation(len(pts))], vs, cr, 4, 40
    if case == "kitti_negative":
        vs, cr = KITTI
        pts = rng.uniform([-3, -42, -4, 0], [72, 42, 2, 1], (3000, 4))
        return pts, vs, cr, 6, 700
    if case == "all_out":
        pts = rng.uniform(2.0, 5.0, (200, 4))
        pts[:50, :3] *= -1
        return pts, vs, cr, 8, 16
    if case == "one_cell":
        pts = rng.uniform(0.5, 0.999, (300, 4))
        return pts, vs, cr, 32, 16
    raise ValueError(case)


CASES = ["uniform", "slot_cap", "voxel_cap", "boundaries", "kitti_negative",
         "all_out", "one_cell"]


@pytest.mark.parametrize("case", CASES)
def test_voxelize_equals_jax_and_oracle(case):
    rng = np.random.default_rng(CASES.index(case))
    pts, vs, cr, p, v = _cloud(rng, case)
    pts = pts.astype(np.float32)
    want = jax_hard(jnp.asarray(pts), vs, cr, p, v)
    got = voxelize.hard_voxelize(torch.from_numpy(pts), vs, cr, p, v)
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert np.array_equal(g, w), k
    vox, coors, num, voxel_num = hard_voxelize_oracle(pts, vs, cr, p, v)
    assert int(got["voxel_num"]) == voxel_num
    assert np.array_equal(got["coors"].numpy(), coors)
    assert np.array_equal(got["num_points_per_voxel"].numpy(), num)
    assert np.array_equal(got["voxels"].numpy(), vox)
    jc, jg = jax_dynamic(jnp.asarray(pts), vs, cr)
    pc, pg = voxelize.dynamic_voxelize(torch.from_numpy(pts), vs, cr)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert np.array_equal(pg.numpy(), np.asarray(jg))
    if case == "voxel_cap":
        assert voxel_num == v and num.max() <= p
    if case == "slot_cap":
        assert num.max() == p
    if case == "all_out":
        assert voxel_num == 0 and (pc.numpy() == -1).all()
    if case == "one_cell":
        assert voxel_num == 1 and num[0] == 32


def test_batched_voxelize_is_the_rows():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 3, (3, 300, 4)).astype(np.float32)
    pts[2, :200, :3] = 0.7  # one cell past the slot cap
    x = torch.from_numpy(pts)
    both = voxelize.hard_voxelize(x, *SMALL, 5, 24)
    for b in range(3):
        one = voxelize.hard_voxelize(x[b], *SMALL, 5, 24)
        for k, v in one.items():
            assert torch.equal(both[k][b], v), (b, k)


def test_voxelize_point_gradient_equals_jax_vjp():
    rng = np.random.default_rng(5)
    pts, vs, cr, p, v = _cloud(rng, "slot_cap")
    pts = pts.astype(np.float32)
    pts[:60, :3] = 1.2  # one crowded cell: dropped points get 0
    out, vjp = jax.vjp(lambda q: jax_hard(q, vs, cr, p, v)["voxels"],
                       jnp.asarray(pts))
    g = rng.normal(size=out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(pts).requires_grad_(True)
    voxels = voxelize.hard_voxelize(x, vs, cr, p, v)["voxels"]
    voxels.backward(torch.from_numpy(g))
    assert np.array_equal(x.grad.numpy(), np.asarray(want))
    assert (x.grad[:60].abs().sum(1) == 0).sum() >= 60 - p


# -- the hard kernel's algorithm (csrc/voxelize.cu (a)-(d)) in numpy ------

EMU_TILE = 64  # points a tile of the emulated prefix sum
EMU_WARP_LONG = 256  # the longest segment the emulated warp merges
EMU_WINDOW = 96  # point indices a window of the emulated bitmap


def _emulate_hard_row(pts, coords, grid, max_points, max_voxels, rng):
    """One batch row through the steps of ``vlp3d_hard_voxelize``, every
    order the card leaves to its atomics and to the tiles' timing drawn
    from ``rng``, the cell table addressed as the kernel addresses it (by
    the key where the grid fits the table, else hashed): (voxels, coors,
    num, voxel_num, mask, slot)."""
    n, c = pts.shape
    g0, g1, _ = (int(g) for g in grid)
    j = np.arange(n)
    # (a) keys, each cell's entry in the row's hash table (claimed in the
    # order the atomics run, probed linearly from the multiplicative
    # hash); a cell's head entry n - (its first index) by max, 0 when
    # empty; its count
    cell = np.where(coords[:, 0] < 0, -1,
                    (coords[:, 2].astype(np.int64) * g1 + coords[:, 1]) * g0
                    + coords[:, 0])
    slots = voxelize.table_slots(n)
    shift = 33 - slots.bit_length()
    tags = np.zeros(slots, np.int64)
    key = cell.copy()  # a grid that fits the table: the key is the entry
    for q in ([] if g0 * g1 * int(grid[2]) <= slots else
              rng.permutation(np.flatnonzero(cell >= 0))):
        e = (int(cell[q]) * 2654435761 & 0xffffffff) >> shift
        while tags[e] not in (0, cell[q] + 1):
            e = (e + 1) & (slots - 1)
        tags[e], key[q] = cell[q] + 1, e
    head = np.zeros(slots, np.int64)
    count = np.zeros(slots, np.int64)
    order = rng.permutation(np.flatnonzero(key >= 0))
    np.maximum.at(head, key[order], n - order)
    np.add.at(count, key[order], 1)
    # (b) the pair (heads, their points) summed tile by tile: a tile
    # publishes its sum, looks back over its predecessors' words (some
    # still sums) to the first inclusive one, publishes its inclusive
    # prefix; a kept head records its voxel and turns its cell's entry
    # into -1 - offset
    vhead, voff, vcnt = (np.zeros(max_voxels, np.int64) for _ in range(3))
    status, incl = [], []  # (inclusive?, pair) as later tiles read them
    for t0 in range(0, n, EMU_TILE):
        tj = j[t0:t0 + EMU_TILE]
        tk = np.maximum(key[tj], 0)
        flag = (key[tj] >= 0) & (head[tk] == n - tj)
        h, pc = flag.astype(np.int64), np.where(flag, count[tk], 0)
        excl = np.zeros(2, np.int64)
        for inclusive, pair in reversed(status):
            excl += pair
            if inclusive:
                break
        incl.append(excl + [h.sum(), pc.sum()])
        status.append((False, incl[-1] - excl))
        for q in np.flatnonzero(rng.random(len(status)) < 0.5):
            status[q] = (True, incl[q])  # inclusive words arrive late
        vid = excl[0] + np.cumsum(h) - h
        off = excl[1] + np.cumsum(pc) - pc
        kept = flag & (vid < max_voxels)
        vhead[vid[kept]], voff[vid[kept]] = tj[kept], off[kept]
        vcnt[vid[kept]] = pc[kept]
        head[tk[kept]] = -1 - off[kept]
    voxel_num = min(int(incl[-1][0]) if incl else 0, max_voxels)
    # (c) every point, in a shuffled order, takes one from its cell's
    # entry; an entry below 0 (a kept cell's -1 - next place) places it
    order = rng.permutation(np.flatnonzero(key >= 0))
    ks = key[order]
    by_cell = np.argsort(ks, kind="stable")
    rank = np.empty_like(by_cell)
    rank[by_cell] = (np.arange(len(ks))
                     - np.searchsorted(ks[by_cell], ks[by_cell]))
    old = head[ks] - rank
    assert ((old < 0) == (head[ks] < 0)).all()  # a dropped cell stays >= 1
    seg = np.full(n, -1)
    seg[-1 - old[old < 0]] = order[old < 0]
    live = np.sort(order[old < 0])
    assert np.array_equal(np.sort(seg[:len(live)]), live)
    # (d) a voxel's kept points: the min(count, max_points) smallest
    # indices of its segment, by a sort up to 32; by a running merge of
    # 32-entry chunks where max_points <= 32 and the segment is short
    # enough for a warp; else by a bitmap over windows of the row
    voxels = np.zeros((max_voxels, max_points, c), np.float32)
    coors = np.full((max_voxels, 3), -1, np.int32)
    num = np.zeros(max_voxels, np.int32)
    slot = np.full(n, -1, np.int32)
    for v in range(voxel_num):
        s = seg[voff[v]:voff[v] + vcnt[v]]
        kept = min(len(s), max_points)
        if len(s) <= 32:
            sel = np.sort(s)[:kept]
        elif max_points <= 32 and len(s) <= EMU_WARP_LONG:
            sel = np.sort(s[:32])
            for t0 in range(32, len(s), 32):
                chunk = s[t0:t0 + 32]
                if (chunk < sel[-1]).any():  # else the merge is skipped
                    sel = np.sort(np.concatenate([sel, chunk]))[:32]
            sel = sel[:kept]
        else:
            sel = np.zeros(0, np.int64)
            for w0 in range(0, n, EMU_WINDOW):
                if len(sel) >= kept:
                    break
                bits = np.zeros(EMU_WINDOW, bool)
                bits[s[(s >= w0) & (s < w0 + EMU_WINDOW)] - w0] = True
                sel = np.concatenate([sel, w0 + np.flatnonzero(bits)])
            sel = sel[:kept]
        voxels[v, :kept] = pts[sel]
        slot[sel] = v * max_points + np.arange(kept)
        coors[v] = coords[vhead[v]]
        num[v] = kept
    mask = np.arange(max_voxels) < voxel_num
    return voxels, coors, num, voxel_num, mask, slot


def _emu_cloud(rng, case):
    """(points (B, N, C), voxel_size, coors_range, max_points,
    max_voxels) over SMALL's 4 x 4 x 4 grid."""
    vs, cr = SMALL
    if case == "hot_cell":  # cells of 400 and 100 of 700 points, shuffled
        pts = rng.uniform(-0.5, 2.5, (1, 700, 5))
        pts[0, :400, :3] = rng.uniform(1.01, 1.49, (400, 3))
        pts[0, 400:500, :3] = rng.uniform(0.01, 0.49, (100, 3))
        pts[0] = pts[0, rng.permutation(700)]
        return pts, vs, cr, 32, 40
    if case == "voxel_cap":  # and a cell of 60 past 32 lanes, slots 35
        pts = rng.uniform(0, 2, (1, 500, 3))
        pts[0, 5:65, :3] = rng.uniform(0.51, 0.99, (60, 3))
        return pts, vs, cr, 35, 20
    if case == "one_slot":
        return rng.uniform(-0.5, 2.5, (1, 300, 5)), vs, cr, 1, 64
    if case == "row_all_out":  # the second row lies outside the range
        pts = rng.uniform(0, 2, (2, 200, 3))
        pts[1, :, 0] += 3.0
        return pts, vs, cr, 8, 64
    if case == "second_grid":  # SECOND's KITTI grid, 90 112 000 cells
        vs, cr = SECOND
        pts = np.concatenate([rng.uniform(cr[:3], cr[3:], (1, 600, 3)),
                              rng.uniform(0, 1, (1, 600, 1))], -1)
        pts[0, :300, :3] = (rng.uniform(-0.06, 0.06, (300, 3))
                            + [30.0, 2.0, -1.0])
        return pts, vs, cr, 5, 400
    raise ValueError(case)


@pytest.mark.parametrize("case", ["hot_cell", "voxel_cap", "one_slot",
                                  "row_all_out", "second_grid"])
def test_hard_kernel_algorithm_emulated_equals_plain_and_jax(case):
    """The hard kernel's steps in numpy (head and count, the tile-wise
    pair prefix sum with look-back, placement in a shuffled order, the
    smallest-max_points selection by sort, merge and bitmap) equal
    hard_voxelize_plain and JAX's hard_voxelize bit for bit, every
    output."""
    rng = np.random.default_rng(len(case))
    pts, vs, cr, p, v = _emu_cloud(rng, case)
    pts = pts.astype(np.float32)
    x = torch.from_numpy(pts)
    coords, grid = voxelize.dynamic_voxelize_plain(x, vs, cr)
    want = voxelize.hard_voxelize_plain(x, vs, cr, p, v)
    keys = ("voxels", "coors", "num_points_per_voxel", "voxel_num",
            "voxel_mask")
    for b in range(pts.shape[0]):
        got = _emulate_hard_row(pts[b], coords[b].numpy(), grid.numpy(), p,
                                v, rng)
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w[b])
            assert np.array_equal(np.asarray(g), w) and \
                np.asarray(g).shape == w.shape, (b, k)
        jw = jax_hard(jnp.asarray(pts[b]), vs, cr, p, v)
        for k, g in zip(keys, got):
            assert np.array_equal(np.asarray(g), np.asarray(jw[k])), (b, k)
    if case == "hot_cell":
        assert int(want[2].max()) == p
    if case == "voxel_cap":
        assert int(want[3][0]) == v and int(want[2].max()) == p
    if case == "row_all_out":
        assert int(want[3][1]) == 0


@pytest.mark.parametrize("which", ["random", "edges", "overflow"])
def test_iou_and_overlap_within_tolerance_of_jax(which):
    if which == "random":
        a, b = bev_boxes(40, 3), bev_boxes(33, 4)
    else:
        a = b = edge_boxes() if which == "edges" else overflow_boxes()
    for jf, pf in ((jax_iou.boxes_iou_bev, iou3d.boxes_iou_bev),
                   (jax_iou.boxes_overlap_bev, iou3d.boxes_overlap_bev)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        got = pf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert got.shape == want.shape
        # degenerate pairs reach 2e8 (a zero union clipped at 1e-8)
        tol = IOU_TOL * np.maximum(1.0, np.abs(want))
        assert (np.abs(got - want) <= tol).all()
    corners = iou3d.box_to_corners(torch.from_numpy(a)).numpy()
    for k in range(len(a)):
        np.testing.assert_allclose(
            corners[k], np.asarray(jax_iou.box_to_corners(jnp.asarray(a[k]))),
            atol=1e-6)


def _ranked_iou_jax(boxes, scores):
    order = np.asarray(jnp.argsort(-jnp.asarray(scores)))
    ranked = jnp.asarray(boxes)[order]
    return order, np.array(jax_iou.boxes_iou_bev(ranked, ranked))


def _keep_from(order, alive):
    keep = np.zeros(len(order), bool)
    keep[order] = alive
    return keep


@pytest.mark.parametrize("n", [1, 63, 64, 65])
@pytest.mark.parametrize("thresh", [0.01, 0.5])
def test_nms_equals_jax(n, thresh):
    rng = np.random.default_rng(n)
    boxes = bev_boxes(n, n, spread=4.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[n // 2:n // 2 + 3] = scores[n // 2]  # tied scores
    for jf, pf, zero in ((jax_nms["rotated"], iou3d.nms_rotated, False),
                         (jax_nms["normal"], iou3d.nms_normal, True)):
        want = np.asarray(jf(jnp.asarray(boxes), jnp.asarray(scores),
                             thresh))
        b = boxes.copy()
        if zero:
            b[:, 4] = 0
        order, ious = _ranked_iou_jax(b, scores)
        assert np.array_equal(order, iou3d.rank_boxes(
            torch.from_numpy(scores)).numpy())
        alive = iou3d.nms_scan_plain(torch.from_numpy(ious), thresh)
        assert np.array_equal(_keep_from(order, alive.numpy()), want)
        # the port's own IoU: equal unless a ranked pair is near the
        # threshold (the tie rule)
        near = np.abs(ious - np.float32(thresh)) < TIE_MARGIN
        np.fill_diagonal(near, False)
        got = pf(torch.from_numpy(boxes), torch.from_numpy(scores),
                 thresh).numpy()
        assert got.dtype == bool and got.shape == (n,)
        if not near.any():
            assert np.array_equal(got, want)


def test_nms_suppresses_over_the_whole_row_c23():
    """ROADMAP C23: overlap(a, b) != overlap(b, a) in the last bits, so
    the ranked IoU matrix is asymmetric. With the threshold between
    iou[0, 1] and iou[1, 0], box 0 keeps box 1 and box 1 then drops box 0:
    JAX suppresses over a kept box's whole row, and so does the port; a
    j > i-only bitmask (the reference's) would keep both."""
    for seed in range(200):
        boxes = bev_boxes(2, seed, spread=1.0)
        scores = np.array([0.9, 0.1], np.float32)
        _, ious = _ranked_iou_jax(boxes, scores)
        if 0 < ious[0, 1] < ious[1, 0]:
            break
    else:
        pytest.fail("no asymmetric pair in 200 draws")
    thresh = float(ious[0, 1])
    want = np.asarray(jax_iou.nms_rotated(jnp.asarray(boxes),
                                          jnp.asarray(scores), thresh))
    assert want.tolist() == [False, True]
    alive = iou3d.nms_scan_plain(torch.from_numpy(ious), thresh).numpy()
    assert alive.tolist() == [False, True]
    upper = np.triu(ious > np.float32(thresh), 1)  # j > i only
    keep_upper = np.ones(2, bool)
    for i in range(2):
        if keep_upper[i]:
            keep_upper &= ~upper[i]
    assert keep_upper.tolist() == [True, True]


def test_overflow_boxes_reach_the_16_slot_path():
    """The kernels clip a pair in 8 register slots and give one whose clip
    passes 8 vertices to JAX's 16-slot routine. edge_boxes has no such
    pair; overflow_boxes (which chip_smoke.py's edge cases and the card's
    tests add) has hundreds, by the plain clip. None passes 16: no box
    pair found in a search of ~27 M near-degenerate pairs did."""
    e = torch.from_numpy(edge_boxes())
    assert int(max_clip_counts(e, e).max()) <= 8
    b = torch.from_numpy(overflow_boxes())
    counts = max_clip_counts(b, b)
    assert int((counts > 8).sum()) >= 100
    assert int(counts.max()) <= 16


@pytest.mark.parametrize("which", ["random", "edges", "overflow"])
def test_screen_stages_settle_pairs_as_the_plain_clip(which):
    """screen_stages (the kernels' screens in PyTorch, which chip_smoke.py
    counts on the card) against the plain overlap: a pair a screen finds
    empty has overlap 0, one with A inside B has A's area as the clip
    sums it, and past 8 vertices is where the plain clip passes 8."""
    if which == "random":
        b = torch.from_numpy(bev_boxes(60, 5, spread=4.0))
    else:
        b = torch.from_numpy(edge_boxes() if which == "edges"
                             else overflow_boxes())
    stages = screen_stages(b, b).long()
    over = iou3d.boxes_overlap_bev_plain(b, b)
    empty = (stages == STAGES.index("empty")) | (
        stages == STAGES.index("second_screen"))
    assert (over[empty] == 0).all()
    inside = stages == STAGES.index("inside")
    assert inside.any()
    own = iou3d.boxes_overlap_bev_plain(b, b).diagonal()
    rows = inside.nonzero()[:, 0]
    assert torch.equal(over[inside], own[rows])
    assert torch.equal(stages == STAGES.index("past_8"),
                       max_clip_counts(b, b) > 8)


def _scan_blocks(over):
    """csrc/iou3d.cu's nms_scan_kernel in numpy: over (n, n) bool, the
    diagonal clear, as 64-bit row words; the 64-row blocks in rank order,
    each block's members of S resolved from its still-alive word and its
    diagonal words, then their whole rows ORed into `removed`; kept is
    ~removed. Returns the alive mask (n,) in rank order."""
    n = over.shape[0]
    words = -(-n // 64)
    padded = np.zeros((n, 64 * words), bool)
    padded[:, :n] = over
    rows = [[int.from_bytes(np.packbits(padded[i, 64 * w:64 * w + 64],
                                        bitorder="little").tobytes(),
                            "little") for w in range(words)]
            for i in range(n)]
    removed = [0] * words
    for b in range(words):
        left = n - 64 * b
        alive = ~removed[b] & ((1 << min(left, 64)) - 1)
        members = []
        while alive:
            r = (alive & -alive).bit_length() - 1
            members.append(64 * b + r)
            alive &= alive - 1
            alive &= ~rows[64 * b + r][b]
        for k in members:
            removed = [x | y for x, y in zip(removed, rows[k])]
    return np.array([not (removed[i >> 6] >> (i & 63)) & 1
                     for i in range(n)])


def _scan_plain(over):
    m = torch.from_numpy(over.astype(np.float32))
    return iou3d.nms_scan_plain(m, 0.5).numpy()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 200])
def test_nms_scan_block_form_equals_the_plain_scan(n):
    rng = np.random.default_rng(n)
    for density in (0.005, 0.05, 0.3):
        over = rng.random((n, n)) < density  # asymmetric
        np.fill_diagonal(over, False)
        assert np.array_equal(_scan_blocks(over), _scan_plain(over))


def test_nms_scan_block_form_across_block_boundaries():
    n = 200
    cases = []
    # a chain over a block boundary: 63 drops 64, so 65 survives 64's row
    over = np.zeros((n, n), bool)
    over[63, 64] = over[64, 65] = True
    cases.append((over, {64}))
    # over two boundaries: 0 drops 64, so 128 survives 64's row
    over = np.zeros((n, n), bool)
    over[0, 64] = over[64, 128] = True
    cases.append((over, {64}))
    # C23 within a block and across one: a later member drops an earlier
    over = np.zeros((n, n), bool)
    over[1, 0] = over[64, 63] = over[199, 5] = True
    cases.append((over, {0, 63, 5}))
    for over, gone in cases:
        want = np.ones(n, bool)
        want[list(gone)] = False
        assert np.array_equal(_scan_plain(over), want)
        assert np.array_equal(_scan_blocks(over), want)


def _pillar_setup(rng, b=2, n=300):
    kw = dict(voxel_size=(0.5, 0.5, 4.0),
              point_cloud_range=(0.0, -2.0, -3.0, 4.0, 2.0, 1.0),
              max_num_points=8, max_voxels=64, out_channel=16)
    pts = rng.uniform([-0.5, -2.5, -3.5, 0], [4.5, 2.5, 1.5, 1],
                      (b, n, 4)).astype(np.float32)
    pts[1, :60, :3] = [1.1, 0.3, 0.0]  # a pillar past the slot cap
    params = {
        "Dense_0": {"kernel": jnp.asarray(
            rng.normal(size=(9, 16)).astype(np.float32))},
        "BatchNorm_0": {
            "scale": jnp.asarray(rng.uniform(0.5, 1.5, 16).astype(
                np.float32)),
            "bias": jnp.asarray(rng.normal(size=16).astype(np.float32)
                                * 0.1)}}
    stats = {"BatchNorm_0": {
        "mean": jnp.asarray(rng.normal(size=16).astype(np.float32)),
        "var": jnp.asarray(rng.uniform(0.5, 2, 16).astype(np.float32))}}
    model = PillarEncoder(**kw, device="cpu")
    model.load_state_dict(pillar_encoder_to_torch_state_dict(params, stats),
                          strict=True)
    return JaxPillarEncoder(**kw), model, pts, params, stats


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got) - want).max()) <= tol * scale


def test_pillar_encoder_eval_equals_jax():
    rng = np.random.default_rng(1)
    jm, model, pts, params, stats = _pillar_setup(rng)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                             jnp.asarray(pts))
    got = model.eval()(torch.from_numpy(pts))
    assert tuple(got.shape) == want.shape == (2, 8, 8, 16)
    assert _close(got.detach().numpy(), want, CANVAS_TOL)
    assert (np.asarray(want) != 0).any()


def test_pillar_encoder_training_step_equals_jax():
    rng = np.random.default_rng(2)
    jm, model, pts, params, stats = _pillar_setup(rng)
    g = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)

    def loss(p, x):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd)

    (_, (out, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    got = model.train()(x)
    (got * torch.from_numpy(g)).sum().backward()
    assert _close(got.detach().numpy(), out, CANVAS_TOL)
    new = upd["batch_stats"]["BatchNorm_0"]
    assert _close(model.bn.running_mean.numpy(), new["mean"], GRAD_TOL)
    assert _close(model.bn.running_var.numpy(), new["var"], GRAD_TOL)
    assert _close(model.conv.weight.grad.numpy()[..., 0],
                  np.asarray(gp["Dense_0"]["kernel"]).T, GRAD_TOL)
    assert _close(model.bn.weight.grad.numpy(),
                  gp["BatchNorm_0"]["scale"], GRAD_TOL)
    assert _close(model.bn.bias.grad.numpy(), gp["BatchNorm_0"]["bias"],
                  GRAD_TOL)
    assert _close(x.grad.numpy(), gx, GRAD_TOL)


def test_training_batchnorm_counts_empty_voxels_c24():
    """ROADMAP C24: in training the BatchNorm statistics are over every
    (B, max_voxels, max_points) row, empty voxels and slots (whose
    features are zeroed, so their conv output is 0) included, as JAX
    computes them; the reference pools only the non-empty pillars."""
    rng = np.random.default_rng(24)
    _, model, pts, _, _ = _pillar_setup(rng)
    seen = {}
    model.bn.register_forward_hook(
        lambda m, inp, out: seen.setdefault("x", inp[0].detach()))
    before = model.bn.running_mean.clone()
    model.train()(torch.from_numpy(pts))
    x = seen["x"]
    assert tuple(x.shape) == (2, 64, 8, 16)
    rows = x.reshape(-1, 16)
    empty = (rows == 0).all(1)
    assert 0 < int(empty.sum()) < len(rows)
    mean_all = rows.mean(0)
    mean_filled = rows[~empty].mean(0)
    want = before + 0.01 * (mean_all - before)
    assert torch.allclose(model.bn.running_mean, want, rtol=0, atol=1e-6)
    assert not torch.allclose(mean_all, mean_filled, rtol=0, atol=1e-3)


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    _kernels.reset_launches()
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(0, 2, (2, 50, 4)).astype(np.float32))
    voxelize.hard_voxelize(pts, *SMALL, 4, 8)
    voxelize.dynamic_voxelize(pts, *SMALL)
    b = torch.from_numpy(bev_boxes(5, 0))
    iou3d.boxes_iou_bev(b, b)
    iou3d.nms_rotated(b, torch.rand(5), 0.1)
    assert _kernels.launches == dict.fromkeys(_kernels.KERNELS, 0)
    meta = torch.empty(2, 50, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        voxelize.dynamic_voxelize(meta, *SMALL)
    with pytest.raises(ValueError, match="unsupported device"):
        iou3d.boxes_iou_bev(meta[0, :, :5], meta[0, :, :5])
