"""``hard_voxelize`` of vlp3d_torch at grids of any size, against JAX's.

The card's hard voxelization keeps its cells in a hash table sized by the
points (``csrc/voxelize.cu``), and the plain path finds each cell's first
point by a stable sort of the keys, as JAX does, so both take any grid of
JAX's int32 cell keys: up to ``MAX_GRID_CELLS`` = 2^31 - 2 cells, past
which JAX's sentinel key ``cells + 1`` overflows and the port raises
(ROADMAP C28). Held here on the CPU, bit for bit against
``vlp3d.ops.voxelize.hard_voxelize`` on a few thousand seeded clustered
points a row (clusters a voxel or two wide, a uniform share, a share
outside the range): PointPillars' KITTI grid (214 272 cells), SECOND's
(90 112 000), a grid just past 2^24 cells and one 32 768 cells short of
2^31, each with the voxel cap slack and biting. The wrapper's admission
and workspace rule run as plain functions and, with the launch mocked,
through the card path's own wrapper: the same table and workspace for
every grid (addressed by the key where the grid has no more cells than
the table slots, else hashed), a grid past C28 refused before anything
is allocated.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp3d.ops import voxelize as jax_vox
from vlp3d_torch.ops import voxelize

jax_hard = jax.jit(jax_vox.hard_voxelize, static_argnums=(1, 2, 3, 4))

# name: (voxel_size, coors_range, cells)
GRIDS = {
    # OpenPCDet kitti_models/pointpillar.yaml
    "pointpillars": ((0.16, 0.16, 4.0),
                     (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), 432 * 496),
    # OpenPCDet kitti_models/second.yaml
    "second": ((0.05, 0.05, 0.1), (0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
               1408 * 1600 * 40),
    "past_2_24": ((0.5, 0.5, 0.5), (0.0, 0.0, 0.0, 128.0, 128.0, 128.5),
                  256 * 256 * 257),
    "int32_edge": ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0, 65535.0, 32768.0, 1.0),
                   65535 * 32768),
}
# (max_points, max_voxels): SECOND's training cap, and one that bites
CAPS = [(5, 16000), (3, 200)]


def _clouds(seed: int, vs, cr, rows: int = 2, n: int = 3000):
    """(rows, n, 4) float32: 55% in 24 clusters about one and a half
    voxels wide, 35% uniform over the range, 10% up to a tenth of the
    range past its high corner; reflectance in the fourth channel."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(cr[:3]), np.asarray(cr[3:])
    vs = np.asarray(vs)
    out = []
    for _ in range(rows):
        k, m = 24, n * 55 // 100
        centres = rng.uniform(lo, hi, (k, 3))
        clustered = (centres[rng.integers(0, k, m)]
                     + rng.uniform(-0.75, 0.75, (m, 3)) * vs)
        u = n * 35 // 100
        uniform = rng.uniform(lo, hi, (u, 3))
        outside = hi + rng.uniform(0, 0.1, (n - m - u, 3)) * (hi - lo)
        xyz = np.concatenate([clustered, uniform, outside])
        xyz = xyz[rng.permutation(n)]
        out.append(np.concatenate([xyz, rng.uniform(0, 1, (n, 1))], 1))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("caps", CAPS, ids=["slack", "voxel_cap"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_hard_voxelize_equals_jax_at_any_grid(name, caps):
    vs, cr, cells = GRIDS[name]
    p, v = caps
    pts = _clouds(list(GRIDS).index(name), vs, cr)
    _, grid = voxelize.dynamic_voxelize(torch.from_numpy(pts[0]), vs, cr)
    assert int(grid.prod()) == cells
    got = voxelize.hard_voxelize(torch.from_numpy(pts), vs, cr, p, v)
    for b in range(pts.shape[0]):
        want = jax_hard(jnp.asarray(pts[b]), vs, cr, p, v)
        assert set(got) == set(want)
        for k, w in want.items():
            w, g = np.asarray(w), got[k][b].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, k
            assert np.array_equal(g, w), (b, k)
        n_vox = int(want["voxel_num"])
        # the clusters fill cells past one slot, and the cap bites
        assert 0 < n_vox <= v
        assert int(want["num_points_per_voxel"].max()) == p
        if v == 200:
            assert n_vox == v


def test_grid_admission_c28():
    """A grid of up to 2^31 - 2 cells is taken, a larger one raises on
    both paths (JAX's sentinel key cells + 1 would overflow int32)."""
    assert voxelize.MAX_GRID_CELLS == 2 ** 31 - 2
    assert voxelize.grid_cells((1408, 1600, 40)) == 90_112_000
    assert voxelize.grid_cells((2, 3, 357913941)) == 2 ** 31 - 2
    for grid in ((1, 1, 2 ** 31 - 1), (65536, 32768, 1), (1408, 1600, 1000)):
        with pytest.raises(ValueError, match="C28"):
            voxelize.grid_cells(grid)
    with pytest.raises(ValueError, match="C28"):
        voxelize.hard_voxelize(torch.zeros(1, 4, 4), (1.0, 1.0, 1.0),
                               (0.0, 0.0, 0.0, 65536.0, 32768.0, 1.0), 5, 10)


def test_cell_table_grows_with_the_points():
    """The table: a power of two of at least 2 n slots and at least 64, at
    most 2^31; phase 17's 120 000-point rows take 262 144 (12.6 MB for 4
    rows with tag, head and count)."""
    assert voxelize.table_slots(120000) == 262144
    assert 4 * 262144 * 3 * 4 == 12_582_912
    assert voxelize.table_slots(0) == voxelize.table_slots(32) == 64
    assert voxelize.table_slots(33) == 128
    assert voxelize.table_slots(2 ** 30) == voxelize.table_slots(
        2 ** 31 - 1) == 2 ** 31
    for n in (1, 1000, 65536, 131073, 2 ** 29 + 1):
        s = voxelize.table_slots(n)
        assert s & (s - 1) == 0 and 2 * n <= s < max(128, 4 * n)
    # past 2^30 points the cap: fewer than 2 n slots, still more than n
    for n in (2 ** 30 + 1, 2 ** 31 - 1):
        assert n < voxelize.table_slots(n) == 2 ** 31 < 2 * n
    tiles = -(-120000 // voxelize.VOXEL_TILE)
    assert voxelize.hard_workspace_ints(4, 120000, 16000) == (
        2 * 4 * 120000 + 2 * 4 * tiles + 2 + 3 * 4 * 262144 + 3
        + 4 * 4 * 16000)


def test_card_wrapper_takes_a_row_past_2_30_points(monkeypatch):
    """A row of 2^30 + 1 points (meta tensors, the launch mocked): the
    wrapper admits it and hands the kernel the capped table of 2^31
    slots, more than the row's points, as the kernel requires."""
    calls = []
    k = voxelize._kernels
    n = 2 ** 30 + 1
    meta = torch.device("meta")
    monkeypatch.setattr(k, "require", lambda *a, **kw: None)
    monkeypatch.setattr(k, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(k, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(voxelize, "_dynamic_cuda", lambda p, vs, cr: (
        torch.empty((1, n, 3), dtype=torch.int32, device=meta), None))
    monkeypatch.setattr(k, "function", lambda src, name: (
        lambda *args: calls.append(args) or 0))
    pts = torch.empty((1, n, 4), device=meta)
    vs, cr, _ = GRIDS["second"]
    voxelize._hard_cuda(pts, vs, cr, 5, 16000)
    ((args,),) = [calls]
    # SECOND's 90 112 000 cells then fit the table: addressed by the key
    assert args[3] == n and args[8] == 2 ** 31 and args[9] is True


def test_card_wrapper_sizes_its_workspace_by_the_points(monkeypatch):
    """The card path's wrapper, its launch mocked: the same cell table and
    workspace at every grid (the grid only reaches the kernel as gx, gy
    for the keys), and a grid past C28 refused before any allocation or
    launch."""
    calls = []
    k = voxelize._kernels
    monkeypatch.setattr(k, "require", lambda *a, **kw: None)
    monkeypatch.setattr(k, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(k, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(voxelize, "_dynamic_cuda",
                        voxelize.dynamic_voxelize_plain)
    monkeypatch.setattr(k, "function", lambda src, name: (
        lambda *args: calls.append((name, args)) or 0))
    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        allocated.append(shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(voxelize.torch, "empty", recording_empty)
    pts = torch.from_numpy(_clouds(5, *GRIDS["second"][:2], rows=3, n=700))
    seen, direct = set(), {}
    small = ((0.5, 0.5, 0.5), (0.0, 0.0, 0.0, 2.0, 2.0, 2.0), 64)
    for name, (vs, cr, _) in dict(GRIDS, small=small).items():
        calls.clear()
        allocated.clear()
        voxelize._hard_cuda(pts, vs, cr, 5, 16000)
        ((fn, args),) = calls
        assert fn == "vlp3d_hard_voxelize"
        work = [s[0] for s in allocated if isinstance(s[0], int)]
        seen.add((args[8], tuple(work)))
        direct[name] = bool(args[9])
    assert seen == {(voxelize.table_slots(700),
                     (voxelize.hard_workspace_ints(3, 700, 16000),))}
    # the table addressed by the key where the grid fits it, else hashed
    assert direct == dict.fromkeys(GRIDS, False) | {"small": True}
    calls.clear()
    allocated.clear()
    with pytest.raises(ValueError, match="C28"):
        voxelize._hard_cuda(pts, (1.0, 1.0, 1.0),
                            (0.0, 0.0, 0.0, 65536.0, 32768.0, 1.0), 5, 16000)
    assert not calls and not allocated
