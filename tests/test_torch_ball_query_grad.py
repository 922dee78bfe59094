"""The plans and rules behind the ball-query tile kernel and the sorted
scatter-add backward, on the CPU.

On the card the ball query's tile kernel splits a row's points into
segments, one a block of a thread-block cluster, and merges the blocks'
first hits by a rule (``csrc/ball_query.cu``): segment s writes its hits
at slots [offset, offset + count) below nsample, offset being the summed
counts of the segments before it; the lowest segment with a hit writes
the padding with its first hit, segment 0 the zeros of an empty ball; the
count is the sum. That rule is checked here with ``ball_query_plain`` run
on each segment against ``ball_query_plain`` on the whole row, and the
plain version against ``vlp3d.ops.ball_query.ball_query_with_count`` on the same
edge cases (indices and counts equal). The plan functions are checked
against the kernels' limits: shared memory at most 232448 bytes a block,
at most 1024 threads, clusters of at most 16 blocks. The backward's
plain version (``index_add_``) is checked against ``jax.grad`` of the JAX
gather on the skewed index tables the sorted kernel must survive, within
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bq_cases import (
    BQ_CASES,
    GRAD_CASES,
    GRAD_SITES,
    ball_query_case,
    grad_case,
)
from vlp3d import ops as jops
from vlp3d.ops.ball_query import ball_query_with_count as jax_ball_query
from vlp3d_torch.ops.ball_query import (
    MAX_SMEM,
    TILE_PLANS,
    _ball_query_plan,
    ball_query_plain,
    plan_smem_bytes,
    tile_plans,
)
from vlp3d_torch.ops.grouping import (
    SORTED_MAX_N,
    _grad_plan,
    group_points_grad_plain,
    sorted_smem_bytes,
)

GRAD_TOL = dict(rtol=1e-6, atol=1e-6)
# (n, nsample): the main-path ball queries at B=8 (the proposal site is
# SA3's shape), then others
BQ_SHAPES = [(40960, 64), (2048, 32), (1024, 16), (512, 16), (4096, 16),
             (8193, 64), (262144, 64), (40960, 4096), (33, 32)]


def _merge(parts, nsample):
    """The tile kernel's merge of per-segment (first index, idx, count)
    results, in numpy: (idx (B, M, nsample), count (B, M))."""
    counts = np.stack([cnt for _, _, cnt in parts])  # (S, B, M)
    total = counts.sum(0)
    offsets = np.cumsum(counts, 0) - counts
    has = counts > 0
    first = np.where(has.any(0), has.argmax(0), 0)  # the padding block
    b, m = total.shape
    out = np.full((b, m, nsample), -1, dtype=np.int64)
    for s, (lo, idx, cnt) in enumerate(parts):
        for j in range(nsample):
            mine = (j >= offsets[s]) & (j - offsets[s] < cnt)
            src = np.clip(j - offsets[s], 0, nsample - 1)
            got = np.take_along_axis(idx, src[..., None], 2)[..., 0] + lo
            out[..., j] = np.where(mine, got, out[..., j])
            pads = (first == s) & (j >= np.minimum(total, nsample))
            pad = np.where(total > 0, idx[..., 0] + lo, 0)
            out[..., j] = np.where(pads, pad, out[..., j])
    assert (out >= 0).all(), "a slot no segment wrote"
    return out, total


@pytest.mark.parametrize("segs", [2, 3, 8, 16])
@pytest.mark.parametrize("name", BQ_CASES)
def test_segment_merge_rule_gives_the_whole_row(name, segs):
    xyz, centers, radius, nsample = ball_query_case(name)
    xyz, centers = torch.from_numpy(xyz), torch.from_numpy(centers)
    n = xyz.shape[1]
    seg = -(-n // segs)
    parts = []
    for s in range(segs):
        lo, hi = min(n, s * seg), min(n, (s + 1) * seg)
        if hi > lo:
            idx, cnt = ball_query_plain(radius, nsample, xyz[:, lo:hi],
                                        centers)
        else:  # an empty segment: no hit, its list never read
            idx = torch.zeros(centers.shape[:2] + (nsample,),
                              dtype=torch.int32)
            cnt = torch.zeros(centers.shape[:2], dtype=torch.int32)
        parts.append((lo, idx.numpy(), cnt.numpy()))
    got_idx, got_cnt = _merge(parts, nsample)
    want_idx, want_cnt = ball_query_plain(radius, nsample, xyz, centers)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_cnt, want_cnt.numpy())


@pytest.mark.parametrize("name", BQ_CASES)
def test_ball_query_plain_matches_jax_on_the_edge_cases(name):
    xyz, centers, radius, nsample = ball_query_case(name)
    want_idx, want_cnt = jax_ball_query(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(centers))
    got_idx, got_cnt = ball_query_plain(radius, nsample,
                                        torch.from_numpy(xyz),
                                        torch.from_numpy(centers))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    if name == "exact_radius":  # d^2 == r^2 is out, one ulp inside is in
        assert got_cnt[0, 0] == 3 and (got_cnt[1, 5:] == 0).all()


@pytest.mark.parametrize("n,nsample", BQ_SHAPES)
def test_ball_query_plan_fits_the_kernel(n, nsample):
    plan = _ball_query_plan(n, nsample)
    if plan is None:  # the warp-a-centre kernel takes any shape
        return
    threads, segs, tile = plan
    assert plan in TILE_PLANS
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert 1 <= segs <= 16 and tile % 4 == 0
    assert plan_smem_bytes(plan, n, nsample) <= MAX_SMEM


@pytest.mark.parametrize("n,nsample", [(40960, 64), (2048, 32), (1024, 16),
                                       (512, 16), (33, 32), (4096, 1024)])
def test_swept_tile_plans_fit_the_kernel(n, nsample):
    plans = list(tile_plans(n, nsample))
    for plan in plans:
        threads, segs, tile = plan
        assert threads <= 1024 and segs <= 16
        assert plan_smem_bytes(plan, n, nsample) <= MAX_SMEM
        assert segs == 1 or -(-n // segs) >= 64
    # SA1's 64-slot lists of 2-byte entries fit every plan
    if (n, nsample) == (40960, 64):
        assert len(plans) == len(TILE_PLANS)
    if nsample == 1024:  # the largest blocks' hit lists do not fit
        assert 0 < len(plans) < len(TILE_PLANS)
    # a segment of more than 65536 points keeps 4-byte entries
    assert (plan_smem_bytes((64, 1, 512), 65537, 64)
            > plan_smem_bytes((64, 1, 512), 65536, 64))


@pytest.mark.parametrize("b,n,c,m,k", GRAD_SITES)
def test_grad_plan_takes_every_train_step_site(b, n, c, m, k):
    rows, slices, warps, cap = _grad_plan(b, n, c, m * k)
    assert 16 <= rows <= 128 and slices in (1, 2) and cap >= 1024
    assert 1 <= warps <= 32
    assert sorted_smem_bytes(warps, rows, cap) <= MAX_SMEM
    # about one block of 32 warps an SM of a 132-SM card
    assert b * -(-n // rows) * slices >= 128 or rows == 16


@pytest.mark.parametrize("n", [SORTED_MAX_N, SORTED_MAX_N + 1, 40960])
def test_grad_plan_hands_large_tables_to_the_atomic_kernel(n):
    plan = _grad_plan(8, n, 3, 131072)
    assert (plan is None) == (n > SORTED_MAX_N)


@pytest.mark.parametrize("name", [c for c in GRAD_CASES
                                  if c != "out_of_range"])
def test_grad_plain_matches_jax_on_skewed_tables(name):
    idx, grad, n = grad_case(name)
    b, r, c = grad.shape
    want = np.asarray(jax.grad(
        lambda p: jnp.sum(jops.gather_points(p, jnp.asarray(idx)) * grad)
    )(jnp.zeros((b, n, c), jnp.float32)))
    got = group_points_grad_plain(torch.from_numpy(grad),
                                  torch.from_numpy(idx), n)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    if name == "untouched_rows":
        assert not got[:, 1::2].any()
