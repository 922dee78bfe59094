"""The hand-written CUDA kernels against their plain PyTorch versions.

Card-only: every test is marked ``gpu`` and skips on a host without a
CUDA device. The file imports no JAX, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Shapes
run from small to the main path's (B=8, N=40960), and the FPS kernels
also run where a row split over blocks is likely to go wrong (ties across
blocks, blocks with no valid point, ragged lengths, any batch size).
The point-axis FPS loop runs at one rank against its plain loop and the
dense FPS, and at 2 and 4 ranks emulated in one launch against the dense
FPS, ties across shards and an all-invalid row included, and on slabs too
long for registers (its streamed form) at 1 and 2 ranks; a launch whose
peer never writes must trap in a process of its own
(``tests/torch_stall_probe.py``). The collective route's step kernel
runs forced at one rank against the plain loop, the dense FPS and the
peer route, and at 2, 4 and 33 ranks emulated in turn. The ball-query
merge runs at 1, 4, 33 and 64 shards against its plain version and the
dense ball query. Every kernel that once put the batch on the grid's y
runs at 65537 rows (``tests/torch_batch_rows.py``).
The PointPillars kernels: dynamic and hard voxelization equal to their
plain versions bit for bit and between two launches (the voxel and slot
caps, 35 and 100 slots, a 20000-point pillar, a row's 120000 points in
one cell, most points outside, C = 3, 4 and 5, the encoder's B=4 x
120000; SECOND's 90 112 000-cell grid at 16000 and 40000 voxels), the
points' gradient equal to the CPU's; the rotated BEV IoU and overlap within
1e-6 of the plain version (relative above 1), NMS keep masks equal to
the plain scan over the kernel's own ranked IoU (N = 1, 63, 64, 65,
1000, degenerate boxes, tied scores).
Ball query runs its tile kernel under every plan the smoke run sweeps,
on inputs built against the plans' segment boundaries
(``tests/torch_bq_cases.py``); three-NN runs its team kernel, alone and
fused with the interpolation, under every plan on the cases of
``tests/torch_three_nn_cases.py`` and at the FP shapes. Indices must be
equal; three-NN distances and interpolation weights within 1e-6 and
interpolated features within 1e-5; the row gather exact and the
scatter-add backwards (the gather's two, the interpolation's weighted
one) within ``GRAD_RTOL`` (1e-5) of the absolute sum meeting in a row,
the sorted one and the interpolation's also equal bit for bit from
launch to launch, the interpolation's also to its ordered sum
(``interp_grad_ordered``) under every plan; the tiny
JointNet's cluster_ref within 1e-4 of the CPU forward; and one Solver
epoch on the card, with and without remat, launching each kernel the
stated number of times a step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vlp3d_torch import ops
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.ops import _kernels
from torch_bq_cases import (
    BQ_CASES,
    GRAD_CASES,
    GRAD_SITES,
    ball_query_case,
    grad_case,
)
from torch_three_nn_cases import NN_CASES, interp_grad_ordered, nn_case
from vlp3d_torch.ops.ball_query import (
    _ball_query_cuda,
    _ball_query_plan,
    ball_query_plain,
    tile_plans,
)
from vlp3d_torch.ops.grouping import (
    GRAD_RTOL,
    SORTED_MAX_N,
    _grad_plan,
    _group_points_grad_cuda,
    group_points_grad_plain,
    group_points_plain,
)
from vlp3d_torch.ops.interpolate import (
    INTERP_GRAD_PLANS,
    TEAM_PLANS,
    _interpolate_cuda,
    _three_interpolate_grad_cuda,
    _three_nn_cuda,
    interpolate_features_plain,
    interpolation_weights,
    three_interpolate_grad_plain,
    three_nn_plain,
)
from vlp3d_torch.ops.sampling import _fps_cuda, _fps_plan, fps_plain
from vlp3d_torch.parallel import point_parallel as pp
from vlp3d_torch.serving import STREAM_KEYS
from torch_pillar_cases import (bev_boxes, edge_boxes, max_clip_counts,
                                overflow_boxes)
from torch_batch_rows import check_batch_rows
from torch_point_cases import fps_cases, merge_cases, wide_merge_cases

TOL = dict(rtol=1e-4, atol=1e-4)
# the point-axis and PointPillars kernels, which no single-card JointNet
# path below launches
NO_POINT_AXIS = {"fps_shard_loop": 0, "fps_shard_step": 0,
                 "ball_query_merge": 0,
                 "gather_owned": 0, "dynamic_voxelize": 0, "hard_voxelize": 0,
                 "boxes_iou_bev": 0, "nms_bev": 0}
FLAGS = dict(use_con=False, no_caption=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (b, n, npoint) — small, the five main-path FPS calls at B=8 (one cluster
# a row at N=40960, one block a row below), a longer cluster row, and a
# row too long for a cluster (one block, running distances in global
# scratch)
FPS_SHAPES = [(2, 300, 40), (8, 40960, 2048), (8, 2048, 1024),
              (8, 1024, 512), (8, 512, 256), (8, 1024, 256),
              (2, 1 << 16, 64), (2, 1 << 18, 32)]
# (b, n, m, radius, nsample) — small, SA1, SA2, SA3, SA4, proposal
BQ_SHAPES = [(2, 300, 50, 0.3, 8), (8, 40960, 2048, 0.2, 64),
             (8, 2048, 1024, 0.4, 32), (8, 1024, 512, 0.8, 16),
             (8, 512, 256, 1.2, 16), (8, 1024, 256, 0.3, 16)]
# (b, n, m) — small, FP1, FP2
NN_SHAPES = [(2, 70, 25), (8, 512, 256), (8, 1024, 512)]


def _scene(b, n, seed, device):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 6, size=(b, n, 3)).astype(np.float32)
    xyz[:, -max(1, n // 50):] = 0.0  # zero padding
    xyz[0] = 0.0  # an all-padding row
    return t(xyz).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,npoint", FPS_SHAPES)
def test_fps_kernel_matches_plain(cuda, b, n, npoint):
    xyz = _scene(b, n, n, cuda)
    got = ops.furthest_point_sample(xyz, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_plain(xyz, npoint))


def _fps_trouble(name, device):
    """(xyz, npoint) of one place where a row split over blocks and
    threads is likely to go wrong."""
    rng = np.random.default_rng(len(name))
    n = 2048 if name.endswith("_short") else 40960
    xyz = rng.uniform(0, 6, size=(4, n, 3)).astype(np.float32)
    npoint = 96
    kind = name.removesuffix("_short")
    if kind == "duplicated_halves":  # ties across blocks
        xyz[:, n // 2:] = xyz[:, :n // 2]
    elif kind == "few_distinct_points":
        xyz = np.tile(xyz[:, :7], (1, n // 7 + 1, 1))[:, :n]
    elif kind == "zero_tail":  # whole blocks without a valid point
        xyz[:, n // 8:] = 0.0
        xyz[1] = 0.0  # no valid point: picks 0 throughout
        xyz[2] = 0.0
        xyz[2, n - 3] = 1.5  # one valid point, in the last block
    elif kind == "ragged":  # no blocks x threads x points grid divides it
        xyz = xyz[:, :n - 960] if n > 4096 else xyz[:, :1000]
    elif kind == "n33":
        xyz, npoint = xyz[:, :33], 20
    elif kind == "npoint_1":
        npoint = 1
    elif kind == "npoint_above_valid":
        xyz = xyz[:, :33]
        xyz[:, 10:] = 0.0
        npoint = 20
    else:
        raise KeyError(name)
    return t(xyz).to(device), npoint


FPS_TROUBLE = ["duplicated_halves", "duplicated_halves_short",
               "few_distinct_points", "few_distinct_points_short",
               "zero_tail", "zero_tail_short", "ragged", "ragged_short",
               "n33", "npoint_1", "npoint_1_short", "npoint_above_valid"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", FPS_TROUBLE)
def test_fps_kernels_match_plain_where_trouble_is_likely(cuda, name):
    xyz, npoint = _fps_trouble(name, cuda)
    want = fps_plain(xyz, npoint)
    n = xyz.shape[1]
    # the wrapper's own choice, then other shapes of the same kernel: one
    # block, clusters of 4, 8 and 16 blocks, and the one-block kernel with
    # its distances in shared memory and in a global scratch
    plans = [None, "shared", "global"]
    for blocks in (1, 4, 8, 16):
        for points in (2, 8, 32):
            share = -(-n // blocks)
            threads = 32 * -(-share // (32 * points))
            if threads <= {2: 1024, 8: 512, 32: 256}[points]:
                plans.append((blocks, points))
    for plan in plans:
        got = (ops.furthest_point_sample(xyz, npoint) if plan is None
               else _fps_cuda(xyz, npoint, plan))
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 9, 16])
def test_fps_cluster_kernel_any_batch_size(cuda, b):
    # more clusters than the card runs at once simply queue
    xyz = _scene(b, 40960, b, cuda)
    assert _fps_plan(40960)[0] > 1
    got = ops.furthest_point_sample(xyz, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_plain(xyz, 64))


@pytest.mark.gpu
def test_fps_refused_launch_raises_and_leaves_no_error(cuda):
    xyz = _scene(2, 40960, 1, cuda)
    # 32 blocks a cluster, 3 points a thread, 20480 threads a block
    for plan in ((32, 8), (1, 3), (1, 2)):
        with pytest.raises(RuntimeError, match="fps kernel"):
            _fps_cuda(xyz, 8, plan)
    with pytest.raises(RuntimeError, match="fps kernel"):
        _fps_cuda(_scene(1, 1 << 18, 2, cuda), 8, "shared")
    got = ops.furthest_point_sample(xyz, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_plain(xyz, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,radius,nsample", BQ_SHAPES)
def test_ball_query_kernel_matches_plain(cuda, b, n, m, radius, nsample):
    xyz = _scene(b, n, n, cuda)
    centers = xyz[:, :m].clone()
    centers[:, :3] = 50.0  # empty balls
    idx, cnt = ops.ball_query_with_count(radius, nsample, xyz, centers)
    early = ops.ball_query(radius, nsample, xyz, centers)
    torch.cuda.synchronize()
    pidx, pcnt = ball_query_plain(radius, nsample, xyz, centers)
    assert torch.equal(idx, pidx) and torch.equal(cnt, pcnt)
    assert torch.equal(early, pidx)


def _bq_all_plans(radius, nsample, xyz, centers):
    """Both kernels under every plan, with and without counts, against
    the plain version."""
    want_idx, want_cnt = ball_query_plain(radius, nsample, xyz, centers)
    plans = ["warp", *tile_plans(xyz.shape[1], nsample)]
    for plan in plans:
        idx, _ = _ball_query_cuda(radius, nsample, xyz, centers, False, plan)
        idx_c, cnt = _ball_query_cuda(radius, nsample, xyz, centers, True,
                                      plan)
        torch.cuda.synchronize()
        assert torch.equal(idx, want_idx), plan
        assert torch.equal(idx_c, want_idx) and torch.equal(cnt, want_cnt), plan
    return want_idx, want_cnt


@pytest.mark.gpu
@pytest.mark.parametrize("name", BQ_CASES)
def test_ball_query_every_plan_where_trouble_is_likely(cuda, name):
    xyz, centers, radius, nsample = ball_query_case(name)
    _bq_all_plans(radius, nsample, t(xyz).to(cuda), t(centers).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 9])
def test_ball_query_tile_kernel_any_batch_size(cuda, b):
    # the SA1 shape (the wrapper's tile plan) with fewer and more rows
    xyz = _scene(b, 40960, 40 + b, cuda)
    centers = xyz[:, ::20][:, :2048].contiguous()
    assert _ball_query_plan(40960, 64) is not None
    ops.reset_launches()
    idx, cnt = ops.ball_query_with_count(0.2, 64, xyz, centers)
    torch.cuda.synchronize()
    assert ops.launches["ball_query"] == 1
    pidx, pcnt = ball_query_plain(0.2, 64, xyz, centers)
    assert torch.equal(idx, pidx) and torch.equal(cnt, pcnt)
    assert torch.equal(ops.ball_query(0.2, 64, xyz, centers), pidx)


@pytest.mark.gpu
def test_ball_query_every_plan_at_the_sa1_shape(cuda):
    xyz = _scene(2, 40960, 3, cuda)
    _bq_all_plans(0.2, 64, xyz, xyz[:, ::40][:, :1000].contiguous())


@pytest.mark.gpu
def test_ball_query_long_segments_keep_4_byte_hit_lists(cuda):
    # one segment of 70000 points: hit offsets past 65535
    xyz = _scene(2, 70000, 7, cuda)
    centers = torch.cat([xyz[:, ::1000], xyz[:, -40:]], 1).contiguous()
    want = ball_query_plain(0.3, 32, xyz, centers)
    for plan in ((64, 1, 512), (128, 1, 256), (64, 2, 512)):
        idx, cnt = _ball_query_cuda(0.3, 32, xyz, centers, True, plan)
        torch.cuda.synchronize()
        assert torch.equal(idx, want[0]) and torch.equal(cnt, want[1]), plan
    assert int(want[0].max()) > 65535


@pytest.mark.gpu
def test_ball_query_refused_plan_raises_and_leaves_no_error(cuda):
    xyz = _scene(2, 4096, 5, cuda)
    centers = xyz[:, :64].contiguous()
    # shared memory past 227 KB, 2048 threads, 17 blocks a cluster, 33
    # threads, tile 6
    for plan, nsample in (((1024, 1, 512), 200), ((2048, 1, 512), 16),
                          ((64, 17, 512), 16), ((33, 1, 512), 16),
                          ((64, 1, 6), 16)):
        with pytest.raises(RuntimeError, match="ball query kernel"):
            _ball_query_cuda(0.3, nsample, xyz, centers, False, plan)
    idx = ops.ball_query(0.3, 16, xyz, centers)
    torch.cuda.synchronize()
    assert torch.equal(idx, ball_query_plain(0.3, 16, xyz, centers)[0])


def _grad_check(grad, idx, n, plan=None):
    """The backward under ``plan`` against index_add_ (rows out of range
    dropped), within GRAD_RTOL of the absolute sum meeting in a row."""
    keep = (idx >= 0) & (idx < n)
    safe = torch.where(keep, idx, torch.zeros_like(idx))
    g = grad * keep[..., None]
    want = group_points_grad_plain(g, safe, n)
    scale = group_points_grad_plain(g.abs(), safe, n)
    ops.reset_launches()
    got = _group_points_grad_cuda(grad, idx, n, plan)
    torch.cuda.synchronize()
    assert ops.launches["group_points_grad"] == 1
    err = (got - want).abs()
    assert bool((err <= GRAD_RTOL * scale + 1e-30).all()), err.max().item()
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,m,k", GRAD_SITES)
def test_sorted_grad_kernel_at_the_train_step_sites(cuda, b, n, c, m, k):
    points, idx = _group_inputs(b, n, c, m, k, cuda)
    idx = idx.reshape(b, m * k)
    grad = torch.randn(b, m * k, c, device=cuda)
    assert _grad_plan(b, n, c, m * k) is not None
    got = _grad_check(grad, idx, n)
    # the same bits from a second launch, and through autograd
    assert torch.equal(got, _group_points_grad_cuda(grad, idx, n))
    points.requires_grad_(True)
    ops.group_points(points, idx.reshape(b, m, k)).backward(
        grad.reshape(b, m, k, c))
    assert torch.equal(points.grad, got)


@pytest.mark.gpu
@pytest.mark.parametrize("name", GRAD_CASES)
def test_sorted_grad_kernel_where_trouble_is_likely(cuda, name):
    idx, grad, n = grad_case(name)
    idx, grad = t(idx).to(cuda), t(grad).to(cuda)
    # the wrapper's plan, others, and windows far shorter than a list
    for plan in (None, (16, 1, 8, 33), (128, 1, 32, 4096),
                 (1024, 2, 4, 1000), (7, 3, 1, 1)):
        got = _grad_check(grad, idx, n, plan)
        assert torch.equal(got, _grad_check(grad, idx, n, plan)), plan
        if name == "untouched_rows":
            assert not got[:, 1::2].any()
    _grad_check(grad, idx, n, "atomic")


@pytest.mark.gpu
def test_grad_plan_hands_over_to_the_atomic_kernel(cuda):
    for n in (SORTED_MAX_N, SORTED_MAX_N + 1):
        g = torch.Generator(device="cpu").manual_seed(n)
        idx = torch.randint(0, n, (2, 3000), generator=g,
                            dtype=torch.int32).to(cuda)
        grad = torch.randn(2, 3000, 8, generator=g).to(cuda)
        plan = _grad_plan(2, n, 8, 3000)
        assert (plan is None) == (n > SORTED_MAX_N)
        got = _grad_check(grad, idx, n)
        if plan is not None:
            assert torch.equal(got, _group_points_grad_cuda(grad, idx, n))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_three_nn_kernel_matches_plain(cuda, b, n, m):
    unknown = _scene(b, n, n, cuda)
    known = unknown[:, :m].clone()
    feats = torch.randn(b, m, 256, device=cuda)
    d, i = ops.three_nn(unknown, known)
    torch.cuda.synchronize()
    pd, pi = three_nn_plain(unknown, known)
    assert torch.equal(i, pi)
    assert torch.allclose(d, pd, rtol=0, atol=1e-6)
    got = ops.interpolate_features(unknown, known, feats)
    recip = 1.0 / (torch.sqrt(pd) + 1e-8)
    want = ops.three_interpolate(feats, pi,
                                 recip / recip.sum(-1, keepdim=True))
    assert torch.allclose(got, want, rtol=0, atol=1e-5)


def _nn_check(unknown, known, feats, plans):
    """three_nn alone and the fused interpolation under every plan against
    the plain versions: indices equal, dist2 within 1e-6, weights within
    1e-6, the output within 1e-5."""
    pd, pi = three_nn_plain(unknown, known)
    pw = interpolation_weights(pd)
    pout = interpolate_features_plain(unknown, known, feats)
    for plan in plans:
        d, i = _three_nn_cuda(unknown, known, plan)
        torch.cuda.synchronize()
        assert torch.equal(i, pi), plan
        assert torch.allclose(d, pd, rtol=0, atol=1e-6), plan
        if plan == "serial":
            continue
        out, i, w, d = _interpolate_cuda(unknown, known, feats, plan,
                                         with_dist2=True)
        torch.cuda.synchronize()
        assert torch.equal(i, pi), plan
        assert torch.allclose(d, pd, rtol=0, atol=1e-6), plan
        assert torch.allclose(w, pw, rtol=0, atol=1e-6), plan
        assert torch.allclose(out, pout, rtol=0, atol=1e-5), plan


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_team_kernel_every_plan_at_the_fp_shapes(cuda, b, n, m):
    unknown = _scene(b, n, n + 1, cuda)
    known = unknown[:, ::2][:, :m].contiguous()  # FP2: a subset, d^2 = 0
    feats = torch.randn(b, m, 256, device=cuda)
    _nn_check(unknown, known, feats, (None, "serial", *TEAM_PLANS))
    # a channel slice: rows not 16-byte aligned take the scalar path
    _nn_check(unknown, known, feats[..., 1:6].contiguous(), (None, (8, 32)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", NN_CASES)
def test_team_kernel_every_plan_where_trouble_is_likely(cuda, name):
    unknown, known, feats = (t(a).to(cuda) for a in nn_case(name))
    _nn_check(unknown, known, feats, (None, "serial", *TEAM_PLANS))


def _interp_grad_check(grad, idx, weight, m, plan=None):
    """The weighted backward under ``plan`` against the plain one, within
    GRAD_RTOL of the absolute sum meeting in a row, and equal bit for bit
    to a second launch and to the ordered sum (a plain loop over list
    positions: each known row from +0, its entries in ascending 3 i + k,
    one product and one addition at a time)."""
    want = three_interpolate_grad_plain(grad, idx, weight, m)
    scale = three_interpolate_grad_plain(grad.abs(), idx, weight.abs(), m)
    ops.reset_launches()
    got = _three_interpolate_grad_cuda(grad, idx, weight, m, plan)
    again = _three_interpolate_grad_cuda(grad, idx, weight, m, plan)
    torch.cuda.synchronize()
    assert ops.launches["three_interpolate_grad"] == 2
    err = (got - want).abs()
    assert bool((err <= GRAD_RTOL * scale + 1e-30).all()), err.max().item()
    assert torch.equal(got, again), plan
    assert torch.equal(got, interp_grad_ordered(grad, idx, weight, m)), plan
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name", NN_CASES)
def test_interpolation_backward_kernel_where_trouble_is_likely(cuda, name):
    unknown, known, feats = (t(a).to(cuda) for a in nn_case(name))
    b, n, _ = unknown.shape
    m, c = feats.shape[1:]
    d, idx = three_nn_plain(unknown, known)
    weight = interpolation_weights(d)
    grad = torch.randn(b, n, c, device=cuda)
    for plan in (None, *INTERP_GRAD_PLANS, (1, 1), (3, 2), (5, 1)):
        _interp_grad_check(grad, idx, weight, m, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_interpolation_backward_at_the_fp_shapes(cuda, b, n, m):
    unknown = _scene(b, n, n + 2, cuda)
    known = unknown[:, ::2][:, :m].contiguous()
    feats = torch.randn(b, m, 256, device=cuda, requires_grad=True)
    grad = torch.randn(b, n, 256, device=cuda)
    ops.reset_launches()
    ops.interpolate_features(unknown, known, feats).backward(grad)
    torch.cuda.synchronize()
    assert ops.launches["three_nn"] == 1
    assert ops.launches["three_interpolate_grad"] == 1
    assert ops.launches["group_points"] == 0
    _, idx, weight = _interpolate_cuda(unknown, known, feats.detach())
    got = _interp_grad_check(grad, idx, weight, m)
    assert torch.equal(feats.grad, got)
    for plan in INTERP_GRAD_PLANS:
        _interp_grad_check(grad, idx, weight, m, plan)


@pytest.mark.gpu
def test_interpolation_without_feature_grad_launches_no_backward(cuda):
    unknown = _scene(2, 300, 3, cuda).requires_grad_(True)
    known = unknown.detach()[:, :40].clone().requires_grad_(True)
    feats = torch.randn(2, 40, 16, device=cuda)
    w = torch.ones(16, device=cuda, requires_grad=True)
    ops.reset_launches()
    (ops.interpolate_features(unknown, known, feats) * w).sum().backward()
    assert ops.launches["three_nn"] == 1
    assert ops.launches["three_interpolate_grad"] == 0
    assert unknown.grad is None and known.grad is None
    feats.requires_grad_(True)
    ops.interpolate_features(unknown, known, feats).sum().backward()
    assert ops.launches["three_interpolate_grad"] == 1
    assert unknown.grad is None and known.grad is None


@pytest.mark.gpu
def test_three_nn_refused_plan_raises(cuda):
    unknown = _scene(2, 300, 4, cuda)
    known = unknown[:, :40].contiguous()
    feats = torch.randn(2, 40, 16, device=cuda)
    for plan in ((3, 32), (8, 3), (32, 64)):
        with pytest.raises(ValueError, match="plan"):
            _three_nn_cuda(unknown, known, plan)
        with pytest.raises(ValueError, match="plan"):
            _interpolate_cuda(unknown, known, feats, plan)
    _nn_check(unknown, known, feats, (None,))


# (b, n, c, m, k) — small odd widths, then the train step's call sites:
# SA1 raw rows, SA1 folded, SA2, SA3/proposal, a K=1 coordinate gather
GROUP_SHAPES = [(2, 50, 3, 7, 1), (2, 50, 5, 7, 3), (3, 64, 12, 9, 4),
                (8, 40960, 135, 2048, 64), (8, 40960, 64, 2048, 64),
                (8, 2048, 128, 1024, 32), (8, 1024, 128, 256, 16),
                (8, 1024, 3, 256, 1)]


def _group_inputs(b, n, c, m, k, device):
    g = torch.Generator(device="cpu").manual_seed(b * n + c)
    points = torch.randn(b, n, c, generator=g).to(device)
    idx = torch.randint(0, n, (b, m, k), generator=g, dtype=torch.int32)
    idx[:, ::3] = idx[:, ::3, :1]  # padded neighbourhoods: one row K times
    return points, idx.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,m,k", GROUP_SHAPES)
def test_group_points_kernel_matches_plain(cuda, b, n, c, m, k):
    points, idx = _group_inputs(b, n, c, m, k, cuda)
    ops.reset_launches()
    got = ops.group_points(points, idx)
    torch.cuda.synchronize()
    assert ops.launches["group_points"] == 1
    want = group_points_plain(points, idx.reshape(b, m * k))
    assert torch.equal(got.reshape(b, m * k, c), want)
    if k == 1:
        assert torch.equal(ops.gather_points(points, idx[:, :, 0]), want)
    # a channel slice of a wider table is gathered in place
    if c > 4:
        view = points[..., 1:c - 1]
        assert torch.equal(ops.group_points(view, idx).reshape(b, m * k, -1),
                           want[..., 1:c - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,m,k", GROUP_SHAPES + [
    (8, 40960, 3, 2048, 64), (2, 300, 64, 33, 5), (1, 77, 135, 5, 3)])
def test_group_points_kernel_subtracts_a_row_a_centre(cuda, b, n, c, m, k):
    points, idx = _group_inputs(b, n, c, m, k, cuda)
    sub = torch.randn(b, m, c, device=cuda)
    want = group_points_plain(points, idx)
    ops.reset_launches()
    got = ops.group_points(points, idx, sub)
    torch.cuda.synchronize()
    assert ops.launches["group_points"] == 1
    # bit for bit the two-op form, whatever the row width
    assert torch.equal(got, want - sub[:, :, None, :])
    assert torch.equal(got, group_points_plain(points, idx, sub))
    # a sliced table and a sliced subtrahend
    if c > 4:
        got = ops.group_points(points[..., 1:c - 1], idx, sub[..., 1:c - 1])
        assert torch.equal(got, (want - sub[:, :, None, :])[..., 1:c - 1])
    # rows that start off a 16-byte boundary
    flat = torch.randn(b * n * c + 1, device=cuda)[1:].view(b, n, c)
    assert torch.equal(ops.group_points(flat, idx, sub),
                       group_points_plain(flat, idx, sub))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 64, 135])
def test_group_points_subtrahend_gradients(cuda, c):
    points, idx = _group_inputs(4, 256, c, 32, 8, cuda)
    sub = torch.randn(4, 32, c, device=cuda, requires_grad=True)
    points.requires_grad_(True)
    grad = torch.randn(4, 32, 8, c, device=cuda)
    ops.reset_launches()
    ops.group_points(points, idx, sub).backward(grad)
    torch.cuda.synchronize()
    assert ops.launches["group_points_grad"] == 1
    flat_idx, flat_grad = idx.reshape(4, 256), grad.reshape(4, 256, c)
    want = group_points_grad_plain(flat_grad, flat_idx, 256)
    scale = group_points_grad_plain(flat_grad.abs(), flat_idx, 256)
    err = (points.grad - want).abs()
    assert bool((err <= GRAD_RTOL * scale + 1e-30).all()), err.max().item()
    assert torch.allclose(sub.grad, -grad.sum(dim=2), rtol=1e-6, atol=1e-5)
    # the subtrahend alone may need the gradient: no scatter-add then
    ops.reset_launches()
    only = sub.detach().requires_grad_(True)
    ops.group_points(points.detach(), idx, only).backward(grad)
    assert ops.launches["group_points_grad"] == 0
    assert torch.allclose(only.grad, -grad.sum(dim=2), rtol=1e-6, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,m,k", GROUP_SHAPES)
def test_group_points_grad_kernel_matches_plain(cuda, b, n, c, m, k):
    points, idx = _group_inputs(b, n, c, m, k, cuda)
    points.requires_grad_(True)
    grad = torch.randn(b, m, k, c, device=cuda)
    ops.reset_launches()
    ops.group_points(points, idx).backward(grad)
    torch.cuda.synchronize()
    assert ops.launches["group_points_grad"] == 1
    flat_idx, flat_grad = idx.reshape(b, m * k), grad.reshape(b, m * k, c)
    want = group_points_grad_plain(flat_grad, flat_idx, n)
    scale = group_points_grad_plain(flat_grad.abs(), flat_idx, n)
    err = (points.grad - want).abs()
    assert bool((err <= GRAD_RTOL * scale + 1e-30).all()), err.max().item()


@pytest.mark.gpu
def test_group_points_never_follows_an_index_out_of_range(cuda):
    """An index past the table gives a NaN row and no gradient; -1 reads
    the last row (the JAX package's rule) and passes no gradient back."""
    points, idx = _group_inputs(2, 50, 8, 7, 3, cuda)
    bad = idx.clone()
    bad[0, 0, 0], bad[1, 2, 1] = 50, -1
    points.requires_grad_(True)
    out = ops.group_points(points, bad)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert torch.isnan(out[0, 0, 0]).all()
    assert torch.equal(out[1, 2, 1], points.detach()[1, 49])
    keep = torch.ones(2, 7, 3, dtype=torch.bool, device=cuda)
    keep[0, 0, 0] = keep[1, 2, 1] = False
    good = torch.where(keep, bad, torch.zeros_like(bad))
    assert torch.equal(out[keep], ops.group_points(points, good)[keep])
    want = group_points_grad_plain(
        keep[..., None].float().expand(2, 7, 3, 8).reshape(2, 21, 8),
        good.reshape(2, 21), 50)
    assert torch.allclose(points.grad, want)
    # odd widths take the other kernel; with a subtrahend the NaN row
    # stays NaN and the wrapped row has the centre subtracted
    odd = points.detach()[..., :5]
    sub = torch.randn(2, 7, 5, device=cuda)
    out = ops.group_points(odd, bad)
    assert torch.isnan(out[0, 0, 0]).all()
    assert torch.equal(out[1, 2, 1], odd[1, 49])
    assert torch.equal(out[keep], ops.group_points(odd, good)[keep])
    out = ops.group_points(odd, bad, sub)
    assert torch.isnan(out[0, 0, 0]).all()
    assert torch.equal(out[1, 2, 1], odd[1, 49] - sub[1, 2])
    assert torch.equal(out[keep], ops.group_points(odd, good, sub)[keep])


def _bound_indices(b, n, r, device):
    """(b, r) i32 indices with every kind in each row: in range, -1, -n,
    n, -n - 1, far out on both sides."""
    g = torch.Generator(device="cpu").manual_seed(n + r)
    idx = torch.randint(0, n, (b, r), generator=g, dtype=torch.int32)
    kinds = torch.tensor([-1, -n, n, -n - 1, 2 ** 31 - 1, -2 ** 31, -2,
                          n + 7], dtype=torch.int32)
    idx[:, 1:2 * len(kinds):2] = kinds
    return idx.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,m,k", [(2, 50, 8, 7, 3), (2, 300, 64, 33, 5),
                                       (1, 77, 135, 5, 4), (3, 40, 3, 16, 2),
                                       (2, 20000, 16, 64, 4)])
def test_out_of_range_indices_follow_the_plain_path(cuda, b, n, c, m, k):
    """Both forward kernels, with and without a subtrahend, equal the
    plain path on every kind of index (NaN rows included); the sorted
    and the atomic backward drop what the plain backward drops."""
    points = torch.randn(b, n, c, device=cuda)
    idx = _bound_indices(b, n, m * k, cuda).view(b, m, k)
    sub = torch.randn(b, m, c, device=cuda)
    for s in (None, sub):
        got = ops.group_points(points, idx, s)
        want = group_points_plain(points, idx, s)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.isnan(group_points_plain(points, idx)).any()
    flat = idx.view(b, m * k)
    grad = torch.randn(b, m * k, c, device=cuda)
    want = group_points_grad_plain(grad, flat, n)
    scale = group_points_grad_plain(grad.abs(), flat, n)
    for plan in (None, "atomic"):
        got = _group_points_grad_cuda(grad, flat, n, plan)
        torch.cuda.synchronize()
        err = (got - want).abs()
        assert bool((err <= GRAD_RTOL * scale + 1e-30).all()), plan
    # a negative index is dropped, not wrapped: a gradient through -1
    # alone leaves the last row at zero
    only = torch.full((b, 1), -1, dtype=torch.int32, device=cuda)
    for plan in (None, "atomic"):
        got = _group_points_grad_cuda(torch.ones(b, 1, c, device=cuda),
                                      only, n, plan)
        assert not got.any(), plan


@pytest.mark.gpu
def test_group_points_without_grad_launches_no_backward(cuda):
    points, idx = _group_inputs(2, 50, 8, 7, 3, cuda)
    w = torch.ones(8, device=cuda, requires_grad=True)
    ops.reset_launches()
    (ops.group_points(points, idx) * w).sum().backward()
    assert ops.launches["group_points"] == 1
    assert ops.launches["group_points_grad"] == 0


@pytest.mark.gpu
def test_kernels_count_launches(cuda):
    xyz = _scene(2, 300, 0, cuda)
    ops.reset_launches()
    ops.furthest_point_sample(xyz, 16)
    ops.ball_query(0.3, 8, xyz, xyz[:, :16])
    ops.ball_query_with_count(0.3, 8, xyz, xyz[:, :16])
    ops.three_nn(xyz, xyz[:, :16])
    ops.gather_points(xyz, torch.zeros(2, 4, dtype=torch.int32, device=cuda))
    assert _kernels.launches == {"fps": 1, "ball_query": 2, "three_nn": 1,
                                 "group_points": 1, "group_points_grad": 0,
                                 "three_interpolate_grad": 0, **NO_POINT_AXIS}


@pytest.mark.gpu
def test_kernel_forward_matches_plain_forward(cuda):
    config = tiny_config(**FLAGS)
    b = make_batch(config, batch_size=4, num_points=256, seed=9, istrain=0)
    batch = {k: b[k] for k in STREAM_KEYS}
    cpu = JointNet(config, device="cpu")
    gpu = JointNet(config, device=cuda)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    ops.reset_launches()
    got = gpu({k: torch.from_numpy(batch[k]).to(cuda) for k in STREAM_KEYS})
    torch.cuda.synchronize()
    assert ops.launches == {"fps": 5, "ball_query": 5, "three_nn": 2,
                            "group_points": 11, "group_points_grad": 0,
                            "three_interpolate_grad": 0, **NO_POINT_AXIS}
    want = cpu({k: torch.from_numpy(batch[k]) for k in STREAM_KEYS})
    for k in ("sa1_inds", "sa2_inds", "aggregated_vote_inds"):
        assert torch.equal(got[k].cpu(), want[k]), k
    np.testing.assert_allclose(got["cluster_ref"].cpu().numpy(),
                               want["cluster_ref"].numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_solver_epoch_on_the_card_counts_launches_a_step(cuda, tmp_path,
                                                         remat):
    """One Solver epoch (train and eval) through the kernels: each step
    launches FPS 5, ball query 5, three-NN 2 (4 under remat), the gather
    11 (15), its backward 5 and the interpolation's backward 2; each eval
    batch one forward's worth."""
    from vlp3d_torch.data.synthetic import make_synthetic_dataset
    from vlp3d_torch.train.solver import Solver

    config = tiny_config(use_con=True, no_caption=True, remat=remat)
    train = make_synthetic_dataset(config, n_scenes=4, anns_per_scene=4,
                                   augment=True, shuffle=True, seed=1)
    val = make_synthetic_dataset(config, n_scenes=3, anns_per_scene=4,
                                 split="val", seed=2)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=2, epochs=1, num_workers=1))
    solver = Solver(config, train, val, str(tmp_path), log_every=1,
                    use_bn_schedule=True, device=cuda)
    solver.init_state()
    per_step, step = [], solver.train_step

    def counted(batch, gen):
        before = dict(ops.launches)
        metrics = step(batch, gen)
        per_step.append({k: v - before[k] for k, v in ops.launches.items()})
        return metrics

    solver.train_step = counted
    ops.reset_launches()
    best = solver(1)
    solver.close()
    forward = {"fps": 5, "ball_query": 5, "three_nn": 2, "group_points": 11,
               "group_points_grad": 0, "three_interpolate_grad": 0,
               **NO_POINT_AXIS}
    want = dict(forward, group_points_grad=5, three_interpolate_grad=2)
    if remat:
        want.update(three_nn=4, group_points=15)
    assert per_step == [want, want]
    assert ops.launches == {k: 2 * want[k] + 2 * forward[k] for k in want}
    assert np.isfinite(best["loss"]) and "iou_rate_0.5" in best
    assert (tmp_path / "model_last.pth").exists()


FORWARD = {"fps": 5, "ball_query": 5, "three_nn": 2, "group_points": 11,
           "group_points_grad": 0, "three_interpolate_grad": 0,
           **NO_POINT_AXIS}


@pytest.mark.gpu
def test_caption_serve_batch_on_the_card_counts_launches(cuda):
    """One CaptionPredictor batch: one forward's kernels (FPS 5, ball
    query 5, three-NN 2, the gather 11, no backward), a caption for every
    proposal, the cached decode equal to the uncached one by the tie
    rule."""
    from vlp3d_torch.models.caption import (
        greedy_decode,
        greedy_decode_uncached,
    )
    from vlp3d_torch.serving import CaptionPredictor

    config = tiny_config(use_con=False, no_caption=False)
    pred = CaptionPredictor(config, batch_size=2, device=cuda)
    b = make_batch(config, batch_size=2, num_points=512, seed=3, istrain=0)
    ops.reset_launches()
    out = pred([{k: b[k] for k in STREAM_KEYS}])[0]
    assert ops.launches == FORWARD
    k = config.model.num_proposal
    assert out["caption_ids"].shape == (2, k, config.model.max_des_len + 2)
    assert (out["caption_ids"][..., 0] == 101).all()
    with torch.no_grad():
        fwd = pred.forward(pred._to_device(b))
    obj = fwd["aggregated_vote_features"].reshape(2 * k, 1, -1)
    dec = pred.model.caption.model
    cached = greedy_decode(dec, obj, config.model.max_des_len)
    plain = greedy_decode_uncached(dec, obj, config.model.max_des_len)
    for r in torch.nonzero((cached != plain).any(dim=1)).flatten().tolist():
        s = int(torch.nonzero(cached[r] != plain[r])[0])
        top2 = torch.topk(dec.decode_step(obj[r:r + 1], plain[r:r + 1],
                                          s - 1)[0], 2).values
        assert float(top2[0] - top2[1]) < 1e-4, (r, s)


@pytest.mark.gpu
@pytest.mark.parametrize("mlm", [False, True])
def test_caption_train_step_on_the_card_counts_launches(cuda, mlm):
    """One caption train step (and one with the MLM branch): the step's
    kernels are a grounding step's (FPS 5, ball query 5, three-NN 2, the
    gather 11, its backward 5, the interpolation's backward 2); cap_loss,
    cap_acc and mlm_loss finite."""
    from vlp3d_torch.train.optimizer import make_optimizer
    from vlp3d_torch.train.state import batch_to_device, make_train_step

    config = tiny_config(use_con=True, no_caption=False, use_mlm=mlm)
    model = JointNet(config, device=cuda)
    step = make_train_step(model, config, make_optimizer(model),
                           caption=True)
    batch = batch_to_device(make_batch(config, batch_size=2,
                                       num_points=512, seed=4), cuda)
    ops.reset_launches()
    metrics = step(batch, torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert ops.launches == dict(FORWARD, group_points_grad=5,
                                three_interpolate_grad=2)
    keys = ("cap_loss", "cap_acc") + (("mlm_loss",) if mlm else ())
    for key in keys:
        assert np.isfinite(float(metrics[key])), key


# ----------------------------------------------- point-axis parallel


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,npoint", [(2, 300, 40), (8, 40960, 2048),
                                        (3, 10240, 256), (9, 4096, 64)])
def test_fps_shard_loop_one_rank_matches_plain_and_dense(cuda, b, n, npoint):
    xyz = _scene(b, n, 1, cuda)
    ops.reset_launches()
    got = pp.fps_sharded(xyz, npoint)
    torch.cuda.synchronize()
    assert _kernels.launches["fps_shard_loop"] == 1
    assert torch.equal(got, pp.fps_sharded_plain(xyz, npoint))
    assert torch.equal(got, fps_plain(xyz, npoint))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 4])
def test_fps_shard_loop_emulated_ranks_equal_dense(cuda, w):
    cases = t(fps_cases()).to(cuda)
    ops.reset_launches()
    for got in pp.fps_emulated(cases, w, 24):
        assert torch.equal(got, fps_plain(cases, 24))
    assert _kernels.launches["fps_shard_loop"] == 1
    xyz = _scene(8, 40960, 2, cuda)
    want = _fps_cuda(xyz, 512)
    for got in pp.fps_emulated(xyz, w, 512):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 2])
def test_fps_shard_loop_streams_slabs_past_registers(cuda, w):
    """A slab of more than 131072 points, whose share of a 16-block
    cluster does not fit in registers, streams from global memory: at one
    rank through fps_sharded and at two ranks emulated in one launch,
    equal to the dense FPS (an all-invalid row and a zero tail
    included)."""
    nl = 140000
    assert pp.loop_plan(nl) == (16, 0)
    xyz = _scene(2, nl * w, 3, cuda)
    want = _fps_cuda(xyz, 256)
    ops.reset_launches()
    got = ([pp.fps_sharded(xyz, 256)] if w == 1
           else pp.fps_emulated(xyz, w, 256))
    torch.cuda.synchronize()
    assert _kernels.launches["fps_shard_loop"] == 1
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.gpu
def test_fps_shard_loop_traps_when_a_peer_never_writes(cuda):
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, os.path.join(
        here, "torch_stall_probe.py"), "0.5"], capture_output=True,
        text=True, timeout=300, env=env)
    assert run.returncode == 3, run.stdout + run.stderr
    assert "trapped after" in run.stdout


def _merge_inputs(xyz, ctr, radius, nsample, w):
    nl = xyz.shape[1] // w
    parts = [ops.ball_query_with_count(
        radius, nsample, xyz[:, i * nl:(i + 1) * nl].contiguous(), ctr)
        for i in range(w)]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]), nl)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("b,n,m,radius,nsample", [
    (2, 300, 50, 0.3, 8), (8, 40960, 2048, 0.2, 64), (3, 400, 30, 0.8, 6),
    (2, 400, 33, 2.0, 3)])
def test_ball_query_merge_kernel_matches_plain(cuda, w, b, n, m, radius,
                                               nsample):
    xyz = _scene(b, n, 3, cuda)
    ctr = xyz[:, :m].contiguous()
    all_idx, all_cnt, nl = _merge_inputs(xyz, ctr, radius, nsample, w)
    ops.reset_launches()
    got = pp.ball_query_merge(all_idx, all_cnt, nl, nsample)
    torch.cuda.synchronize()
    assert _kernels.launches["ball_query_merge"] == 1
    assert torch.equal(got, pp.ball_query_merge_plain(all_idx, all_cnt, nl,
                                                      nsample))
    assert torch.equal(got, ops.ball_query(radius, nsample, xyz, ctr))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("nsample", [2, 8])
def test_ball_query_merge_kernel_where_trouble_is_likely(cuda, w, nsample):
    xyz, ctr = (t(a).to(cuda) for a in merge_cases())
    all_idx, all_cnt, nl = _merge_inputs(xyz, ctr, 0.5, nsample, w)
    got = pp.ball_query_merge(all_idx, all_cnt, nl, nsample)
    assert torch.equal(got, pp.ball_query_merge_plain(all_idx, all_cnt, nl,
                                                      nsample))
    assert torch.equal(got, ops.ball_query(0.5, nsample, xyz, ctr))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [33, 64])
@pytest.mark.parametrize("nsample", [8, 64])
def test_ball_query_merge_past_32_shards(cuda, w, nsample):
    """The merge over more shards than a warp's lanes, its chunks of 32
    shards: hits in every shard, only past the first 32, across shards 31
    and 32, none; and a scene's balls over w slabs."""
    xyz, ctr = (t(a).to(cuda) for a in wide_merge_cases(w))
    all_idx, all_cnt, nl = _merge_inputs(xyz, ctr, 0.5, nsample, w)
    ops.reset_launches()
    got = pp.ball_query_merge(all_idx, all_cnt, nl, nsample)
    torch.cuda.synchronize()
    assert _kernels.launches["ball_query_merge"] == 1
    assert torch.equal(got, pp.ball_query_merge_plain(all_idx, all_cnt, nl,
                                                      nsample))
    assert torch.equal(got, ops.ball_query(0.5, nsample, xyz, ctr))
    scene = _scene(2, w * 160, 7, cuda)
    ctr = scene[:, :100].contiguous()
    all_idx, all_cnt, nl = _merge_inputs(scene, ctr, 0.8, nsample, w)
    got = pp.ball_query_merge(all_idx, all_cnt, nl, nsample)
    assert torch.equal(got, pp.ball_query_merge_plain(all_idx, all_cnt, nl,
                                                      nsample))
    assert torch.equal(got, ops.ball_query(0.8, nsample, scene, ctr))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,npoint", [(2, 300, 40), (8, 40960, 2048),
                                        (3, 10240, 256), (2, 140000, 64)])
def test_fps_shard_step_collective_route_matches_plain_and_dense(
        cuda, b, n, npoint):
    """The collective route forced at one rank: one step kernel an
    iteration, bit-equal to the plain loop, the dense FPS and the peer
    route."""
    xyz = _scene(b, n, 1, cuda)
    ops.reset_launches()
    got = pp.fps_sharded(xyz, npoint, route="collective")
    torch.cuda.synchronize()
    assert _kernels.launches["fps_shard_step"] == npoint
    assert _kernels.launches["fps_shard_loop"] == 0
    assert torch.equal(got, pp.fps_sharded_plain(xyz, npoint))
    assert torch.equal(got, fps_plain(xyz, npoint))
    assert torch.equal(got, pp.fps_sharded(xyz, npoint, route="peer"))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 4, 33])
def test_fps_shard_step_emulated_ranks_equal_dense(cuda, w):
    """w ranks' step kernels in turn, each on its slab (33: the pick among
    more candidates than a warp's lanes): ties across shards, an
    all-invalid row, a scene."""
    ties = torch.zeros((2, w * 8, 3), device=cuda)
    ties[0] = t(np.tile(np.random.default_rng(6).standard_normal((8, 3)),
                        (w, 1)).astype(np.float32)).to(cuda)
    want = fps_plain(ties, 40)
    for got in pp.fps_emulated(ties, w, 40, route="collective"):
        assert torch.equal(got, want)
    xyz = _scene(3, w * 512, 2, cuda)
    want = _fps_cuda(xyz, 256)
    for got in pp.fps_emulated(xyz, w, 256, route="collective"):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernels_take_65537_batch_rows(cuda):
    """Ball query (both kernels), the gather's backward (both), three-NN
    (both), the interpolation and its backward, and hard voxelization at
    65537 rows, past the 65535 a grid's y takes, against their plain
    versions (tests/torch_batch_rows.py)."""
    errs = check_batch_rows(torch, cuda)
    assert set(errs) == {"ball_query", "group_points_grad", "three_nn",
                         "three_interpolate_grad", "hard_voxelize"}


# -- the PointPillars kernels (csrc/voxelize.cu, csrc/iou3d.cu) -----------

PILLAR_VOXEL = (0.16, 0.16, 4.0)
PILLAR_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)


def _pillar_points(b, n, seed, crowd=0, outside=0.0, c=4,
                   coors_range=PILLAR_RANGE):
    """(b, n, c) float32 over PointPillars' KITTI range (or
    ``coors_range``), a share outside it, the first row's first ``crowd``
    points (shuffled in) in one pillar; channels past x, y, z uniform over
    [0, 1)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(coors_range[:3]), np.array(coors_range[3:])
    xyz = rng.uniform(lo - (hi - lo) * outside, hi + (hi - lo) * outside,
                      (b, n, 3))
    if crowd:
        xyz[0, :crowd] = [20.01, 5.01, -1.0] + rng.uniform(0, 0.14,
                                                           (crowd, 3))
        xyz[0] = xyz[0, rng.permutation(n)]
    return np.concatenate([xyz, rng.uniform(0, 1, (b, n, c - 3))],
                          -1).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,crowd,outside,slots,voxels,c", [
    (1, 1, 0, 0.0, 32, 16000, 4),
    (2, 5000, 0, 0.2, 32, 16000, 4),
    (3, 40000, 0, 0.0, 8, 3000, 4),       # the voxel cap
    (1, 60000, 20000, 0.3, 32, 16000, 4),  # the slot cap, a long segment
    (4, 120000, 0, 0.0, 32, 16000, 4),     # the encoder's shape
    (2, 3000, 0, 3.0, 32, 100, 4),         # most points outside
    (2, 5000, 300, 0.2, 35, 16000, 4),     # 35 slots (JAX's default)
    (2, 8000, 2000, 0.1, 100, 4000, 4),    # 100 slots
    (1, 120000, 120000, 0.0, 32, 16000, 4),  # every point in one cell
    (2, 5000, 500, 0.1, 32, 16000, 3),     # C = 3 (no float4 rows)
    (2, 5000, 500, 0.1, 35, 2000, 5),      # C = 5
])
def test_voxelize_kernels_equal_plain(cuda, b, n, crowd, outside, slots,
                                      voxels, c):
    from vlp3d_torch.ops import voxelize as vox

    pts = t(_pillar_points(b, n, n + b, crowd, outside, c)).to(cuda)
    ops.reset_launches()
    got = vox._hard_cuda(pts, PILLAR_VOXEL, PILLAR_RANGE, slots, voxels)
    again = vox._hard_cuda(pts, PILLAR_VOXEL, PILLAR_RANGE, slots, voxels)
    torch.cuda.synchronize()
    assert _kernels.launches["dynamic_voxelize"] == 2
    assert _kernels.launches["hard_voxelize"] == 2
    want = vox.hard_voxelize_plain(pts, PILLAR_VOXEL, PILLAR_RANGE, slots,
                                   voxels)
    for a, a2, w in zip(got, again, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
        assert torch.equal(a, a2)
    coords, grid = vox.dynamic_voxelize(pts, PILLAR_VOXEL, PILLAR_RANGE)
    assert torch.equal(coords, vox.dynamic_voxelize_plain(
        pts, PILLAR_VOXEL, PILLAR_RANGE)[0])
    assert grid.tolist() == [432, 496, 1]
    # the batched launch is its rows
    one = vox._hard_cuda(pts[-1:].contiguous(), PILLAR_VOXEL, PILLAR_RANGE,
                         slots, voxels)
    for a, w in zip(one, got):
        assert torch.equal(a[0], w[-1])


# OpenPCDet's SECOND (kitti_models/second.yaml): 90 112 000 cells, past
# any dense cell table; 5 points a voxel, 16000 (train) / 40000 (test)
SECOND_VOXEL = (0.05, 0.05, 0.1)
SECOND_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("voxels", [16000, 40000])
@pytest.mark.parametrize("b,n,crowd", [(4, 120000, 0), (2, 60000, 20000),
                                       (3, 5000, 0)])
def test_hard_voxelize_kernel_at_second_grid(cuda, voxels, b, n, crowd):
    from vlp3d_torch.ops import voxelize as vox

    pts = t(_pillar_points(b, n, n + voxels, crowd, 0.1,
                           coors_range=SECOND_RANGE)).to(cuda)
    got = vox._hard_cuda(pts, SECOND_VOXEL, SECOND_RANGE, 5, voxels)
    again = vox._hard_cuda(pts, SECOND_VOXEL, SECOND_RANGE, 5, voxels)
    want = vox.hard_voxelize_plain(pts, SECOND_VOXEL, SECOND_RANGE, 5,
                                   voxels)
    for a, a2, w in zip(got, again, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
        assert torch.equal(a, a2)
    _, grid = vox.dynamic_voxelize(pts, SECOND_VOXEL, SECOND_RANGE)
    assert grid.tolist() == [1408, 1600, 40]
    assert int(got[3].min()) > 0
    if crowd:  # the crowd's voxels fill their 5 slots
        assert int(got[2].max()) == 5


@pytest.mark.gpu
def test_voxelize_gradient_and_refusals(cuda):
    from vlp3d_torch.ops import voxelize as vox

    host = _pillar_points(2, 3000, 4, crowd=200)
    g = np.random.default_rng(1).normal(size=(2, 400, 8, 4)).astype(
        np.float32)
    grads = []
    for dev in ("cpu", cuda):
        x = t(host).to(dev).requires_grad_(True)
        out = vox.hard_voxelize(x, PILLAR_VOXEL, PILLAR_RANGE, 8, 400)
        out["voxels"].backward(t(g).to(dev))
        grads.append(x.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    with pytest.raises(ValueError, match="cells"):
        vox.hard_voxelize(t(host).to(cuda), (0.01, 0.01, 0.01),
                          PILLAR_RANGE, 8, 400)
    with pytest.raises(ValueError, match="float32"):
        vox.dynamic_voxelize(t(host).to(cuda).double(), PILLAR_VOXEL,
                             PILLAR_RANGE)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(1, 1), (17, 33), (300, 257), (4096, 64),
                                 (4095, 4095), (4097, 4097)])
def test_iou_bev_kernel_matches_plain(cuda, n, m):
    from vlp3d_torch.ops import iou3d

    a = t(bev_boxes(n, n, spread=40.0, size=(1, 5))).to(cuda)
    b = t(bev_boxes(m, m + 1, spread=40.0, size=(1, 5))).to(cuda)
    got = iou3d.boxes_iou_bev(a, b)
    assert (got - iou3d.boxes_iou_bev_plain(a, b)).abs().max() <= 1e-6
    over = iou3d.boxes_overlap_bev(a, b)
    want = iou3d.boxes_overlap_bev_plain(a, b)
    assert ((over - want).abs() / want.abs().clamp(min=1)).max() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 12, 63, 64, 65, 1000, 4095, 4097, 20000])
@pytest.mark.parametrize("thresh", [0.01, 0.5])
def test_nms_kernel_matches_the_plain_scan(cuda, n, thresh):
    from vlp3d_torch.ops import iou3d

    boxes = (edge_boxes() if n == 12 else bev_boxes(
        n, n, spread=max(4.0, n ** 0.5), size=(1, 5)))
    b = t(boxes).to(cuda)
    scores = t(np.random.default_rng(n).uniform(0, 1, n).astype(
        np.float32)).to(cuda)
    scores[n // 2:] = scores[0].clone()  # ties
    order = iou3d.rank_boxes(scores)
    for form in ("rotated", "normal"):
        ops.reset_launches()
        keep = getattr(iou3d, f"nms_{form}")(b, scores, thresh)
        assert _kernels.launches["nms_bev"] == 1
        r = b.clone()
        if form == "normal":
            r[:, 4] = 0
        r = r[order].contiguous()
        alive = iou3d.nms_scan_plain(iou3d.boxes_iou_bev(r, r), thresh)
        want = torch.zeros_like(alive)
        want[order] = alive
        assert torch.equal(keep, want)
    if n == 12:
        iou = iou3d.boxes_iou_bev(b, b)
        want = iou3d.boxes_iou_bev_plain(b, b)
        assert ((iou - want).abs() / want.abs().clamp(min=1)).max() <= 1e-6


@pytest.mark.gpu
def test_iou_and_nms_kernels_on_clips_past_8_vertices(cuda):
    """overflow_boxes' pairs whose clip passes 8 vertices go to the
    kernels' 16-slot path: the IoU equal to plain, NMS to the plain scan."""
    from vlp3d_torch.ops import iou3d

    b = t(overflow_boxes()).to(cuda)
    assert (max_clip_counts(b, b) > 8).any()
    iou = iou3d.boxes_iou_bev(b, b)
    assert (iou - iou3d.boxes_iou_bev_plain(b, b)).abs().max() <= 1e-6
    scores = t(np.random.default_rng(3).uniform(0, 1, len(b)).astype(
        np.float32)).to(cuda)
    order = iou3d.rank_boxes(scores)
    r = b[order].contiguous()
    for thresh in (0.01, 0.5):
        alive = iou3d.nms_scan_plain(iou3d.boxes_iou_bev(r, r), thresh)
        want = torch.zeros_like(alive)
        want[order] = alive
        assert torch.equal(iou3d.nms_rotated(b, scores, thresh), want)
