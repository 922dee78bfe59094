"""The hand-written CUDA kernels against their plain PyTorch versions.

Card-only: every test is marked ``gpu`` and skips on a host without a
CUDA device. The file imports no JAX, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Shapes
run from small to the main path's (B=8, N=40960), and the FPS kernels
also run where a row split over blocks is likely to go wrong (ties across
blocks, blocks with no valid point, ragged lengths, any batch size).
Indices must be equal;
three-NN distances within 1e-6 and interpolated features within 1e-5;
the row gather exact and its atomic scatter-add backward within
``GRAD_RTOL`` (1e-5) of the absolute sum meeting in a row; the tiny
JointNet's cluster_ref within 1e-4 of the CPU forward.
"""

import numpy as np
import pytest
import torch

from vlp3d_torch import ops
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops.ball_query import ball_query_plain
from vlp3d_torch.ops.grouping import (
    GRAD_RTOL,
    group_points_grad_plain,
    group_points_plain,
)
from vlp3d_torch.ops.interpolate import three_nn_plain
from vlp3d_torch.ops.sampling import _fps_cuda, _fps_plan, fps_plain
from vlp3d_torch.serving import STREAM_KEYS

TOL = dict(rtol=1e-4, atol=1e-4)
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
    points, idx = _group_inputs(2, 50, 8, 7, 3, cuda)
    bad = idx.clone()
    bad[0, 0, 0], bad[1, 2, 1] = 50, -1
    points.requires_grad_(True)
    out = ops.group_points(points, bad)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert not out[0, 0, 0].any() and not out[1, 2, 1].any()
    keep = torch.ones(2, 7, 3, dtype=torch.bool, device=cuda)
    keep[0, 0, 0] = keep[1, 2, 1] = False
    good = torch.where(keep, bad, torch.zeros_like(bad))
    assert torch.equal(out[keep], ops.group_points(points, good)[keep])
    want = group_points_grad_plain(
        keep[..., None].float().expand(2, 7, 3, 8).reshape(2, 21, 8),
        good.reshape(2, 21), 50)
    assert torch.allclose(points.grad, want)
    # odd widths take the other kernel; with a subtrahend the source row
    # counts as zeros
    odd = points.detach()[..., :5]
    sub = torch.randn(2, 7, 5, device=cuda)
    out = ops.group_points(odd, bad)
    assert not out[0, 0, 0].any() and not out[1, 2, 1].any()
    assert torch.equal(out[keep], ops.group_points(odd, good)[keep])
    out = ops.group_points(odd, bad, sub)
    assert torch.equal(out[0, 0, 0], -sub[0, 0])
    assert torch.equal(out[1, 2, 1], -sub[1, 2])
    assert torch.equal(out[keep], ops.group_points(odd, good, sub)[keep])


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
                                 "group_points": 1, "group_points_grad": 0}


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
                            "group_points": 13, "group_points_grad": 0}
    want = cpu({k: torch.from_numpy(batch[k]) for k in STREAM_KEYS})
    for k in ("sa1_inds", "sa2_inds", "aggregated_vote_inds"):
        assert torch.equal(got[k].cpu(), want[k]), k
    np.testing.assert_allclose(got["cluster_ref"].cpu().numpy(),
                               want["cluster_ref"].numpy(), **TOL)
