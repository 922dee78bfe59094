"""The hand-written CUDA kernels against their plain PyTorch versions.

Card-only: every test is marked ``gpu`` and skips on a host without a
CUDA device. The file imports no JAX, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Shapes
run from small to the main path's (B=8, N=40960). Indices must be equal;
three-NN distances within 1e-6 and interpolated features within 1e-5;
the tiny JointNet's cluster_ref within 1e-4 of the CPU forward.
"""

import numpy as np
import pytest
import torch

from vlp3d_torch import ops
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops.ball_query import ball_query_plain
from vlp3d_torch.ops.interpolate import three_nn_plain
from vlp3d_torch.ops.sampling import fps_plain
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


# (b, n, npoint) — small, the five main-path FPS calls at B=8, and a row
# too long for shared memory (running distances in global scratch)
FPS_SHAPES = [(2, 300, 40), (8, 40960, 2048), (8, 2048, 1024),
              (8, 1024, 512), (8, 512, 256), (8, 1024, 256),
              (2, 1 << 16, 64)]
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


@pytest.mark.gpu
def test_kernels_count_launches(cuda):
    xyz = _scene(2, 300, 0, cuda)
    ops.reset_launches()
    ops.furthest_point_sample(xyz, 16)
    ops.ball_query(0.3, 8, xyz, xyz[:, :16])
    ops.ball_query_with_count(0.3, 8, xyz, xyz[:, :16])
    ops.three_nn(xyz, xyz[:, :16])
    assert _kernels.launches == {"fps": 1, "ball_query": 2, "three_nn": 1}


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
    assert ops.launches == {"fps": 5, "ball_query": 5, "three_nn": 2}
    want = cpu({k: torch.from_numpy(batch[k]) for k in STREAM_KEYS})
    for k in ("sa1_inds", "sa2_inds", "aggregated_vote_inds"):
        assert torch.equal(got[k].cpu(), want[k]), k
    np.testing.assert_allclose(got["cluster_ref"].cpu().numpy(),
                               want["cluster_ref"].numpy(), **TOL)
