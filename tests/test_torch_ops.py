"""vlp3d_torch.ops against the JAX ops and the numpy oracles.

The same seeded numpy inputs go through the JAX op (XLA path on the CPU,
the Pallas FPS kernel in interpret mode) and through the port's plain
PyTorch version, which is what a CPU tensor runs. Indices must match bit
for bit; three_nn distances within 1e-6 and interpolated features within
1e-5 (absolute). The CUDA kernels are held against these plain versions
on the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import oracles
from vlp3d import ops as jops
from vlp3d.ops.ball_query import ball_query_with_count as jax_bq_count
from vlp3d_torch import ops


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def cloud(rng, b, n, pad):
    """Random cloud with origin padding (never picked) and a duplicate pair."""
    xyz = rng.uniform(-2.0, 2.0, size=(b, n, 3)).astype(np.float32)
    xyz[:, -pad:, :] = 0.0
    xyz[:, 7] = xyz[:, 3]  # exact duplicate: distance ties
    return xyz


# ---------------------------------------------------------------- FPS


@pytest.mark.parametrize("b", [3, 8, 9, 16])
def test_fps_matches_jax_and_oracle(b):
    rng = np.random.default_rng(b)
    xyz = cloud(rng, b, 160, 12)
    xyz[-1] = 0.0  # an all-padding row: argmax over all -1 picks 0
    got = ops.furthest_point_sample(t(xyz), 24)
    assert got.dtype == torch.int32
    want = np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), 24,
                                                 impl="xla"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracles.fps_oracle(xyz, 24))
    assert (got[-1] == 0).all()
    assert (got[:-1].numpy() < 160 - 12).all()


def test_fps_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    xyz = cloud(np.random.default_rng(1), 2, 256, 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), 32,
                                                     impl="pallas"))
    np.testing.assert_array_equal(
        ops.furthest_point_sample(t(xyz), 32).numpy(), want)


# ---------------------------------------------------------- ball query


@pytest.mark.parametrize(
    "radius,nsample,m",
    [
        (0.3, 8, 40),  # mixed: full balls, partial balls
        (0.05, 4, 40),  # mostly fewer hits than nsample
        (0.8, 64, 40),  # large nsample, padding with the first hit
        (0.4, 16, 300),  # M > 256: the JAX chunked path
        (1.5, 300, 40),  # nsample > N: every slot past the hits is padding
    ],
)
def test_ball_query_matches_jax_and_oracle(radius, nsample, m):
    rng = np.random.default_rng(m + nsample)
    xyz = rng.uniform(-1, 1, size=(2, 240, 3)).astype(np.float32)
    new_xyz = rng.uniform(-1.2, 1.2, size=(2, m, 3)).astype(np.float32)
    new_xyz[:, :5] = 9.0  # empty balls: all zeros, count 0
    idx, cnt = ops.ball_query_with_count(radius, nsample, t(xyz), t(new_xyz))
    jidx, jcnt = jax_bq_count(radius, nsample, jnp.asarray(xyz),
                              jnp.asarray(new_xyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(
        idx.numpy(), oracles.ball_query_oracle(radius, nsample, xyz, new_xyz))
    assert (idx[:, :5] == 0).all() and (cnt[:, :5] == 0).all()
    np.testing.assert_array_equal(
        ops.ball_query(radius, nsample, t(xyz), t(new_xyz)).numpy(),
        idx.numpy())


def test_query_and_group_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-1, 1, size=(2, 120, 3)).astype(np.float32)
    new_xyz = xyz[:, :20]
    feats = rng.normal(size=(2, 120, 5)).astype(np.float32)
    got, gxyz = ops.query_and_group(0.5, 8, t(xyz), t(new_xyz), t(feats),
                                    normalize_xyz=True)
    want, wxyz = jops.query_and_group(0.5, 8, jnp.asarray(xyz),
                                      jnp.asarray(new_xyz),
                                      jnp.asarray(feats), normalize_xyz=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gxyz.numpy(), np.asarray(wxyz), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ grouping


def test_gather_and_group_exact():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 12)).astype(np.int32)
    gidx = rng.integers(0, 50, size=(2, 12, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_points(t(pts), t(idx)).numpy(),
        np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        ops.group_points(t(pts), t(gidx)).numpy(),
        np.asarray(jops.group_points(jnp.asarray(pts), jnp.asarray(gidx))))


# --------------------------------------------------------- three_nn


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.default_rng(3)
    unknown = rng.normal(size=(2, 70, 3)).astype(np.float32)
    known = rng.normal(size=(2, 25, 3)).astype(np.float32)
    known[:, 9] = known[:, 4]  # ties: the lower index comes first
    unknown[:, :3] = known[:, :3]  # zero distances
    feats = rng.normal(size=(2, 25, 16)).astype(np.float32)
    d, i = ops.three_nn(t(unknown), t(known))
    jd, ji = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    _, oi = oracles.three_nn_oracle(unknown, known)
    np.testing.assert_array_equal(i.numpy(), oi)
    got = ops.interpolate_features(t(unknown), t(known), t(feats))
    want = jops.interpolate_features(jnp.asarray(unknown), jnp.asarray(known),
                                     jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_three_nn_needs_three_known_points():
    with pytest.raises(ValueError, match="at least 3"):
        ops.three_nn(torch.zeros(1, 4, 3), torch.zeros(1, 2, 3))


# ----------------------------------------------------------- dispatch


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    from vlp3d_torch.parallel import point_parallel as pp

    ops.reset_launches()
    xyz = torch.rand(1, 64, 3)
    ops.furthest_point_sample(xyz, 8)
    ops.ball_query(0.3, 4, xyz, xyz[:, :8])
    ops.three_nn(xyz, xyz[:, :8])
    # the point-axis wrappers (no process group: one rank's slab)
    inds = pp.fps_sharded(xyz, 8)
    pp.ball_query_sharded(0.3, 4, xyz, xyz[:, :8])
    pp.gather_points_sharded(xyz, inds)
    assert ops.launches == {"fps": 0, "ball_query": 0, "three_nn": 0,
                            "group_points": 0, "group_points_grad": 0,
                            "three_interpolate_grad": 0,
                            "fps_shard_loop": 0, "ball_query_merge": 0,
                            "gather_owned": 0, "dynamic_voxelize": 0,
                            "hard_voxelize": 0, "boxes_iou_bev": 0,
                            "nms_bev": 0}
    meta = torch.empty(1, 64, 3, device="meta")
    for call in (
        lambda: ops.furthest_point_sample(meta, 8),
        lambda: ops.ball_query(0.3, 4, meta, meta[:, :8]),
        lambda: ops.three_nn(meta, meta[:, :8]),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_kernel_library_name_tracks_source_and_flags(monkeypatch):
    from vlp3d_torch.ops import _kernels

    names = {name: _kernels.lib_path(name) for name in _kernels.SOURCES}
    assert len(set(names.values())) == len(names)
    for name, path in names.items():
        assert path.parent == _kernels.BUILD_DIR
        assert path.name.startswith(f"lib{name}.")
        assert _kernels.lib_path(name) == path
    monkeypatch.setattr(_kernels, "NVCC_FLAGS",
                        tuple(f for f in _kernels.NVCC_FLAGS
                              if f != "--fmad=false"))
    for name, path in names.items():
        assert _kernels.lib_path(name) != path
