"""Point-axis parallel of vlp3d_torch (``vlp3d_torch.parallel.point_parallel``,
ROADMAP B6) against the JAX package's ``vlp3d.parallel.point_parallel``.

JAX's sharded functions run once, on a 4-device point mesh, at the sizes
of tests/test_point_parallel.py (b 2, n 1024, origin padding and
duplicated points; the backbone at n 512). One launch of 4 gloo ranks
(tests/torch_parallel_jobs.py's ``points`` job) runs the port's on point
groups of 2 and of 4 ranks, each rank holding its slab: FPS, the ball
query, the gather and group, the front end and the backbone. Their
outputs do not depend on the group's size, so both are held to JAX's:
indices exactly, the gathered rows and the front's neighbourhoods bit
for bit (each row has one owner, the others add zeros), the backbone's
float outputs within JAX's own atol of 2e-5. The owned gather's
gradient, each rank's slab, equals the slab of the dense
``group_points`` VJP.

The FPS step and the ball-query merge are also held, in one process over
stacked per-shard outputs (the ranks emulated in turn), against the
dense ops on the whole cloud on the cases where a merge can go wrong:
all hits in one shard, hits across shards, an empty ball, ties across
shards, an all-invalid row.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_distributed import run_ranks
from torch_point_cases import fps_cases, merge_cases
from vlp3d.models.backbone import PointNet2Backbone as JaxBackbone
from vlp3d.models.backbone import (
    apply_backbone_large_scene as jax_apply_backbone_large_scene,
)
from vlp3d.ops.grouping import group_points as jax_group_points
from vlp3d.parallel.point_parallel import (
    POINT_AXIS,
    ball_query_sharded as jax_ball_query_sharded,
    fps_sharded as jax_fps_sharded,
    gather_points_sharded as jax_gather_points_sharded,
    group_points_sharded as jax_group_points_sharded,
    large_scene_front as jax_large_scene_front,
    make_mesh_point,
)
from vlp3d_torch.convert import convert_backbone, to_tensors
from vlp3d_torch.ops import ball_query, furthest_point_sample
from vlp3d_torch.parallel.point_parallel import (
    ball_query_emulated,
    fps_emulated,
)

B, N, C = 2, 1024, 6
NPOINT, RADIUS, NSAMPLE = 64, 0.5, 16
BACKBONE = dict(input_feature_dim=2, npoints=(64, 32, 16, 8),
                radii=(0.3, 0.5, 0.8, 1.2), nsamples=(8, 8, 4, 4))
BB_ATOL = 2e-5  # tests/test_point_parallel.py's backbone tolerance


def _cloud(rng, b=B, n=N, pad_origin=32):
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    xyz[:, -pad_origin:] = 0.0
    xyz[:, 100:108] = xyz[:, 0:8]
    return xyz


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    xyz = _cloud(rng)
    pc = np.concatenate([_cloud(rng, n=512),
                         rng.standard_normal((B, 512, 2)).astype(np.float32)],
                        axis=-1)
    return dict(
        xyz=xyz,
        feats=rng.standard_normal((B, N, C)).astype(np.float32),
        centers=rng.standard_normal((B, 96, 3)).astype(np.float32),
        idx2=rng.integers(0, N, (B, 50)).astype(np.int32),
        idx3=rng.integers(0, N, (B, 50, 16)).astype(np.int32),
        up=rng.standard_normal((B, 50, 16, C)).astype(np.float32),
        pc=pc.astype(np.float32))


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """JAX's sharded functions on a 4-device point mesh, and the dense
    group_points VJP."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), (POINT_AXIS,))
    sh, rep = P(None, POINT_AXIS, None), P()

    def smap(fn, *specs):  # jitted: one program, not op by op
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=specs,
                                 out_specs=rep))

    x, f = jnp.asarray(inputs["xyz"]), jnp.asarray(inputs["feats"])
    out = {
        "fps": smap(lambda a: jax_fps_sharded(a, NPOINT), sh)(x),
        "ball": smap(lambda a, c: jax_ball_query_sharded(
            RADIUS, NSAMPLE, a, c), sh, rep)(
                x, jnp.asarray(inputs["centers"])),
        "gather": smap(jax_gather_points_sharded, sh, rep)(
            f, jnp.asarray(inputs["idx2"])),
        "group": smap(jax_group_points_sharded, sh, rep)(
            f, jnp.asarray(inputs["idx3"])),
    }
    idx3 = jnp.asarray(inputs["idx3"])
    _, vjp = jax.vjp(lambda t: jax_group_points(t, idx3), f)
    out["group_grad"] = vjp(jnp.asarray(inputs["up"]))[0]
    front = jax_large_scene_front(make_mesh_point(4, 1), npoint=NPOINT,
                                  radius=RADIUS, nsample=NSAMPLE,
                                  normalize_xyz=True)
    out["front_new"], out["front_grouped"], out["front_inds"] = jax.jit(
        front)(x, f)
    backbone = JaxBackbone(**BACKBONE)
    pc = jnp.asarray(inputs["pc"])
    # seeded weights in the shapes of init (no init run), every running
    # variance positive
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.uniform(0.5, 1.5, s.shape) if path[-1].key
                         == "var" else 0.1 * rng.standard_normal(s.shape)
                         ).astype(np.float32),
        jax.eval_shape(lambda: backbone.init(jax.random.key(0), pc)))
    bb = jax.jit(lambda v, p: jax_apply_backbone_large_scene(
        backbone, v, p, make_mesh_point(4, 1)))(variables, pc)
    out = {k: np.asarray(v) for k, v in jax.device_get(out).items()}
    out.update({"bb." + k: np.asarray(v) for k, v in bb.items()})
    sd = {}
    convert_backbone(variables["params"], variables["batch_stats"], "", sd)
    return out, to_tensors(sd)


@pytest.fixture(scope="module")
def ranks(inputs, jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    torch.save(jax_ref[1], tmp / "backbone.pt")
    np.savez(tmp / "in.npz", **inputs)
    spec = dict(npz=str(tmp / "in.npz"), worlds=[2, 4], npoint=NPOINT,
                balls=[[RADIUS, NSAMPLE]], radius=RADIUS, nsample=NSAMPLE,
                backbone=dict(BACKBONE, state=str(tmp / "backbone.pt")))
    res = run_ranks("points", spec, tmp, world=4)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_ops_equal_jax_s(jax_ref, ranks, w):
    want = jax_ref[0]
    pre = f"w{w}/"
    for r in ranks:
        np.testing.assert_array_equal(r[pre + "fps"], want["fps"])
        np.testing.assert_array_equal(r[pre + "ball0"], want["ball"])
        np.testing.assert_array_equal(r[pre + "gather"], want["gather"])
        np.testing.assert_array_equal(r[pre + "group"], want["group"])


@pytest.mark.parametrize("w", [2, 4])
def test_owned_gather_gradient_is_the_dense_vjp_slab(jax_ref, ranks, w):
    """Each rank's gradient at its slab is that slab of the dense VJP: the
    replicated output's gradient, scattered unsummed into the rows the
    rank owns (float32 sums of the same terms in another order)."""
    want = jax_ref[0]["group_grad"]
    n = N // w
    for r in ranks:
        rank = int(r[f"w{w}/rank"])
        np.testing.assert_allclose(r[f"w{w}/group_grad"],
                                   want[:, rank * n:(rank + 1) * n],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", [2, 4])
def test_large_scene_front_and_backbone_equal_jax_s(jax_ref, ranks, w):
    want = jax_ref[0]
    pre = f"w{w}/"
    for r in ranks:
        np.testing.assert_array_equal(r[pre + "front_inds"],
                                      want["front_inds"])
        np.testing.assert_array_equal(r[pre + "front_new"], want["front_new"])
        np.testing.assert_array_equal(r[pre + "front_grouped"],
                                      want["front_grouped"])
        keys = {k[len(pre) + 3:] for k in r if k.startswith(pre + "bb.")}
        assert keys == {k[3:] for k in want if k.startswith("bb.")}
        np.testing.assert_array_equal(r[pre + "bb.sa1_inds"],
                                      want["bb.sa1_inds"])
        for k in keys:
            np.testing.assert_allclose(r[pre + "bb." + k], want["bb." + k],
                                       atol=BB_ATOL, rtol=0, err_msg=k)


# ------------------------------------------------ merges in one process


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("nsample", [2, 8])
def test_ball_query_merge_equals_dense(w, nsample):
    xyz, centers = map(torch.from_numpy, merge_cases())
    got = ball_query_emulated(0.5, nsample, xyz, centers, w)
    want = ball_query(0.5, nsample, xyz, centers)
    assert torch.equal(got, want)
    assert (got[0, 2] == 0).all()  # the empty ball
    assert torch.unique(got[0, 1]).numel() == min(nsample, 4)


@pytest.mark.parametrize("w", [2, 4])
def test_fps_step_ties_and_invalid_rows_equal_dense(w):
    xyz = torch.from_numpy(fps_cases())
    want = furthest_point_sample(xyz, 24)
    for got in fps_emulated(xyz, w, 24):
        assert torch.equal(got, want)
    assert (want[1] == 0).all()  # an all-invalid row picks 0 everywhere


@pytest.mark.parametrize("w", [2, 4])
def test_fps_and_ball_query_on_the_jax_cloud(inputs, w):
    """The emulated ranks on the JAX tests' cloud equal the dense ops."""
    xyz = torch.from_numpy(inputs["xyz"])
    for got in fps_emulated(xyz, w, NPOINT):
        assert torch.equal(got, furthest_point_sample(xyz, NPOINT))
    centers = torch.from_numpy(inputs["centers"])
    for radius, nsample in ((RADIUS, NSAMPLE), (2.0, 32)):
        assert torch.equal(
            ball_query_emulated(radius, nsample, xyz, centers, w),
            ball_query(radius, nsample, xyz, centers))
