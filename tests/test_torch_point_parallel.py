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

The FPS loop's plain steps (one candidate a rank a row, the loop
kernel's layout) and the ball-query merge are also held, in one process
over stacked per-shard outputs (the ranks emulated in turn), against the
dense ops on the whole cloud and against JAX's ``fps_sharded`` on point
meshes of 1, 2 and 4 devices, on the cases where a merge can go wrong:
all hits in one shard, hits across shards, an empty ball, ties across
shards, an all-invalid row. The FPS route of a group whose ranks are on
two hosts, see only their own cards or whose cards cannot reach each
other as peers is the collective one (ROADMAP C22), of a full peer group
the peer one, with the capability mocked.
"""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_distributed import run_ranks
from torch_point_cases import fps_cases, merge_cases, wide_merge_cases
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
from vlp3d_torch.parallel import point_parallel as pp
from vlp3d_torch.parallel.point_parallel import (
    ball_query_emulated,
    fps_emulated,
)
from vlp3d_torch.parallel.tensor_parallel import ModelGroup

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


@pytest.mark.parametrize("w", [33, 64])
@pytest.mark.parametrize("nsample", [8, 64])
def test_ball_query_merge_past_32_shards_equals_dense(w, nsample):
    """The merge over more shards than a warp's lanes: hits in every
    shard, only past the first 32, across shards 31 and 32, none."""
    xyz, centers = map(torch.from_numpy, wide_merge_cases(w))
    got = ball_query_emulated(0.5, nsample, xyz, centers, w)
    assert torch.equal(got, ball_query(0.5, nsample, xyz, centers))
    assert (got[0, 3] == 0).all()
    assert got[0, 0, :w].tolist() == (8 * np.arange(w) + 3)[:nsample].tolist()
    assert int(got[0, 1, 0]) == 8 * 32 + 5


def test_fps_steps_past_32_ranks_equal_dense():
    """The collective route's step takes the winner among more candidates
    than a warp's lanes: 33 emulated ranks of 8 points, ties across the
    shards (every shard the same points) and an all-invalid row."""
    xyz = torch.zeros((2, 33 * 8, 3))
    xyz[0] = torch.from_numpy(np.tile(np.random.default_rng(6)
                                      .standard_normal((8, 3)), (33, 1)))
    want = furthest_point_sample(xyz, 40)
    for got in fps_emulated(xyz, 33, 40, route="collective"):
        assert torch.equal(got, want)
    assert (want[1] == 0).all()


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


@pytest.fixture(scope="module")
def jax_fps_meshes(inputs):
    """JAX's fps_sharded on point meshes of 1, 2 and 4 devices, on
    tests/torch_point_cases.py's ties and all-invalid row (24 centres) and
    on the JAX tests' cloud (NPOINT centres)."""
    out = {}
    for w in (1, 2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:w]), (POINT_AXIS,))
        for name, cloud, npoint in (("cases", fps_cases(), 24),
                                    ("cloud", inputs["xyz"], NPOINT)):
            fn = jax.jit(shard_map(
                lambda a, npoint=npoint: jax_fps_sharded(a, npoint),
                mesh=mesh, in_specs=P(None, POINT_AXIS, None),
                out_specs=P()))
            out[w, name] = np.asarray(fn(jnp.asarray(cloud)))
    return out


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("name", ["cases", "cloud"])
def test_fps_plain_loop_equals_jax_fps_sharded(inputs, jax_fps_meshes, w,
                                               name):
    """The plain loop, one candidate a rank a row, on every emulated rank
    against JAX's fps_sharded over w devices: ties across the shards and
    an all-invalid row included."""
    cloud, npoint = ((fps_cases(), 24) if name == "cases"
                     else (inputs["xyz"], NPOINT))
    want = jax_fps_meshes[w, name]
    for got in fps_emulated(torch.from_numpy(cloud), w, npoint):
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "cases":
        assert (want[1] == 0).all()


def test_fps_step_plain_offers_one_candidate_a_rank():
    """A step's candidate is the slab's largest running distance at its
    lowest local index, plus the slab's offset, with its coordinates; an
    invalid point offers -1."""
    xyz = torch.tensor([[[1.0, 0, 0], [0, 0, 0], [3.0, 0, 0], [3.0, 0, 0]]])
    temp = torch.full((1, 4), 1e10)
    out = torch.zeros((1, 2), dtype=torch.int32)
    seed = pp._seed(torch.tensor([[[0.5, 0, 0]]]), 0)
    cand = pp.fps_shard_step_plain(xyz, temp, seed, 8, 0, False, out)
    assert cand.shape == (1, 1, 5) and out[0, 0] == 0
    assert cand[0, 0, 1] == 8 + 2  # the first of the tied points
    assert cand.view(torch.float32)[0, 0, 0] == 2.5 ** 2
    assert torch.equal(cand.view(torch.float32)[0, 0, 2:5],
                       torch.tensor([3.0, 0, 0]))
    assert temp[0, 1] == 0.25  # the invalid point's distance is kept ...
    empty = pp._seed(xyz, 1)  # ... but it offers -1, below a seed of rank 1
    both = torch.cat([empty, cand])
    assert pp.fps_shard_step_plain(xyz, temp, both, 8, 1, True, out) is None
    assert out[0, 1] == 10


BUS = ["0000:18:00.0", "0000:2a:00.0"]  # the two cards' PCI bus ids


def _peers(monkeypatch, hosts, reach, visible=2):
    """Mock a two-rank group: rank r on the card of bus id BUS[r] of host
    hosts[r], card a reaching card b as a peer where reach[a][b]; with
    ``visible`` 1 each rank sees its own card alone, as cuda:0."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: reach[a][b])
    monkeypatch.setattr(pp, "_bus_id", lambda d: BUS[d])
    monkeypatch.setattr(pp.socket, "gethostname", lambda: hosts[0])
    if visible == 2:
        other = {"host": hosts[1], "device": 1, "card": BUS[1],
                 "reach": {BUS[0]: reach[1][0], BUS[1]: True}}
    else:
        other = {"host": hosts[1], "device": 0, "card": BUS[1],
                 "reach": {BUS[1]: True}}
    monkeypatch.setattr(pp, "_gather_objects",
                        lambda obj, point: [obj, other])
    monkeypatch.setattr(pp, "_EXCHANGES", {})

    def no_buffer(*a, **k):
        raise AssertionError("the set-up allocated before its check")

    monkeypatch.setattr(torch, "zeros", no_buffer)
    return ModelGroup(object(), 0, 2)


@pytest.mark.parametrize("reach,pair", [
    ([[True, False], [True, True]], f"rank 0 (cuda:0, {BUS[0]}) cannot "
                                    f"access rank 1's card ({BUS[1]})"),
    ([[True, True], [False, True]], f"rank 1 (cuda:1, {BUS[1]}) cannot "
                                    f"access rank 0's card ({BUS[0]})")])
def test_exchange_routes_a_group_without_peer_access_over_nccl(monkeypatch,
                                                               reach, pair):
    point = _peers(monkeypatch, ["h", "h"], reach)
    ex = pp._exchange(point, 2, torch.device("cuda", 0))
    assert ex.route == "collective" and pair in ex.why


def test_exchange_routes_ranks_that_see_only_their_own_card_over_nccl(
        monkeypatch):
    """Two ranks that each see one card as cuda:0 (CUDA_VISIBLE_DEVICES):
    the ordinals agree, the cards do not, and neither rank can ask whether
    it reaches the other's, so the group takes the collective route,
    allocating nothing for it."""
    point = _peers(monkeypatch, ["h", "h"], [[True, True], [True, True]],
                   visible=1)
    ex = pp._exchange(point, 2, torch.device("cuda", 0))
    assert ex.route == "collective"
    assert f"rank 0 (cuda:0, {BUS[0]}) does not see rank 1's card " \
           f"({BUS[1]})" in ex.why


def test_peer_group_of_one_card_seen_by_both_ranks_passes():
    """Two ranks on one card (the same bus id) reach each other."""
    me = {"host": "h", "device": 0, "card": BUS[0], "reach": {BUS[0]: True}}
    assert pp.check_peer_group([me, dict(me)]) is None


def test_exchange_routes_a_group_across_hosts_over_nccl(monkeypatch):
    point = _peers(monkeypatch, ["node-a", "node-b"],
                   [[True, True], [True, True]])
    ex = pp._exchange(point, 2, torch.device("cuda", 0))
    assert ex.route == "collective"
    assert "rank 0 is on 'node-a', rank 1 on 'node-b'" in ex.why


def test_exchange_takes_the_peer_route_for_a_full_peer_group(monkeypatch):
    """Two ranks of one host whose cards reach each other take the peer
    route: its buffers are set up (here a stand-in records the call), once
    a group and batch size; a forced collective route skips the check, a
    forced peer route takes it."""
    point = _peers(monkeypatch, ["h", "h"], [[True, True], [True, True]])
    made = []
    monkeypatch.setattr(pp, "_Exchange", lambda *a: made.append(a) or
                        type("Peer", (), {"route": "peer", "why": a[-1]})())
    dev = torch.device("cuda", 0)
    ex = pp._exchange(point, 2, dev)
    assert ex.route == "peer" and ex.why == "every card a peer"
    assert pp._exchange(point, 2, dev) is ex and len(made) == 1
    assert pp._exchange(point, 2, dev, "collective").route == "collective"
    forced = pp._exchange(point, 2, dev, "peer")
    assert forced.route == "peer"
    assert forced.why == "forced (every card a peer)"
    assert pp.fps_route(ModelGroup(object(), 0, 33), dev)[0] == "collective"
    assert pp.fps_route(ModelGroup(), dev) == ("peer", "a group of one")


@pytest.mark.parametrize("hosts,reach,visible,why", [
    (["h", "h"], [[True, False], [True, True]], 2, "cannot access"),
    (["h", "h"], [[True, True], [True, True]], 1, "does not see"),
    (["node-a", "node-b"], [[True, True], [True, True]], 2, "is on")])
def test_forcing_the_peer_route_on_a_group_that_cannot_take_it_raises(
        monkeypatch, hosts, reach, visible, why):
    """A forced peer route is refused, with the group's reason and before
    any buffer is allocated (``_peers`` traps ``torch.zeros``), where the
    verdict is the collective route; so is a group past the loop kernel's
    LOOP_MAX_RANKS."""
    point = _peers(monkeypatch, hosts, reach, visible)
    dev = torch.device("cuda", 0)
    with pytest.raises(ValueError,
                       match=f"peer route was forced, but .*{why}"):
        pp._exchange(point, 2, dev, "peer")
    assert not pp._EXCHANGES
    big = ModelGroup(object(), 0, pp.LOOP_MAX_RANKS + 1)
    with pytest.raises(ValueError, match="past the loop kernel's 32"):
        pp._exchange(big, 2, dev, "peer")


def test_cuda_tensors_take_the_loop_kernel_never_the_plain_loop(monkeypatch):
    """The dispatch: a tensor the wrappers call CUDA goes to the loop
    kernel, whatever the group; only a CPU tensor takes the plain loop."""
    calls = []
    monkeypatch.setattr(pp._kernels, "cuda_or_cpu", lambda t: True)
    monkeypatch.setattr(pp, "_fps_loop_cuda",
                        lambda xyz, npoint, point, route: calls.append(
                            (point.world, route)))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain loop")

    monkeypatch.setattr(pp, "fps_sharded_plain", plain)
    xyz = torch.rand(1, 8, 3)
    pp.fps_sharded(xyz, 4)
    pp.fps_sharded(xyz, 4, ModelGroup(object(), 1, 2))
    pp.fps_sharded(xyz, 4, ModelGroup(object(), 1, 2), route="collective")
    assert calls == [(1, None), (2, None), (2, "collective")]
    with pytest.raises(ValueError, match="route"):
        pp.fps_sharded(xyz, 4, route="nccl")


def test_loop_plan_and_exchange_layout():
    """The loop kernel runs a cluster of at least two blocks (the dense
    FPS's plan for long slabs), each thread at most 512 a block; a share
    past registers streams (0 points a thread), however long the slab;
    one rank's exchange buffer is two 48-byte candidate slots a (row,
    rank)."""
    assert pp.loop_plan(40960) == (16, 8)
    assert pp.loop_plan(10240) == (16, 2)
    assert pp.loop_plan(16) == (2, 2)
    assert pp.loop_plan(40960, 8) == (8, 16)
    assert pp.loop_plan(20480, 4) == (4, 16)
    assert pp.loop_plan(131072) == (16, 16)
    assert pp.loop_plan(131073) == (16, 0)
    assert pp.loop_plan(1 << 20) == (16, 0)
    assert pp.loop_plan(40960, 4) == (4, 0)
    assert pp.exchange_words(8, 4) == 2 * 8 * 4 * 48 // 8
    assert pp.exchange_words(1, 3) == 2 * 3 * 48 // 8
