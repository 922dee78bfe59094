"""The plain versions behind the redesigned FPS and row-gather kernels,
against the JAX package on the CPU.

On the card the FPS kernels (one block a row, or one thread-block cluster
a row) are held to ``fps_plain`` and the row gather (with its optional
per-centre subtrahend) to ``group_points_plain``; this file pins those
plain versions to ``vlp3d.ops`` on the clouds where a kernel that splits a
row over blocks is most likely to go wrong: equal distances in two halves
of a row, zero tails longer than a block's share, rows with no or one
valid point, row lengths that no block x thread grid divides, and batch
sizes that do not fill a chunk. The same seeded numpy inputs go through
both packages. FPS indices must be equal (XLA path, and the Pallas kernel
in interpret mode); the gather minus its subtrahend is exact; its two
gradients agree with ``jax.grad`` within 1e-6; ``SAModule`` keeps the
tolerances of tests/test_torch_modules.py (atol 1e-4 / rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_modules import (
    close,
    flax_run,
    flax_train,
    grads_close,
    port,
    stats_close,
)
from vlp3d import ops as jops
from vlp3d.models.layers import SAModule as JSA
from vlp3d_torch import convert, ops
from vlp3d_torch.models.layers import SAModule
from vlp3d_torch.ops.grouping import group_points_plain
from vlp3d_torch.ops.sampling import _fps_plan, fps_plain

GRAD_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(seed, b, n):
    return np.random.default_rng(seed).uniform(
        -2.0, 2.0, size=(b, n, 3)).astype(np.float32)


def _adversarial(name):
    """(xyz (B, N, 3), npoint) of one trouble spot."""
    if name == "duplicated_halves":
        xyz = _cloud(1, 2, 256)
        xyz[:, 128:] = xyz[:, :128]
        return xyz, 64
    if name == "few_distinct_points":
        return np.tile(_cloud(2, 2, 5), (1, 40, 1)), 16
    if name == "long_zero_tail":
        xyz = _cloud(3, 2, 256)
        xyz[:, 64:] = 0.0  # longer than a 16th (and a half) of the row
        return xyz, 48
    if name == "all_zero_row":
        xyz = _cloud(4, 3, 128)
        xyz[1] = 0.0
        return xyz, 24
    if name == "one_valid_point":
        xyz = _cloud(5, 2, 128)
        xyz[0] = 0.0
        xyz[0, 77] = 1.5
        return xyz, 12
    if name == "n33":
        return _cloud(6, 2, 33), 20
    if name == "n1000":
        return _cloud(7, 2, 1000), 40
    if name == "npoint_1":
        return _cloud(8, 2, 128), 1
    if name == "npoint_above_valid":
        xyz = _cloud(9, 2, 33)
        xyz[:, 10:] = 0.0
        return xyz, 20
    b = {"b1": 1, "b3": 3, "b9": 9}[name]
    xyz = _cloud(10 + b, b, 160)
    xyz[:, -12:] = 0.0
    xyz[:, 7] = xyz[:, 3]
    return xyz, 24


FPS_CASES = ["duplicated_halves", "few_distinct_points", "long_zero_tail",
             "all_zero_row", "one_valid_point", "n33", "n1000", "npoint_1",
             "npoint_above_valid", "b1", "b3", "b9"]


@pytest.mark.parametrize("name", FPS_CASES)
def test_fps_plain_matches_jax_xla(name):
    xyz, npoint = _adversarial(name)
    got = fps_plain(t(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == (xyz.shape[0], npoint)
    want = np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), npoint,
                                                 impl="xla"))
    np.testing.assert_array_equal(got.numpy(), want)
    # the public entry takes the same route for a CPU tensor
    np.testing.assert_array_equal(
        ops.furthest_point_sample(t(xyz), npoint).numpy(), want)
    valid = (xyz ** 2).sum(-1) > 1e-3
    for row, ok in zip(got.numpy(), valid):
        if not ok.any():
            assert (row == 0).all()
        else:  # index 0 first, then only valid points
            assert row[0] == 0 and ok[row[1:]].all()


@pytest.mark.parametrize("name", FPS_CASES)
def test_fps_plain_matches_pallas_interpret(name):
    xyz, npoint = _adversarial(name)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), npoint,
                                                     impl="pallas"))
    np.testing.assert_array_equal(fps_plain(t(xyz), npoint).numpy(), want)


def test_fps_ties_in_two_halves_pick_the_lower_index():
    xyz, npoint = _adversarial("duplicated_halves")
    got = fps_plain(t(xyz), npoint).numpy()
    # every point has an exact twin 128 further on: the twin never wins
    assert (got < 128).all()


@pytest.mark.parametrize("n,plan", [
    (33, (1, 2)), (512, (1, 2)), (1000, (1, 2)), (1024, (1, 2)),
    (2048, (1, 4)), (4096, (1, 8)), (4097, (16, 2)), (40960, (16, 8)),
    (65536, (16, 8)), (131072, (16, 16)), (131073, None), (1 << 18, None)])
def test_fps_plan_fits_the_kernel(n, plan):
    """The row length alone picks the kernel, and what it picks fits the
    limits csrc/fps.cu states: 2, 4, 8, 16 or 32 points a thread, at most
    1024 threads up to 4 points a thread, 512 up to 16, 256 at 32, and at
    most 16 blocks a cluster."""
    assert _fps_plan(n) == plan
    if plan is None:
        return
    blocks, points = plan
    share = -(-n // blocks)
    threads = 32 * -(-share // (32 * points))
    assert points in (2, 4, 8, 16, 32) and blocks in (1, 16)
    assert threads <= (1024 if points <= 4 else 512 if points <= 16 else 256)
    assert threads * points >= share


# (b, n, c, m, k): odd widths, 16-byte rows, the SA1 training width
SUB_SHAPES = [(2, 50, 3, 7, 1), (2, 50, 5, 7, 3), (3, 64, 12, 9, 4),
              (2, 128, 135, 16, 8), (1, 32, 64, 8, 16)]


def _sub_inputs(b, n, c, m, k):
    rng = np.random.default_rng(b * 1000 + n + c)
    points = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    idx[:, ::3] = idx[:, ::3, :1]  # padded neighbourhoods: one row K times
    sub = rng.normal(size=(b, m, c)).astype(np.float32)
    cot = rng.normal(size=(b, m, k, c)).astype(np.float32)
    return points, idx, sub, cot


@pytest.mark.parametrize("b,n,c,m,k", SUB_SHAPES)
def test_group_points_with_subtrahend_is_exact(b, n, c, m, k):
    points, idx, sub, _ = _sub_inputs(b, n, c, m, k)
    want = np.asarray(jops.group_points(jnp.asarray(points), jnp.asarray(idx))
                      - jnp.asarray(sub)[:, :, None, :])
    got = ops.group_points(t(points), t(idx), t(sub))
    assert got.shape == (b, m, k, c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        group_points_plain(t(points), t(idx), t(sub)).numpy(), want)
    # the two-op form it replaces, bit for bit
    two = ops.group_points(t(points), t(idx)) - t(sub)[:, :, None, :]
    assert torch.equal(got, two)
    # int64 indices and a strided subtrahend are taken as they are
    wide = t(np.concatenate([sub, sub], -1))
    assert torch.equal(
        ops.group_points(t(points), t(idx).long(), wide[..., :c]), got)


@pytest.mark.parametrize("b,n,c,m,k", SUB_SHAPES)
def test_group_points_with_subtrahend_gradients_match_jax(b, n, c, m, k):
    points, idx, sub, cot = _sub_inputs(b, n, c, m, k)
    gp, gs = jax.grad(
        lambda p, s: jnp.sum((jops.group_points(p, jnp.asarray(idx))
                              - s[:, :, None, :]) * cot), argnums=(0, 1)
    )(jnp.asarray(points), jnp.asarray(sub))
    p = t(points).requires_grad_(True)
    s = t(sub).requires_grad_(True)
    ops.group_points(p, t(idx), s).backward(t(cot))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **GRAD_TOL)
    # K cotangent rows sum into one centre row, in another order than XLA's
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), rtol=1e-6,
                               atol=1e-6 * k)
    np.testing.assert_allclose(s.grad.numpy(), -cot.sum(axis=2), rtol=1e-6,
                               atol=1e-6 * k)


def test_group_points_subtrahend_alone_may_need_the_gradient():
    points, idx, sub, cot = _sub_inputs(2, 50, 5, 7, 3)
    s = t(sub).requires_grad_(True)
    out = ops.group_points(t(points), t(idx), s)
    assert out.requires_grad
    out.backward(t(cot))
    np.testing.assert_allclose(s.grad.numpy(), -cot.sum(axis=2), **GRAD_TOL)
    assert not ops.group_points(t(points), t(idx), t(sub)).requires_grad


def test_query_and_group_recentres_inside_the_gather():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-1, 1, size=(2, 120, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 120, 5)).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, :20])
    got, gxyz = ops.query_and_group(0.5, 8, t(xyz), t(xyz)[:, :20], t(feats))
    want, wxyz = jops.query_and_group(0.5, 8, jnp.asarray(xyz),
                                      jnp.asarray(new_xyz),
                                      jnp.asarray(feats))
    np.testing.assert_array_equal(gxyz.numpy(), np.asarray(wxyz))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("channels,radius", [(7, 0.4), (1, 0.25), (12, 1.0)])
def test_sa_module_eval_parity_with_the_fused_centre_term(channels, radius):
    rng = np.random.default_rng(30 + channels)
    xyz = rng.uniform(0, 2, (2, 128, 3)).astype(np.float32)
    xyz[:, -6:] = 0.0  # padding: never sampled, empty balls repeat a row
    feats = rng.normal(size=(2, 128, channels)).astype(np.float32)
    p, s, (jxyz, jf, jinds) = flax_run(JSA(32, radius, 8, [16, 16, 32]), xyz,
                                       feats)
    m = port(SAModule(32, radius, 8, [16, 16, 32], channels, device="cpu"),
             convert.convert_sa, p, s)
    new_xyz, f, inds = m(t(xyz), t(feats))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))
    close(new_xyz, jxyz)
    close(f, jf)


@pytest.mark.parametrize("channels", [1, 12])
def test_sa_module_train_parity_with_the_fused_centre_term(channels):
    rng = np.random.default_rng(40 + channels)
    xyz = rng.uniform(0, 2, (2, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 128, channels)).astype(np.float32)
    p, s, (jxyz, jf, jinds), new, gp, gargs = flax_train(
        JSA(32, 0.3, 8, [16, 16, 32]), (xyz, feats),
        lambda out: jnp.sum(out[1] ** 2) + jnp.sum(out[0]), 2, train=True)
    m = port(SAModule(32, 0.3, 8, [16, 16, 32], channels, device="cpu"),
             convert.convert_sa, p, s).train()
    txyz = t(xyz).requires_grad_(True)
    tf = t(feats).requires_grad_(True)
    new_xyz, f, inds = m(txyz, tf)
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))
    close(new_xyz, jxyz)
    close(f, jf)
    ((f ** 2).sum() + new_xyz.sum()).backward()
    grads_close(m, convert.convert_sa, gp, s)
    stats_close(m, convert.convert_sa, p, new)
    want = np.asarray(gargs[0])
    np.testing.assert_allclose(
        txyz.grad.numpy(), want, rtol=1e-4,
        atol=1e-5 * max(1.0, float(np.abs(want).max())))
    want = np.asarray(gargs[1])
    np.testing.assert_allclose(
        tf.grad.numpy(), want, rtol=1e-4,
        atol=1e-5 * max(1.0, float(np.abs(want).max())))
