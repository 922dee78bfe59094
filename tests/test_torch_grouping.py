"""vlp3d_torch.ops.grouping against vlp3d.ops.grouping, on the CPU.

The same seeded numpy tables and indices go through ``group_points`` /
``gather_points`` of both packages. Indices collide on purpose (padded
neighbourhoods repeat one row K times). The forward is a copy and must be
exact; the gradient with respect to the table must agree with ``jax.grad``
through the JAX op within 1e-6 (both sum the colliding rows in float32, in
different orders). On the CPU the port runs its plain version
(``torch.gather``), and ``group_points_grad_plain`` (``index_add_``), the
yardstick the CUDA backward kernel is held to on the card, is checked
against the same gradients here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp3d import ops as jops
from vlp3d_torch import ops
from vlp3d_torch.ops.grouping import (
    group_points_grad_plain,
    group_points_plain,
)

GRAD_TOL = dict(rtol=1e-6, atol=1e-6)
# (b, n, c, m, k)
SHAPES = [(2, 50, 3, 7, 1), (2, 50, 5, 7, 3), (3, 64, 12, 9, 4),
          (2, 128, 135, 16, 8), (1, 32, 64, 8, 16)]


def _inputs(b, n, c, m, k):
    rng = np.random.default_rng(b * 1000 + n + c)
    points = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    idx[:, ::3] = idx[:, ::3, :1]  # every third neighbourhood: one row K times
    cot = rng.normal(size=(b, m, k, c)).astype(np.float32)
    return points, idx, cot


@pytest.mark.parametrize("b,n,c,m,k", SHAPES)
def test_group_points_forward_is_exact(b, n, c, m, k):
    points, idx, _ = _inputs(b, n, c, m, k)
    want = np.asarray(jops.group_points(jnp.asarray(points), jnp.asarray(idx)))
    got = ops.group_points(torch.from_numpy(points), torch.from_numpy(idx))
    assert got.shape == (b, m, k, c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        group_points_plain(torch.from_numpy(points),
                           torch.from_numpy(idx).reshape(b, m * k)).numpy(),
        want.reshape(b, m * k, c))


@pytest.mark.parametrize("b,n,c,m,k", SHAPES)
def test_group_points_gradient_matches_jax(b, n, c, m, k):
    points, idx, cot = _inputs(b, n, c, m, k)
    want = np.asarray(jax.grad(
        lambda p: jnp.sum(jops.group_points(p, jnp.asarray(idx)) * cot)
    )(jnp.asarray(points)))
    p = torch.from_numpy(points).requires_grad_(True)
    ops.group_points(p, torch.from_numpy(idx)).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(p.grad.numpy(), want, **GRAD_TOL)
    plain = group_points_grad_plain(
        torch.from_numpy(cot).reshape(b, m * k, c),
        torch.from_numpy(idx).reshape(b, m * k), n)
    np.testing.assert_allclose(plain.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize("b,n,c,m", [(2, 40, 3, 11), (3, 64, 128, 20)])
def test_gather_points_matches_jax(b, n, c, m):
    points, idx, cot = _inputs(b, n, c, m, 1)
    idx, cot = idx[:, :, 0], cot[:, :, 0]
    idx[:, 1] = idx[:, 0]  # a collision
    want = np.asarray(jops.gather_points(jnp.asarray(points),
                                         jnp.asarray(idx)))
    want_grad = np.asarray(jax.grad(
        lambda p: jnp.sum(jops.gather_points(p, jnp.asarray(idx)) * cot)
    )(jnp.asarray(points)))
    p = torch.from_numpy(points).requires_grad_(True)
    got = ops.gather_points(p, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(p.grad.numpy(), want_grad, **GRAD_TOL)


def test_group_points_takes_strided_tables_and_int64_indices():
    points, idx, _ = _inputs(2, 50, 12, 7, 3)
    wide = torch.from_numpy(points)
    view = wide[..., 2:9]  # a channel slice, rows 12 floats apart
    want = np.asarray(jops.group_points(jnp.asarray(points[..., 2:9]),
                                        jnp.asarray(idx)))
    np.testing.assert_array_equal(
        ops.group_points(view, torch.from_numpy(idx)).numpy(), want)
    np.testing.assert_array_equal(
        ops.group_points(view, torch.from_numpy(idx).long()).numpy(), want)


def test_indices_carry_no_gradient_and_cpu_launches_no_kernel():
    points, idx, _ = _inputs(2, 50, 5, 7, 3)
    ops.reset_launches()
    p = torch.from_numpy(points).requires_grad_(True)
    out = ops.group_points(p, torch.from_numpy(idx))
    out.sum().backward()
    # every source row's gradient is the number of slots that read it
    counts = np.zeros((2, 50), np.float32)
    for bi in range(2):
        np.add.at(counts[bi], idx[bi].reshape(-1), 1.0)
    np.testing.assert_array_equal(p.grad.numpy(),
                                  np.repeat(counts[..., None], 5, axis=-1))
    assert ops.launches["group_points"] == 0
    assert ops.launches["group_points_grad"] == 0


def test_group_points_on_another_device_raises():
    meta = torch.empty(1, 64, 3, device="meta")
    idx = torch.zeros(1, 4, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.group_points(meta, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.gather_points(meta, idx[:, :, 0])


def test_interpolation_gradient_reaches_only_the_known_features():
    from vlp3d.ops.interpolate import interpolate_features as jinterp

    rng = np.random.default_rng(3)
    unknown = rng.normal(size=(2, 20, 3)).astype(np.float32)
    known = rng.normal(size=(2, 8, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 8, 6)).astype(np.float32)
    cot = rng.normal(size=(2, 20, 6)).astype(np.float32)
    gu, gk, gf = jax.grad(
        lambda u, kn, f: jnp.sum(jinterp(u, kn, f) * cot), argnums=(0, 1, 2)
    )(jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats))
    assert not np.asarray(gu).any() and not np.asarray(gk).any()
    u = torch.from_numpy(unknown).requires_grad_(True)
    kn = torch.from_numpy(known).requires_grad_(True)
    f = torch.from_numpy(feats).requires_grad_(True)
    ops.interpolate_features(u, kn, f).backward(torch.from_numpy(cot))
    assert u.grad is None and kn.grad is None
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf), rtol=1e-5,
                               atol=1e-6)
