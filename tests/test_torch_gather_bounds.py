"""Out-of-range indices to the row gather: the port's plain path against
the JAX package, forward and gradient.

JAX's ``gather_points`` reads row i + N of its own batch row for an index
i in [-N, 0), gives a row of NaN for any other index outside [0, N), and
passes a gradient only to indices in [0, N) (``segment_sum`` drops the
rest). The port follows that rule in ``gather_points`` and
``group_points``; the card's kernels are held to the same plain path by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``. JAX's
``group_points`` follows it too where ``_grouped_row_gather`` gathers
each batch row alone (one batch row, or two of 2^17 rows), but where it
flattens several batch rows into one table of under 2^18 rows, an
out-of-range index reads a row of another batch row: the port does not
copy that (ROADMAP.md C4), and
:func:`test_jax_group_points_crosses_batch_rows_on_a_small_batched_table`
pins the difference. The indices are in range, -1, -N, N and -N - 1, on
one batch row of 4, two of 4 and two of 2^17.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp3d.ops.grouping import gather_points as jax_gather_points
from vlp3d.ops.grouping import group_points as jax_group_points
from vlp3d_torch.ops import gather_points, group_points
from vlp3d_torch.ops.grouping import (
    group_points_grad_plain,
    group_points_plain,
)

# gradients: the same few rows summed in another order
GRAD_TOL = dict(rtol=1e-6, atol=1e-6)


def _case(size):
    """(points (B, N, C) f32, idx (B, R) i32): every index kind in each
    batch row, in-range ones included."""
    rng = np.random.default_rng(5)
    b, n, c = {"small": (1, 4, 3), "batched": (2, 4, 3),
               "large": (2, 1 << 17, 3)}[size]
    points = rng.normal(size=(b, n, c)).astype(np.float32)
    kinds = [0, 5 if n == 4 else n + 5, -1, -5 if n == 4 else -n - 5, 3,
             -n, n, -n - 1, n - 1, 1, -2]
    idx = np.array([kinds + list(rng.integers(0, n, 5))
                    for _ in range(b)], np.int32)
    return points, idx


def _jax(op, points, idx, cot):
    """JAX forward and the gradient of <out, cot> with respect to points."""
    fn = {"gather": lambda p: jax_gather_points(p, jnp.asarray(idx)),
          "group": lambda p: jax_group_points(p, jnp.asarray(idx)[:, :, None])
          }[op]
    out, vjp = jax.vjp(fn, jnp.asarray(points))
    (grad,) = vjp(jnp.asarray(cot).reshape(out.shape))
    return np.asarray(out), np.asarray(grad)


def _port(op, points, idx, cot):
    p = torch.from_numpy(points).requires_grad_()
    ix = torch.from_numpy(idx)
    out = gather_points(p, ix) if op == "gather" else group_points(
        p, ix[:, :, None])
    out.backward(torch.from_numpy(cot).reshape(out.shape))
    return out.detach().numpy(), p.grad.numpy()


@pytest.mark.parametrize("size", ["small", "batched", "large"])
@pytest.mark.parametrize("op", ["gather", "group"])
def test_out_of_range_indices_follow_jax(op, size):
    points, idx = _case(size)
    b, n, c = points.shape
    cot = np.random.default_rng(6).normal(
        size=idx.shape + (c,)).astype(np.float32)
    want, want_grad = _jax(op, points, idx, cot)
    if op == "group" and size == "batched":
        # JAX's forward crosses batch rows here (the test below): hold the
        # port to it on each batch row alone
        want = np.concatenate([
            _jax(op, points[i:i + 1], idx[i:i + 1], cot[i:i + 1])[0]
            for i in range(b)])
    got, got_grad = _port(op, points, idx, cot)
    got = got.reshape(want.shape)
    np.testing.assert_array_equal(got, want)  # NaN rows where JAX has them
    nan_rows = np.isnan(want).all(-1).reshape(b, -1)
    np.testing.assert_array_equal(nan_rows, (idx >= n) | (idx < -n))
    wrapped = (idx < 0) & (idx >= -n)
    np.testing.assert_array_equal(
        got.reshape(b, -1, c)[wrapped],
        points[np.nonzero(wrapped)[0], idx[wrapped] + n])
    np.testing.assert_allclose(got_grad, want_grad, **GRAD_TOL)
    # only rows that an index in [0, N) names get a gradient
    named = np.zeros((b, n), bool)
    for bi in range(b):
        named[bi, idx[bi][(idx[bi] >= 0) & (idx[bi] < n)]] = True
    assert not got_grad[~named].any()


@pytest.mark.parametrize("size", ["small", "batched", "large"])
def test_plain_backward_drops_what_jax_drops(size):
    """group_points_grad_plain, which the card's backward kernels are
    held to, equals JAX's gradient on the same indices: a negative index
    is dropped, not wrapped."""
    points, idx = _case(size)
    c = points.shape[-1]
    cot = np.random.default_rng(7).normal(
        size=idx.shape + (c,)).astype(np.float32)
    _, want_grad = _jax("gather", points, idx, cot)
    got = group_points_grad_plain(torch.from_numpy(cot),
                                  torch.from_numpy(idx), points.shape[1])
    np.testing.assert_allclose(got.numpy(), want_grad, **GRAD_TOL)


def test_jax_group_points_crosses_batch_rows_on_a_small_batched_table():
    """JAX's group_points on B = 2 rows of N = 4 gathers from one (B * N, C)
    table at idx + b * N, so an index outside [0, N) reads a row of the
    other batch row (or NaN only past the whole table). The port gives
    gather_points' per-row rule instead: equal to JAX at every index in
    [0, N), different at the ones that cross."""
    points, idx = _case("batched")
    b, n, c = points.shape
    want = np.asarray(jax_group_points(
        jnp.asarray(points), jnp.asarray(idx)[:, :, None]))[:, :, 0]
    flat = idx + np.arange(b)[:, None] * n
    flat = np.where(flat < 0, flat + b * n, flat)
    inside = (flat >= 0) & (flat < b * n)
    crossed = np.where(inside[..., None],
                       points.reshape(b * n, c)[np.where(inside, flat, 0)],
                       np.nan)
    np.testing.assert_array_equal(want, crossed)
    got = group_points(torch.from_numpy(points),
                       torch.from_numpy(idx)[:, :, None])[:, :, 0].numpy()
    live = (idx >= 0) & (idx < n)
    np.testing.assert_array_equal(got[live], want[live])
    differs = ~np.isclose(got, want, equal_nan=True).all(-1)
    assert differs[~live].any() and not differs[live].any()


def test_subtrahend_keeps_a_nan_row_nan():
    points, idx = _case("small")
    ix = torch.from_numpy(idx).reshape(1, -1, 1)
    sub = torch.randn(1, ix.shape[1], 3)
    got = group_points_plain(torch.from_numpy(points), ix, sub)[:, :, 0]
    want = group_points_plain(torch.from_numpy(points), ix)[:, :, 0] - sub
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert torch.isnan(got[0, 1]).all()
