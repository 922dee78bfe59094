"""The three-NN team kernel's rule, the fused interpolation and its
weighted backward, on the CPU, against the JAX package.

On the card the team kernel splits a row's known points over L lanes
(lane t scans j = t mod L in ascending j with strict <) and merges the
lanes' top-3 lists in log2(L) butterfly steps under the order (d, then j)
(``csrc/three_nn.cu``). That rule is modelled here in torch for L = 1 to
32 and held equal, index for index, to ``three_nn_plain`` and to
``vlp3d.ops.three_nn`` on the cases of ``tests/torch_three_nn_cases.py``.
The port's ``interpolate_features`` (the plain version, which a CPU
tensor runs) is held within 1e-5 of ``vlp3d.ops.interpolate_features``
and its gradient with respect to the known features within 1e-5 of the
absolute sum meeting in a row of ``jax.vjp``'s; no gradient reaches the
coordinates. The plain weighted backward, which the card's
``three_interpolate_grad_kernel`` is held to, is checked against the
gather's backward on pre-weighted rows and against ``jax.vjp`` of
``three_interpolate``, and equal bit for bit to ``interp_grad_ordered``
(the kernel's exact order, the card tests' reference). The plan
functions are checked against the kernels' limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_three_nn_cases import NN_CASES, interp_grad_ordered, nn_case
from vlp3d import ops as jops
from vlp3d_torch import ops
from vlp3d_torch.ops.grouping import group_points_grad_plain
from vlp3d_torch.ops.interpolate import (
    INTERP_GRAD_PLANS,
    TEAM_PLANS,
    _check_interp_grad_plan,
    _check_team_plan,
    _interp_grad_plan,
    _three_nn_plan,
    interpolate_features_plain,
    interpolation_weights,
    three_interpolate_grad_plain,
    three_nn_plain,
)

LANES = (1, 2, 4, 8, 16, 32)
# gradient: float32 rounding of a reordered sum of the few rows meeting in
# a known row, relative to their absolute sum
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _insert(e, j, top, less):
    """Insert (e, j) into a top-3 list ((d0, i0), (d1, i1), (d2, i2)),
    elementwise, under ``less``."""
    (d0, i0), (d1, i1), (d2, i2) = top
    a = less(e, j, d0, i0)
    b = ~a & less(e, j, d1, i1)
    c = ~a & ~b & less(e, j, d2, i2)
    shift = a | b
    return ((torch.where(a, e, d0), torch.where(a, j, i0)),
            (torch.where(a, d0, torch.where(b, e, d1)),
             torch.where(a, i0, torch.where(b, j, i1))),
            (torch.where(shift, d1, torch.where(c, e, d2)),
             torch.where(shift, i1, torch.where(c, j, i2))))


def _strict(da, ja, db, jb):
    return da < db


def _lex(da, ja, db, jb):
    return (da < db) | ((da == db) & (ja < jb))


def team_three_nn(unknown: torch.Tensor, known: torch.Tensor, lanes: int):
    """The team kernel's rule: lane t scans j = t (mod lanes) in ascending
    j with strict <, from (inf, 0) three times; then butterfly steps of
    distance lanes/2 .. 1 insert the partner's list under (d, j). Returns
    lane 0's (dist2, idx) and checks that every lane holds the same."""
    dx = unknown[:, :, None, 0] - known[:, None, :, 0]
    dy = unknown[:, :, None, 1] - known[:, None, :, 1]
    dz = unknown[:, :, None, 2] - known[:, None, :, 2]
    d = (dx * dx + dy * dy) + dz * dz  # (B, N, M)
    b, n, m = d.shape
    steps = -(-m // lanes)
    # padding never enters a list: strict < against inf
    d = torch.nn.functional.pad(d, (0, steps * lanes - m), value=torch.inf)
    d = d.reshape(b, n, steps, lanes)
    lane = torch.arange(lanes)
    top = tuple((torch.full((b, n, lanes), torch.inf),
                 torch.zeros((b, n, lanes), dtype=torch.long))
                for _ in range(3))
    for s in range(steps):
        j = (s * lanes + lane).expand(b, n, lanes)
        top = _insert(d[:, :, s], j, top, _strict)
    off = lanes // 2
    while off:
        partner = lane ^ off
        theirs = [(dk[..., partner], ik[..., partner]) for dk, ik in top]
        for e, j in theirs:
            top = _insert(e, j, top, _lex)
        off //= 2
    dist = torch.stack([dk for dk, _ in top], -1)  # (B, N, lanes, 3)
    idx = torch.stack([ik for _, ik in top], -1)
    assert torch.equal(idx, idx[:, :, :1].expand_as(idx))
    assert torch.equal(dist, dist[:, :, :1].expand_as(dist))
    return dist[:, :, 0], idx[:, :, 0].to(torch.int32)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", NN_CASES)
def test_team_rule_equals_plain_and_jax(name, lanes):
    unknown, known, _ = nn_case(name)
    d, i = team_three_nn(t(unknown), t(known), lanes)
    pd, pi = three_nn_plain(t(unknown), t(known))
    jd, ji = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(i.numpy(), pi.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy(), pd.numpy())
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-6)


def test_cases_reach_the_trouble_they_name():
    _, i = three_nn_plain(*map(t, nn_case("all_zero_known")[:2]))
    assert (i[1] == torch.tensor([0, 1, 2], dtype=torch.int32)).all()
    d, i = three_nn_plain(*map(t, nn_case("equidistant")[:2]))
    assert (d[:, :10] == 9.0).all()  # a three-way tie over the lanes
    d, i = three_nn_plain(*map(t, nn_case("huge")[:2]))
    assert torch.isinf(d).any() and (d[:, 5, 0] == 0).all()
    assert (i[:, 5, 1:] == 0).all()  # slots no finite distance fills
    d, _ = three_nn_plain(*map(t, nn_case("unknown_on_known")[:2]))
    assert (d[:, :64, 0] == 0).all() and (d[:, :64, 1] == 0).any()


@pytest.mark.parametrize("name", NN_CASES)
def test_interpolate_features_and_its_gradient_match_jax(name):
    unknown, known, feats = nn_case(name)
    rng = np.random.default_rng(len(name))
    g = rng.normal(size=unknown.shape[:2] + feats.shape[2:]).astype(
        np.float32)
    u = t(unknown).requires_grad_(True)
    k = t(known).requires_grad_(True)
    f = t(feats).requires_grad_(True)
    ops.reset_launches()
    out = ops.interpolate_features(u, k, f)
    out.backward(t(g))
    assert not any(ops.launches.values())
    assert u.grad is None and k.grad is None
    want, vjp = jax.vjp(
        lambda fe: jops.interpolate_features(jnp.asarray(unknown),
                                             jnp.asarray(known), fe),
        jnp.asarray(feats))
    (jg,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    d, i = three_nn_plain(t(unknown), t(known))
    w = interpolation_weights(d)
    scale = three_interpolate_grad_plain(t(np.abs(g)), i, w.abs(),
                                         known.shape[1]).numpy()
    err = np.abs(f.grad.numpy() - np.asarray(jg))
    assert (err <= GRAD_RTOL * scale + 1e-30).all(), err.max()


@pytest.mark.parametrize("name", ("random", "duplicated_known",
                                  "unknown_on_known", "huge", "b3"))
def test_plain_weighted_backward(name):
    unknown, known, feats = nn_case(name)
    b, n, _ = unknown.shape
    m, c = feats.shape[1:]
    g = t(np.random.default_rng(1).normal(size=(b, n, c)).astype(np.float32))
    d, i = three_nn_plain(t(unknown), t(known))
    w = interpolation_weights(d)
    got = three_interpolate_grad_plain(g, i, w, m)
    rows = (g[:, :, None, :] * w[..., None]).reshape(b, 3 * n, c)
    assert torch.equal(got, group_points_grad_plain(rows, i.reshape(b, -1),
                                                    m))
    _, vjp = jax.vjp(lambda fe: jops.three_interpolate(
        fe, jnp.asarray(i.numpy()), jnp.asarray(w.numpy())),
        jnp.asarray(feats))
    (jg,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    # the autograd gradient of the plain forward is the same sum
    f = t(feats).requires_grad_(True)
    interpolate_features_plain(t(unknown), t(known), f).backward(g)
    np.testing.assert_allclose(f.grad.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


# (b, n, m): FP1 and FP2 at B=8, then odd shapes
PLAN_SHAPES = [(8, 512, 256), (8, 1024, 512), (1, 1, 3), (3, 45, 37),
               (9, 100000, 5000), (65535, 7, 4), (65537, 7, 4)]


@pytest.mark.parametrize("b,n,m", PLAN_SHAPES)
def test_three_nn_plan_is_a_plan_the_kernel_takes(b, n, m):
    plan = _three_nn_plan(b, n, m)
    assert plan in TEAM_PLANS
    lanes, points = _check_team_plan(plan)
    assert lanes * points % 32 == 0 and lanes * points <= 1024


def test_team_plans_and_refused_shapes():
    for plan in TEAM_PLANS:
        assert _check_team_plan(plan) == plan
    for plan in ((3, 32), (8, 3), (32, 64), (64, 16), (8, 0), (8,), "ab",
                 [8, 32], (8.0, 32)):
        with pytest.raises(ValueError, match="plan"):
            _check_team_plan(plan)
    for shape in ((1, 10, 2), (4, -1, 5), (0, 10, 5)):
        with pytest.raises(ValueError):
            _three_nn_plan(*shape)
    with pytest.raises(ValueError, match="at least 3"):
        ops.interpolate_features(torch.zeros(1, 4, 3), torch.zeros(1, 2, 3),
                                 torch.zeros(1, 2, 8))


@pytest.mark.parametrize("b,n,c,m", [(8, 512, 256, 256), (8, 1024, 256, 512),
                                     (2, 45, 13, 37), (2, 300, 8, 20000)])
def test_interp_grad_plan_takes_the_sorted_kernel(b, n, c, m):
    """The backward's plan is one its kernel takes, within the default
    48 KB of shared memory (the list, 512 entries a warp, and 64 staged
    entries a warp), a lane's units covering C = 256 in float4 in one
    slice."""
    plan = _interp_grad_plan(b, m, c, 3 * n)
    assert plan in INTERP_GRAD_PLANS
    warps, lane_units = _check_interp_grad_plan(plan)
    assert 4 * (warps * (512 + 64) + 32) <= 48 * 1024
    units = c // 4 if c % 4 == 0 else c
    # the fewer units a lane that cover the row in one slice, at most 2
    assert 32 * lane_units >= min(units, 64)
    assert lane_units == 1 or units > 32
    if c == 256:
        assert lane_units == 2


def test_interp_grad_plans_and_refused_plans():
    for plan in INTERP_GRAD_PLANS:
        assert _check_interp_grad_plan(plan) == plan
    for plan in ((0, 1), (17, 1), (8, 3), (8, 4), (8, 0), (8,), "ab",
                 [8, 2], (8.0, 2)):
        with pytest.raises(ValueError, match="plan"):
            _check_interp_grad_plan(plan)


@pytest.mark.parametrize("name", ("random", "all_zero_known", "b3"))
def test_ordered_backward_sum_equals_plain_on_the_cpu(name):
    """interp_grad_ordered (the card tests' bit-exact reference for the
    kernel) is the plain backward's sum: on the CPU index_add_ adds in
    ascending entry order, so the two agree bit for bit."""
    unknown, known, feats = nn_case(name)
    b, n, _ = unknown.shape
    m, c = feats.shape[1:]
    g = t(np.random.default_rng(2).normal(size=(b, n, c)).astype(np.float32))
    d, i = three_nn_plain(t(unknown), t(known))
    w = interpolation_weights(d)
    assert torch.equal(interp_grad_ordered(g, i, w, m),
                       three_interpolate_grad_plain(g, i, w, m))
