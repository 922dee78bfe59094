"""Kernels whose launch once put the batch on ``gridDim.y`` (at most 65535
rows), held against their plain versions past that many rows: 65537 rows
of a few points each. Shared by the card tests
(``tests/test_torch_kernels.py``) and the card's smoke run
(``chip_smoke.py``); torch and vlp3d_torch only, no JAX.
"""

from __future__ import annotations

import numpy as np

ROWS = 65537
# (points, centres or known points, slots, channels) a row
N, M, S, C = 16, 4, 8, 5
DIST_TOL = 1e-6  # three-NN distances and weights, kernel against plain
OUT_TOL = 1e-5  # interpolated features


def _within_scale(torch, got, want, scale, rtol) -> float:
    """The largest |got - want| over (scale + 1e-30), which must be at
    most rtol: a scatter-add's sums meet in another order."""
    err = ((got - want).abs() / (scale + 1e-30)).max().item()
    assert err <= rtol, err
    return err


def check_batch_rows(torch, device) -> dict:
    """Each kernel at ROWS rows against its plain version on ``device``
    (a CUDA device); returns the largest error of each (0 where exact),
    raising AssertionError where one differs past its tolerance."""
    from vlp3d_torch.ops import voxelize as vox
    from vlp3d_torch.ops.ball_query import (
        _ball_query_cuda,
        ball_query_plain,
        tile_plans,
    )
    from vlp3d_torch.ops.grouping import (
        GRAD_RTOL,
        _group_points_grad_cuda,
        group_points_grad_plain,
    )
    from vlp3d_torch.ops.interpolate import (
        _interpolate_cuda,
        _three_interpolate_grad_cuda,
        _three_nn_cuda,
        interpolate_features_plain,
        interpolation_weights,
        three_interpolate_grad_plain,
        three_nn_plain,
    )

    rng = np.random.default_rng(ROWS)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    xyz = dev(rng.uniform(0, 1, (ROWS, N, 3)).astype(np.float32))
    ctr = xyz[:, :M].contiguous()
    errs = {}
    # ball query: the warp-a-centre kernel and a tile plan
    want, _ = ball_query_plain(0.4, S, xyz, ctr)
    for plan in ("warp", next(iter(tile_plans(N, S)))):
        got, _ = _ball_query_cuda(0.4, S, xyz, ctr, False, plan=plan)
        assert torch.equal(got, want), plan
    errs["ball_query"] = 0.0
    # the gather's backward: the sorted kernel and the atomic one
    grad = dev(rng.normal(size=(ROWS, M * S, C)).astype(np.float32))
    idx = want.reshape(ROWS, M * S).contiguous()
    g_want = group_points_grad_plain(grad, idx, N)
    scale = group_points_grad_plain(grad.abs(), idx, N)
    errs["group_points_grad"] = max(
        _within_scale(torch, _group_points_grad_cuda(grad, idx, N, plan),
                      g_want, scale, GRAD_RTOL) for plan in (None, "atomic"))
    # three-NN: the team kernel and the serial one; the fused
    # interpolation; the interpolation's backward
    known = xyz[:, N - M:].contiguous()
    d_want, i_want = three_nn_plain(xyz, known)
    err = 0.0
    for plan in (None, "serial"):
        d, i = _three_nn_cuda(xyz, known, plan)
        assert torch.equal(i, i_want), plan
        err = max(err, (d - d_want).abs().max().item())
    assert err <= DIST_TOL, err
    errs["three_nn"] = err
    feats = dev(rng.normal(size=(ROWS, M, C)).astype(np.float32))
    out, i, w = _interpolate_cuda(xyz, known, feats)
    assert torch.equal(i, i_want)
    w_err = (w - interpolation_weights(d_want)).abs().max().item()
    o_err = (out - interpolate_features_plain(xyz, known, feats)).abs().max(
    ).item()
    assert w_err <= DIST_TOL and o_err <= OUT_TOL, (w_err, o_err)
    errs["three_nn"] = max(err, w_err, o_err)
    up = dev(rng.normal(size=(ROWS, N, C)).astype(np.float32))
    weight = interpolation_weights(d_want).contiguous()
    errs["three_interpolate_grad"] = _within_scale(
        torch, _three_interpolate_grad_cuda(up, i_want, weight, M),
        three_interpolate_grad_plain(up, i_want, weight, M),
        three_interpolate_grad_plain(up.abs(), i_want, weight, M), GRAD_RTOL)
    # hard voxelization: 4 voxels of 4 slots a row, every output; the
    # plain version (a loop over rows) on the first rows and on those
    # about and past row 65535
    pts = dev(rng.uniform(0, 2, (ROWS, 8, 4)).astype(np.float32))
    vs, cr = (1.0, 1.0, 1.0), (0.0, 0.0, 0.0, 2.0, 2.0, 2.0)
    got = vox._hard_cuda(pts, vs, cr, 4, 4)
    rows = torch.cat([torch.arange(8), torch.arange(65528, ROWS)]).to(device)
    for a, b in zip(got, vox.hard_voxelize_plain(pts[rows], vs, cr, 4, 4)):
        assert a.dtype == b.dtype and torch.equal(a[rows], b)
    assert int(got[3].min()) > 0  # every row holds voxels
    errs["hard_voxelize"] = 0.0
    return errs
