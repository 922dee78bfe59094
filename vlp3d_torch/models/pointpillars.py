"""PointPillars pillar encoder (the ``--use_pc_encoder`` path).

Counterpart of ``vlp3d/models/pointpillars.py`` (the reference's
PillarLayer + PillarEncoder). In the reference this component is dormant:
JointNet never builds it. The port keeps it, as JAX does, for inventory
parity and standalone use, unwired from JointNet.

As JAX computes it:

- hard voxelization of every batch row (``ops.voxelize``; one launch of
  each kernel for the batch), padded to ``max_voxels`` with a mask;
- the nine point features [x_off, y_off, z, r, dx, dy, dz, x_off, y_off]
  (the point's offset from its pillar's centre in x and y replaces its x
  and y, the mmdet3d convention), zeroed in empty slots *before* the
  k=1 conv, so the max over the slots sees relu(bn(0)) there;
- the conv (``conv.weight`` (64, 9, 1), no bias) as a matmul, BatchNorm
  with eps 1e-3 and momentum 0.01 (flax's 0.99), ReLU, the max over the
  slots (``amax``: ties share the gradient, as JAX's max does), empty
  voxels zeroed;
- in training the BatchNorm statistics are over all (B, max_voxels,
  max_points) rows, empty voxels and slots included (the reference pools
  only non-empty pillars; ROADMAP C24);
- the canvas (B, y_l, x_l, C) channels-last, as JAX returns it.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import BatchNorm, PointwiseConv
from vlp3d_torch.ops.voxelize import hard_voxelize


class PillarEncoder(nn.Module):
    def __init__(self, voxel_size=(0.16, 0.16, 4.0),
                 point_cloud_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
                 max_num_points: int = 32, max_voxels: int = 16000,
                 out_channel: int = 64, in_channel: int = 9, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_num_points = max_num_points
        self.max_voxels = max_voxels
        self.out_channel = out_channel
        self.conv = PointwiseConv(in_channel, out_channel, bias=False,
                                  device=device)
        self.bn = BatchNorm(out_channel, device=device)
        self.bn.eps = 1e-3
        self.bn.momentum = 0.01

    def canvas_size(self) -> tuple[int, int]:
        vs, pr = self.voxel_size, self.point_cloud_range
        return (int(round((pr[4] - pr[1]) / vs[1])),
                int(round((pr[3] - pr[0]) / vs[0])))

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """points (B, N, C>=3) -> BEV canvas (B, y_l, x_l, out_channel)."""
        vs, pr = self.voxel_size, self.point_cloud_range
        y_l, x_l = self.canvas_size()
        vox = hard_voxelize(points, vs, pr, self.max_num_points,
                            self.max_voxels)
        pillars = vox["voxels"]  # (B, V, P, C)
        coors = vox["coors"]  # (B, V, 3) xyz
        npoints = vox["num_points_per_voxel"]  # (B, V)
        vmask = vox["voxel_mask"]  # (B, V)

        f32 = dict(dtype=torch.float32, device=points.device)
        denom = torch.clamp(npoints, min=1)[..., None, None].to(torch.float32)
        center = pillars[..., :3].sum(2, keepdim=True) / denom
        offset_pt = pillars[..., :3] - center
        cxy = coors[..., None, 0:2].to(torch.float32)  # (B, V, 1, 2)
        step = torch.tensor([vs[0], vs[1]], **f32)
        start = torch.tensor([vs[0] / 2 + pr[0], vs[1] / 2 + pr[1]], **f32)
        xy_off = pillars[..., 0:2] - (cxy * step + start)
        feats = torch.cat([xy_off, pillars[..., 2:], offset_pt, xy_off], -1)

        pmask = (torch.arange(pillars.shape[2], device=points.device)
                 < npoints[..., None])
        feats = feats * pmask[..., None]

        h = torch.relu(self.bn(self.conv(feats)))
        pooled = torch.amax(h, dim=2) * vmask[..., None]  # (B, V, C)

        b = points.shape[0]
        canvas = pooled.new_zeros((b, y_l + 1, x_l + 1, self.out_channel))
        rows = torch.arange(b, device=points.device)[:, None].expand_as(vmask)
        y = torch.where(vmask, coors[..., 1], y_l).long()
        x = torch.where(vmask, coors[..., 0], x_l).long()
        canvas = canvas.index_put((rows, y, x), pooled)
        return canvas[:, :y_l, :x_l]
