"""PointNet++ backbone: 4 set-abstraction + 2 feature-propagation layers.

Counterpart of ``vlp3d/models/backbone.py``. SA1 reads the raw cloud,
so it is the one SA module with ``leaf_inputs``: in training its gather
has no backward. Emits the seeds
fp2_xyz (= sa2_xyz), fp2_features and fp2_inds (= sa1_inds[:, :num_seed],
indices into the raw input cloud).

``remat`` recomputes each SA and FP block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the JAX module's
``nn.remat`` does, with the same policy: the point indices are saved,
everything else is recomputed. Each SA block's FPS, centre gather and
ball query run outside its checkpoint (:meth:`SAModule.sample`), so a
step launches FPS and ball query 5 times each, as without remat; the
neighbourhood gather and MLP of SA1-4 and the interpolation and MLP of
FP1-2 run again, so a remat step launches the row gather 15 times (11
forward + 4) and three-NN 4 times (2 + 2); the backwards are unchanged.

``sa1_precomputed`` (new_xyz, grouped, inds) takes the place of SA1's
sampling and grouping: the point-sharded front end
(:func:`vlp3d_torch.parallel.point_parallel.apply_backbone_large_scene`)
computes them over ranks that each hold a slab of the cloud, and SA1 then
runs only its MLP on ``grouped`` (recentred, radius-normalised xyz and
the raw features), with the parameters of the dense forward.

``dtype`` (``torch.bfloat16`` for ``compute_dtype="bfloat16"``) is the
SA1-4 and FP1-2 point MLPs' compute dtype (:class:`PointMLP`); every
output of the backbone, and every input of the kernels, stays float32.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import (
    Dropout,
    FPModule,
    SAModule,
    frozen_statistics,
)


class PointNet2Backbone(nn.Module):
    def __init__(self, input_feature_dim: int = 0, *,
                 npoints=(2048, 1024, 512, 256), radii=(0.2, 0.4, 0.8, 1.2),
                 nsamples=(64, 32, 16, 16), remat: bool = False,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.remat = remat
        np_, r, ns = npoints, radii, nsamples
        self.sa1 = SAModule(np_[0], r[0], ns[0], [64, 64, 128],
                            input_feature_dim, leaf_inputs=True,
                            dtype=dtype, device=device)
        self.sa2 = SAModule(np_[1], r[1], ns[1], [128, 128, 256], 128,
                            dtype=dtype, device=device)
        self.sa3 = SAModule(np_[2], r[2], ns[2], [128, 128, 256], 256,
                            dtype=dtype, device=device)
        self.sa4 = SAModule(np_[3], r[3], ns[3], [128, 128, 256], 256,
                            dtype=dtype, device=device)
        self.fp1 = FPModule([256, 256], 512, dtype=dtype, device=device)
        self.fp2 = FPModule([256, 256], 512, dtype=dtype, device=device)
        if remat and any(isinstance(m, Dropout) for m in self.modules()):
            # the recompute would draw new masks: preserve_rng_state keeps
            # only the global generator, not set_dropout_generator's
            raise ValueError("a rematerialised backbone block holds a "
                             "Dropout; its recompute would draw another mask")

    def _block(self, module: nn.Module, fn, *args):
        """fn(*args), under a checkpoint when rematerialising a training
        forward that records a graph."""
        if not (self.remat and module.training and torch.is_grad_enabled()):
            return fn(*args)
        return checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                frozen_statistics(module)))

    def _sa(self, module: SAModule, xyz, features):
        inds, new_xyz, idx = module.sample(xyz)
        return (new_xyz,
                self._block(module, module.group, xyz, features, new_xyz,
                            idx),
                inds)

    def forward(self, point_clouds: torch.Tensor,
                sa1_precomputed: tuple | None = None) -> dict:
        """point_clouds (B, N, 3 + input_feature_dim) -> sa*/fp2 outputs;
        with ``sa1_precomputed`` the cloud is not read."""
        if sa1_precomputed is not None:
            sa1_xyz, grouped, sa1_inds = sa1_precomputed
            sa1_f = self._block(self.sa1, self.sa1.group_precomputed,
                                grouped)
        else:
            xyz, features = point_clouds[..., :3], point_clouds[..., 3:]
            sa1_xyz, sa1_f, sa1_inds = self._sa(self.sa1, xyz, features)
        sa2_xyz, sa2_f, sa2_inds = self._sa(self.sa2, sa1_xyz, sa1_f)
        sa3_xyz, sa3_f, _ = self._sa(self.sa3, sa2_xyz, sa2_f)
        sa4_xyz, sa4_f, _ = self._sa(self.sa4, sa3_xyz, sa3_f)
        f = self._block(self.fp1, self.fp1, sa3_xyz, sa4_xyz, sa3_f, sa4_f)
        f = self._block(self.fp2, self.fp2, sa2_xyz, sa3_xyz, sa2_f, f)
        return {
            "sa1_inds": sa1_inds,
            "sa1_xyz": sa1_xyz,
            "sa1_features": sa1_f,
            "sa2_inds": sa2_inds,
            "sa2_xyz": sa2_xyz,
            "sa2_features": sa2_f,
            "sa3_xyz": sa3_xyz,
            "sa3_features": sa3_f,
            "sa4_xyz": sa4_xyz,
            "sa4_features": sa4_f,
            "fp2_features": f,
            "fp2_xyz": sa2_xyz,
            # indices into the raw input cloud (backbone_module.py:134)
            "fp2_inds": sa1_inds[:, :sa2_xyz.shape[1]],
        }
