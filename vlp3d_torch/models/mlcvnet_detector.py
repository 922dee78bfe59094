"""MLCVNet's standalone detector.

Counterpart of ``MLCVNetDetector`` in ``vlp3d/models/mlcvnet_detector.py``
(the reference's ``models/mlcvnet/mlcvnet.py:26-104`` with its proposal
module): the PointNet++ backbone, CGNL voting
(:class:`~vlp3d_torch.models.mlcvnet.MLCVVotingModule`) with the votes
L2-normalised, the vote aggregation SA (FPS ``num_proposal`` of the
votes, r 0.3, k 16, mlp [128, 128, 128]), two CGNL blocks over the
proposals' 128 channels (planes 64), then the classic VoteNet head (two
bias-free conv + BN + ReLU, one conv) with its decode. ``argmax`` takes
the first index of a tie (the size class, ``objectness_masks``).
``aggregated_vote_features`` are the CGNL-refined features, as in the
JAX module.

Submodules: ``backbone_net``, ``vgen`` and ``pnet`` (the reference's
VoteNet names; ``pnet`` holds ``vote_aggregation``, ``cgnl1``,
``cgnl2``, ``conv1-3`` and ``bn1-2``).
:func:`vlp3d_torch.convert.mlcvnet_detector_to_torch_state_dict` carries
a JAX tree over.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.config import Config
from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.jointnet import init_weights_
from vlp3d_torch.models.mlcvnet import MLCVVotingModule, SpatialCGNL
from vlp3d_torch.models.refnet import run_votes, vote_stack
from vlp3d_torch.models.votenet_head import VoteNetProposalModule


class MLCVProposalModule(VoteNetProposalModule):
    """The VoteNet head over the aggregated votes refined by two CGNL
    blocks."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=device, **kwargs)
        self.cgnl1 = SpatialCGNL(128, 64, device=device)
        self.cgnl2 = SpatialCGNL(128, 64, device=device)

    def refine(self, agg_f: torch.Tensor) -> torch.Tensor:
        return self.cgnl2(self.cgnl1(agg_f))


class MLCVNetDetector(nn.Module):
    """Weights start from :func:`~vlp3d_torch.models.jointnet.init_weights_`
    with seed 0. ``forward(batch, train=...)`` as JointNet's, on
    ``batch["point_clouds"]`` (B, N, 3 + C)."""

    def __init__(self, config: Config, *, device=None):
        super().__init__()
        device = resolve_device(device)
        cfg, ds = config.model, config.dataset
        self.config = config
        vote_stack(self, config, MLCVVotingModule(1, 256, device=device),
                   device)
        self.pnet = MLCVProposalModule(
            ds.num_class, ds.num_heading_bin, ds.num_size_cluster,
            cfg.num_proposal, mean_size_arr=ds.mean_size_arr(),
            device=device)
        init_weights_(self, 0)
        self.eval()

    def forward(self, batch: dict, *, train: bool = False) -> dict:
        if self.training != train:
            self.train(train)
        with torch.set_grad_enabled(train):
            out = run_votes(self, batch["point_clouds"])
            out.update(self.pnet(out["vote_xyz"], out["vote_features"]))
            return out
