"""ScanQA standalone model: LSTM language encoder + VoteNet detector +
MCAN fusion.

Counterpart of ``vlp3d/models/scanqa.py`` (the reference's
``models/vqa/qa_module.py:9-260``): the GloVe/LSTM encoder (hidden 128)
and the PointNet++ detector (backbone, voting with L2-normalised vote
features, the classic VoteNet head) run side by side; 128-d GELU
projections of the token features and the proposal features feed a
2-layer MCAN encoder-decoder, the language keys masked beyond each
question's length and the proposals masked where their objectness is 0
(``use_object_mask``); masked AttFlat pools of both streams (flat out
1024) are summed and normalised into the fused feature, which scores
``num_answers`` answers and the question's object class; a head gives
each proposal's reference confidence
(``cluster_ref``, gated by its objectness); the three switches are on,
as every trainer has them. The detector's SA modules
run the FPS, ball-query and gather kernels, FP1-2 the three-NN
interpolation, forward and backward, as JointNet's do.

Submodule names are the reference's (``lang_net``,
``detection_backbone``, ``voting_net``, ``proposal_net``,
``lang_feat_linear``, ``object_feat_linear``, ``fusion_backbone``,
``object_cls``, ``attflat_lang``, ``attflat_visual``, ``fusion_norm``,
``lang_cls``, ``answer_cls``), so
``load_state_dict(scanqa_to_torch_state_dict(...), strict=True)`` works.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.config import Config
from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.answer import AttFlat
from vlp3d_torch.models.backbone import PointNet2Backbone
from vlp3d_torch.models.jointnet import init_weights_
from vlp3d_torch.models.lang_lstm import LSTMLangModule
from vlp3d_torch.models.layers import Dropout, RefLayerNorm
from vlp3d_torch.models.mcan import MCAN_ED
from vlp3d_torch.models.votenet_head import VoteNetProposalModule
from vlp3d_torch.models.voting import VotingModule, l2_normalize


def _head(cin: int, hidden: int, cout: int, pdrop: float, device):
    """Linear, GELU, dropout, linear (keys ``.0`` and ``.3``)."""
    return nn.Sequential(
        nn.Linear(cin, hidden, device=device), nn.GELU(approximate="tanh"),
        Dropout(pdrop), nn.Linear(hidden, cout, device=device))


HIDDEN = 128  # the LSTM's, the projections' and MCAN's width
FLAT_OUT = 1024  # the AttFlat pools' output (mcan_flat_out_size)
GLOVE_DIM = 300


class ScanQA(nn.Module):
    """Weights start from :func:`~vlp3d_torch.models.jointnet.init_weights_`
    with seed 0. ``forward(batch, train=...)`` as JointNet's: ``batch``
    holds point_clouds (B, N, 3 + C), lang_feat (B, T, E) and lang_len
    (B,). The JAX module's switches ``use_object_mask``, ``use_lang_cls``
    and ``use_reference`` keep their defaults (on): no trainer turns them
    off."""

    def __init__(self, config: Config, num_answers: int = 8864, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg, ds = config.model, config.dataset
        self.config = config
        h = HIDDEN
        self.lang_net = LSTMLangModule(GLOVE_DIM, h,
                                       num_object_class=ds.num_class,
                                       use_lang_classifier=False,
                                       device=device)
        self.detection_backbone = PointNet2Backbone(
            cfg.input_feature_dim, npoints=tuple(cfg.sa_npoints),
            radii=tuple(cfg.sa_radii), nsamples=tuple(cfg.sa_nsamples),
            device=device)
        self.voting_net = VotingModule(1, 256, device=device)
        self.proposal_net = VoteNetProposalModule(
            ds.num_class, ds.num_heading_bin, ds.num_size_cluster,
            cfg.num_proposal, mean_size_arr=ds.mean_size_arr(),
            device=device)
        self.lang_feat_linear = nn.Sequential(
            nn.Linear(h, h, device=device), nn.GELU(approximate="tanh"))
        self.object_feat_linear = nn.Sequential(
            nn.Linear(128, h, device=device), nn.GELU(approximate="tanh"))
        self.fusion_backbone = MCAN_ED(h, num_layers=2, device=device)
        self.object_cls = _head(h, h, 1, 0.1, device)
        self.attflat_lang = AttFlat(FLAT_OUT, device=device)
        self.attflat_visual = AttFlat(FLAT_OUT, device=device)
        self.fusion_norm = RefLayerNorm(FLAT_OUT, device=device)
        self.lang_cls = _head(FLAT_OUT, h, ds.num_class, 0.1, device)
        self.answer_cls = _head(FLAT_OUT, h, num_answers, 0.3, device)
        init_weights_(self, 0)
        self.eval()

    def forward(self, batch: dict, *, train: bool = False) -> dict:
        if self.training != train:
            self.train(train)
        with torch.set_grad_enabled(train):
            return self._forward(batch)

    def _forward(self, batch: dict) -> dict:
        lang = self.lang_net(batch["lang_feat"], batch["lang_len"])
        lang_feat = lang["lang_fea_lstm"]  # (B, T, H)
        t = lang_feat.shape[1]
        lang_mask = (torch.arange(t, device=lang_feat.device)[None, :]
                     >= batch["lang_len"][:, None].long())  # True = pad

        out = dict(self.detection_backbone(batch["point_clouds"]))
        out["seed_inds"] = out["fp2_inds"]
        out["seed_xyz"] = out["fp2_xyz"]
        out["seed_features"] = out["fp2_features"]
        vote_xyz, vote_features = self.voting_net(out["fp2_xyz"],
                                                  out["fp2_features"])
        vote_features = l2_normalize(vote_features)
        out["vote_xyz"] = vote_xyz
        out["vote_features"] = vote_features
        out.update(self.proposal_net(vote_xyz, vote_features))

        lang_h = self.lang_feat_linear(lang_feat)
        obj_h = self.object_feat_linear(out["aggregated_vote_features"])
        obj_mask = out["objectness_masks"] == 0
        lang_h, obj_h = self.fusion_backbone(lang_h, obj_h, lang_mask,
                                             obj_mask)
        out["cluster_ref"] = (self.object_cls(obj_h)[..., 0]
                              * out["objectness_masks"])
        fuse = self.fusion_norm(self.attflat_lang(lang_h, lang_mask)
                                + self.attflat_visual(obj_h, obj_mask))
        out["lang_scores"] = self.lang_cls(fuse)
        out["answer_scores"] = self.answer_cls(fuse)
        return out
