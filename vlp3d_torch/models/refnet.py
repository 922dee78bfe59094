"""RefNet: the single-task visual grounding model of the 3DJCG pipeline.

Counterpart of ``vlp3d/models/refnet.py`` (the reference's
``models/refnet/refnet.py:15-121``): backbone, voting (L2-normalised vote
features), proposal and relation as in JointNet, then the GloVe/LSTM
language encoder (hidden 256), whose token features and sentence
embedding are projected to the 128-d match space (``lang_proj``,
``lang_emb_proj``), and the match module over each sentence's tokens
with the sentence embedding prepended in the CLS slot (the match module
drops the first token; the LSTM has no CLS). No BERT, contrast or
caption branch. The detector runs the FPS, ball-query, gather and
three-NN kernels and the relation module's reference read, as JointNet's
does.

Submodule names: ``backbone_net``, ``vgen``, ``proposal``, ``relation``,
``lang``, ``lang_proj``, ``lang_emb_proj``, ``match``, so
``load_state_dict(refnet_to_torch_state_dict(...), strict=True)`` works.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.config import Config
from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.backbone import PointNet2Backbone
from vlp3d_torch.models.jointnet import init_weights_
from vlp3d_torch.models.lang_lstm import LSTMLangModule
from vlp3d_torch.models.match import MatchModule
from vlp3d_torch.models.proposal import ProposalModule
from vlp3d_torch.models.relation import RelationModule
from vlp3d_torch.models.voting import VotingModule, l2_normalize

LANG_HIDDEN = 256  # the LSTM's width (unidirectional, as the JAX trainer's)


def detection_stack(model: nn.Module, config: Config, device) -> None:
    """The backbone, voting, proposal and relation modules of RefNet and
    CapNet, as attributes of ``model`` (JointNet's with the default
    options)."""
    cfg, ds = config.model, config.dataset
    model.backbone_net = PointNet2Backbone(
        cfg.input_feature_dim, npoints=tuple(cfg.sa_npoints),
        radii=tuple(cfg.sa_radii), nsamples=tuple(cfg.sa_nsamples),
        device=device)
    model.vgen = VotingModule(1, 256, device=device)
    model.proposal = ProposalModule(ds.num_class, ds.num_heading_bin,
                                    cfg.num_proposal, device=device)
    model.relation = RelationModule(
        det_channel=128, multiview_offset=cfg.multiview_offset,
        multiview_dim=cfg.multiview_dim, device=device)


def run_detection(model: nn.Module, batch: dict) -> dict:
    """Backbone -> voting -> proposal -> relation of ``detection_stack``."""
    out = dict(model.backbone_net(batch["point_clouds"]))
    out["seed_inds"] = out["fp2_inds"]
    out["seed_xyz"] = out["fp2_xyz"]
    out["seed_features"] = out["fp2_features"]
    vote_xyz, vote_features = model.vgen(out["fp2_xyz"], out["fp2_features"])
    out["vote_xyz"] = vote_xyz
    out["vote_features"] = l2_normalize(vote_features)
    out.update(model.proposal(vote_xyz, out["vote_features"]))
    out.update(model.relation(
        out["aggregated_vote_features"], out["pred_center"],
        out["pred_size"], out["pred_heading"], batch["point_clouds"],
        out["seed_inds"], out["aggregated_vote_inds"]))
    return out


class RefNet(nn.Module):
    """Weights start from :func:`~vlp3d_torch.models.jointnet.init_weights_`
    with seed 0. ``forward(batch, train=...)`` as JointNet's: ``batch``
    holds point_clouds, lang_feat (B, L, T, E), lang_len (B, L) and, in
    training, ``random`` (the copy-paste gate)."""

    def __init__(self, config: Config, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        detection_stack(self, config, device)
        self.lang = LSTMLangModule(
            300, LANG_HIDDEN, num_object_class=config.dataset.num_class,
            use_lang_classifier=config.model.use_lang_classifier,
            device=device)
        self.lang_proj = nn.Linear(LANG_HIDDEN, 128, device=device)
        self.lang_emb_proj = nn.Linear(LANG_HIDDEN, 128, device=device)
        self.match = MatchModule(num_proposals=config.model.num_proposal,
                                 device=device)
        init_weights_(self, 0)
        self.eval()

    def forward(self, batch: dict, *, train: bool = False) -> dict:
        if self.training != train:
            self.train(train)
        with torch.set_grad_enabled(train):
            return self._forward(batch)

    def _forward(self, batch: dict) -> dict:
        out = run_detection(self, batch)
        b, l, t, e = batch["lang_feat"].shape
        lang = self.lang(batch["lang_feat"].reshape(b * l, t, e),
                         batch["lang_len"].reshape(b * l))
        lang_fea = self.lang_proj(lang["lang_fea_lstm"])
        lang_emb = self.lang_emb_proj(lang["lang_emb_lstm"])
        out["lang_fea"] = lang_fea
        out["lang_emb"] = lang_emb
        if "lang_scores" in lang:
            out["lang_scores"] = lang["lang_scores"]
        out.update(self.match(
            out["bbox_feature"],
            torch.cat([lang_emb[:, None, :], lang_fea], dim=1),
            out["objectness_masks"], lang_num_max=l,
            random_gate=batch.get("random"), lang_emb=lang_emb))
        return out
