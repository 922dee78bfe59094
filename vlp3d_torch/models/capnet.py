"""CapNet: the legacy 3DJCG / Scan2Cap captioning model.

Counterpart of ``vlp3d/models/capnet.py`` (the reference's
``models/capnet/{capnet,caption_module}.py``): the detection stack and
relation module of RefNet, then a top-down attentive recurrent captioner
(TopDownSceneCaptionModule, caption_module.py:97-500):

  * the caption's target proposal is the one nearest the sentence's GT
    reference centre (``nn_distance``, the lowest index on a tie);
  * each step: [word_proj(word), hidden, hidden_proj(target feature)] ->
    map_previous + ReLU -> a query over the proposal features (obj_fc +
    ReLU + LayerNorm eps 1e-5) through one attention block (dropout off,
    as the JAX module calls it deterministic) -> map_lang = the next
    hidden state; the classifier scores the next word;
  * teacher forcing over the T - 1 first words of each sos/eos-wrapped
    GloVe caption (the last word's step is never scored);
  * ``num_locals`` > 0: the attention sees only the ``num_locals``
    nearest proposals to the target box that are objects and overlap it
    below 0.5 IoU, the target itself included (:func:`query_local_masks`).

Submodule names: ``backbone_net``, ``vgen``, ``proposal``, ``relation``
and ``caption`` (``word_proj``, ``map_previous``, ``obj_fc``, ``obj_ln``,
``query_proj``, ``dec_att2``, ``map_lang``, ``hidden_proj``,
``classifier``), so ``load_state_dict(capnet_to_torch_state_dict(...),
strict=True)`` works.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.config import Config
from vlp3d_torch.device import resolve_device
from vlp3d_torch.geometry.boxes import box3d_iou_corners, get_3d_box_batch
from vlp3d_torch.geometry.nn_distance import nn_distance
from vlp3d_torch.models.attention import MultiHeadAttention
from vlp3d_torch.models.jointnet import init_weights_
from vlp3d_torch.models.refnet import detection_stack, run_detection

BIG = 1e30


OVERLAY_THRESHOLD = 0.5


@torch.no_grad()
def query_local_masks(corners: torch.Tensor, target_ids: torch.Tensor,
                      object_masks: torch.Tensor,
                      num_locals: int) -> torch.Tensor:
    """(N, K) float mask of the ``num_locals`` proposals nearest the target
    box (caption_module.py:252-300, its ``corner`` query): corners (N, K,
    8, 3), target_ids (N,), object_masks (N, K). The distance is from the
    nearest of the target's 8 corners to each proposal's AABB centre;
    non-objects and proposals overlapping the target at
    ``OVERLAY_THRESHOLD`` IoU or more are pushed to 1e30, the target
    itself to 0. ``jax.lax.top_k`` takes the lowest index among equal
    values, and the 1e30 entries make ties at the k-th place common, so
    the order is a stable sort (ascending distance, ascending index)."""
    n, k = corners.shape[:2]
    centers = (corners.amin(dim=2) + corners.amax(dim=2)) / 2.0  # (N, K, 3)
    rows = torch.arange(n, device=corners.device)
    ids = target_ids.long()
    t_corners = corners[rows, ids]  # (N, 8, 3)
    d = torch.sqrt(((t_corners[:, :, None, :] - centers[:, None]) ** 2)
                   .sum(-1) + 1e-8)  # (N, 8, K)
    dist = d.amin(dim=1)
    big = torch.full_like(dist, BIG)
    dist = torch.where(object_masks == 0, big, dist)
    iou = box3d_iou_corners(t_corners[:, None], corners)  # (N, K)
    dist = torch.where(iou >= OVERLAY_THRESHOLD, big, dist)
    dist = torch.where(F.one_hot(ids, k).bool(), 0.0, dist)
    topk = torch.argsort(dist, dim=1, stable=True)[:, :num_locals]
    masks = torch.zeros_like(dist)
    masks[rows[:, None], topk] = 1.0
    return masks


class TopDownCaptioner(nn.Module):
    """GloVe words (300) and proposal features (128) -> a 512-d hidden
    state a word; the local-context query is the JAX module's default
    ``corner`` mode (:func:`query_local_masks`)."""

    def __init__(self, vocab_size: int = 3433, *, num_locals: int = -1,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.hidden_size = hidden_size = 512
        self.num_locals = num_locals
        self.word_proj = nn.Linear(300, 128, device=device)
        self.hidden_proj = nn.Linear(128, 128, device=device)
        self.map_previous = nn.Linear(128 + hidden_size + 128, hidden_size,
                                      device=device)
        self.obj_fc = nn.Linear(128, 128, device=device)
        self.obj_ln = nn.LayerNorm(128, eps=1e-5, device=device)
        self.query_proj = nn.Linear(hidden_size, 128, device=device)
        self.dec_att2 = MultiHeadAttention(128, 4, device=device)
        # the JAX step calls the attention deterministic, in training too
        self.dec_att2.dropout.p = 0.0
        self.map_lang = nn.Linear(128, hidden_size, device=device)
        self.classifier = nn.Linear(hidden_size, vocab_size, device=device)

    def forward(self, word_embs, target_feat, proposal_feats, corners,
                target_ids, object_masks):
        """word_embs (N, T, emb) teacher-forcing inputs, target_feat (N,
        feat), proposal_feats (N, K, feat), corners (N, K, 8, 3),
        target_ids (N,), object_masks (N, K) -> logits (N, T - 1, vocab)."""
        n, t, _ = word_embs.shape
        att_mask = None
        if self.num_locals > 0:
            att_mask = query_local_masks(
                corners, target_ids, object_masks,
                self.num_locals)[:, None, None, :]
        tf = self.hidden_proj(target_feat)
        pf = self.obj_ln(F.relu(self.obj_fc(proposal_feats)))
        words = self.word_proj(word_embs)
        hidden = word_embs.new_zeros(n, self.hidden_size)
        outs = []
        for i in range(t - 1):
            x = F.relu(self.map_previous(
                torch.cat([words[:, i], hidden, tf], dim=-1)))
            q = self.query_proj(x)[:, None, :]
            ctx = self.dec_att2(q, pf, pf, attention_mask=att_mask)[:, 0]
            hidden = self.map_lang(ctx)
            outs.append(self.classifier(hidden))
        return torch.stack(outs, dim=1)


class CapNet(nn.Module):
    """Weights start from :func:`~vlp3d_torch.models.jointnet.init_weights_`
    with seed 0. ``forward(batch, train=...)`` as JointNet's: ``batch``
    holds point_clouds, ref_center_label_list (B, L, 3) and lang_feat (B,
    L, T, E), the sos/eos-wrapped caption embeddings."""

    def __init__(self, config: Config, vocab_size: int = 3433, *,
                 num_locals: int = -1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        detection_stack(self, config, device)
        self.caption = TopDownCaptioner(vocab_size, num_locals=num_locals,
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
        b, l = batch["ref_center_label_list"].shape[:2]

        def per_sentence(x):  # (B, ...) -> (B * L, ...)
            return x[:, None].expand(b, l, *x.shape[1:]).reshape(
                b * l, *x.shape[1:])

        centers = per_sentence(out["aggregated_vote_xyz"])
        ref = batch["ref_center_label_list"][..., 0:3].reshape(b * l, 1, 3)
        _, _, _, idx2 = nn_distance(centers, ref)
        target_ids = idx2[:, 0].long()
        feats = per_sentence(out["bbox_feature"])
        target_feat = feats[torch.arange(b * l, device=feats.device),
                            target_ids]
        corners = per_sentence(get_3d_box_batch(
            out["pred_size"], out["pred_heading"], out["pred_center"]))
        obj_masks = per_sentence(out["objectness_masks"])
        word_embs = batch["lang_feat"].reshape(
            b * l, *batch["lang_feat"].shape[2:])
        out["lang_cap"] = self.caption(word_embs, target_feat, feats,
                                       corners, target_ids, obj_masks)
        out["good_bbox_masks"] = torch.ones(b * l, dtype=torch.bool,
                                            device=feats.device)
        return out
