"""JointNet for ScanRefer grounding, Scan2Cap captioning and ScanQA
question answering: inference and the joint train forward.

Counterpart of ``vlp3d/models/jointnet.py:118-280``: backbone -> voting
(votes L2-normalised) -> proposal -> relation -> BERT language branch ->
[masked LM] -> match -> contrast (OCC/OSC loss inputs; needs GT reference
boxes, so it is skipped at ``is_eval``, the serving case) -> [caption].
The caption branch (``no_caption=False``) is the teacher-forced decoder
over each sentence's object token, skipped at ``is_eval``: serving
decodes outside the module (:mod:`vlp3d_torch.models.caption`). The
masked-LM branch (``use_mlm``) runs in training only. The answer head
(``use_answer``) gives ``answer_scores`` (B*L, num_answers) from the
match module's ``cross_box_feature``, in training and at ``is_eval``.
The model options: ``compute_dtype`` (the backbone's point MLPs),
``use_vote_weight``, ``use_kl_loss`` and ``mask_box`` (the proposal
module; boxes are masked in training only, drawn from
``mask_generator``), ``reference_obj_gather`` (the relation module),
``use_distil`` and ``use_lang_classifier`` (the language module),
``use_lang_emb`` and ``use_reg_head`` (the match module), and
``no_reference``, the detection-only model: no ``lang``, ``match`` or
``constrast`` and no ``cluster_ref``. ``use_mlcv_net`` raises
NotImplementedError (:func:`vlp3d_torch.config.check_supported`).

Submodule names are the reference's (``backbone_net``, ``vgen``,
``proposal``, ``relation``, ``lang``, ``match``, ``constrast``: the
reference's spelling, ``caption``, ``mlm``, ``answer``), so
``load_state_dict(jax_to_torch_state_dict(...), strict=True)`` works. A
reference dict's dead early-guide decoder keys are dropped on load
(``_drop_dead_caption_keys``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vlp3d_torch.config import Config, check_supported
from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.answer import AnswerModule
from vlp3d_torch.models.backbone import PointNet2Backbone
from vlp3d_torch.models.bert import BertConfig, LangModule, distilbert_config
from vlp3d_torch.models.caption import (
    DEAD_KEYS,
    CaptionHead,
    causal_caption_mask,
    mask_caption_tokens,
    nearest_proposal_token,
    padding_caption_mask,
)
from vlp3d_torch.models.contrast import ContrastModule
from vlp3d_torch.models.layers import PReLU
from vlp3d_torch.models.match import MatchModule
from vlp3d_torch.models.proposal import ProposalModule
from vlp3d_torch.models.relation import RelationModule
from vlp3d_torch.models.voting import VotingModule, l2_normalize
from vlp3d_torch.parallel.reduce import LOCAL


class JointNet(nn.Module):
    """Weights start from :func:`init_weights_` with seed 0; load real
    ones with ``load_state_dict(..., strict=True)``. Every parameter is
    trainable except the frozen BERT text encoder. The module starts in
    evaluation mode; ``forward(batch, train=True)`` switches it (and back).
    ``mask_generator`` (a ``torch.Generator`` on the model's device, set by
    the train step; the global generator when None) draws the box masks
    and the caption and MLM token masks. Under data parallel
    (:func:`~vlp3d_torch.models.layers.set_batch_shard`) each draw is the
    global batch's and this rank keeps its rows: the token masks are
    drawn over the gathered ids of every rank.
    """

    shard = LOCAL

    def __init__(self, config: Config, *, device=None):
        super().__init__()
        check_supported(config)
        device = resolve_device(device)
        cfg, ds = config.model, config.dataset
        self.config = config
        self.backbone_net = PointNet2Backbone(
            cfg.input_feature_dim, npoints=tuple(cfg.sa_npoints),
            radii=tuple(cfg.sa_radii), nsamples=tuple(cfg.sa_nsamples),
            remat=cfg.remat, device=device,
            dtype=(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                   else None),
        )
        self.vgen = VotingModule(cfg.vote_factor, 256, device=device)
        self.proposal = ProposalModule(
            ds.num_class, ds.num_heading_bin, cfg.num_proposal,
            use_vote_weight=cfg.use_vote_weight, use_kl_loss=cfg.use_kl_loss,
            mask_box=cfg.mask_box, device=device)
        self.relation = RelationModule(
            det_channel=128, multiview_offset=cfg.multiview_offset,
            multiview_dim=cfg.multiview_dim,
            reference_obj_gather=cfg.reference_obj_gather, device=device,
        )
        if not cfg.no_reference:
            self.lang = LangModule(
                ds.num_class,
                bert_config=(distilbert_config() if cfg.use_distil else
                             BertConfig(fusion_layer=cfg.fusion_layer)),
                use_lang_classifier=cfg.use_lang_classifier, device=device,
            )
            self.match = MatchModule(
                num_proposals=cfg.num_proposal, use_lang_emb=cfg.use_lang_emb,
                use_reg_head=cfg.use_reg_head, device=device)
            if cfg.use_con:
                self.constrast = ContrastModule(device=device)
        if not cfg.no_caption:
            self.caption = CaptionHead(cfg.vocab_size, device=device)
        if cfg.use_mlm:
            self.mlm = CaptionHead(cfg.vocab_size, device=device)
        if cfg.use_answer:
            self.answer = AnswerModule(cfg.num_answers, device=device)
        self.mask_generator: torch.Generator | None = None
        self.register_buffer(
            "mean_size_arr",
            torch.from_numpy(ds.mean_size_arr()).to(device), persistent=False)
        init_weights_(self, 0)
        self.eval()
        self._register_load_state_dict_pre_hook(_drop_dead_caption_keys)

    def forward(self, batch: dict, *, train: bool = False,
                is_eval: bool = False) -> dict:
        """batch: point_clouds (B, N, 3+C) f32, input_ids and
        bert_attention_mask (B, L, T); with ``train`` also ``random`` (the
        step's shared uniform gate), and unless ``is_eval`` (with
        ``use_con``) the reference-box labels, ``lang_num`` and ``epoch``
        -> the JAX module's outputs.

        ``train`` puts every submodule in training mode (batch-statistic
        BatchNorm with running updates, dropout, the SA1 raw-row gather,
        copy-paste) and records a graph; without it the forward runs
        under no gradient.
        """
        if self.training != train:
            self.train(train)
        with torch.set_grad_enabled(train):
            return self._forward(batch, train, is_eval)

    def _forward(self, batch: dict, train: bool, is_eval: bool) -> dict:
        cfg = self.config.model
        out = dict(self.backbone_net(batch["point_clouds"]))
        seed_xyz, seed_features = out["fp2_xyz"], out["fp2_features"]
        out["seed_inds"] = out["fp2_inds"]
        out["seed_xyz"] = seed_xyz
        out["seed_features"] = seed_features

        vote_xyz, vote_features = self.vgen(seed_xyz, seed_features)
        vote_features = l2_normalize(vote_features)
        out["vote_xyz"] = vote_xyz
        out["vote_features"] = vote_features

        out.update(self.proposal(vote_xyz, vote_features,
                                 generator=self.mask_generator))
        out.update(self.relation(
            out["aggregated_vote_features"], out["pred_center"],
            out["pred_size"], out["pred_heading"], batch["point_clouds"],
            out["seed_inds"], out["aggregated_vote_inds"],
        ))
        if not cfg.no_reference:
            self._forward_reference(batch, out, train, is_eval)
        if not cfg.no_caption and not is_eval:
            out.update(self._forward_caption_train(batch, out, train))
        if cfg.use_answer:
            out["answer_scores"] = self.answer(out["cross_box_feature"])
        return out

    def _forward_reference(self, batch: dict, out: dict, train: bool,
                           is_eval: bool) -> None:
        """The language branch, the masked LM, the match module and the
        contrast head, into ``out``."""
        cfg = self.config.model
        out.update(self.lang(batch["input_ids"], batch["bert_attention_mask"]))
        if cfg.use_mlm and train and not is_eval:
            out.update(self._forward_mlm(batch, out))
        out.update(self.match(
            out["bbox_feature"], out["lang_fea"], out["objectness_masks"],
            lang_num_max=batch["input_ids"].shape[1],
            random_gate=batch.get("random"), lang_emb=out["lang_emb"],
        ))
        if cfg.use_con and not is_eval:
            gt_center, gt_size = ref_gt_boxes(batch, self.mean_size_arr)
            out.update(self.constrast(
                out["bbox_feature"], out["lang_emb"], out["pred_center"],
                out["pred_size"], gt_center, gt_size,
                out["objectness_masks"], batch["lang_num"], batch["epoch"],
            ))

    def _object_tokens(self, batch: dict, out: dict):
        return nearest_proposal_token(
            out["aggregated_vote_features"], out["aggregated_vote_xyz"],
            batch["ref_center_label_list"][..., 0:3])

    def _forward_caption_train(self, batch: dict, out: dict, train: bool):
        """Teacher-forced caption log-probs of every sentence slot from its
        object token; in training the input tokens are masked 80/10/10
        first."""
        ids = batch["input_ids"]
        b, l, t = ids.shape
        obj_token, match_idx, dist = self._object_tokens(batch, out)
        # the captioner reads des sequences capped at max_des_len + 2
        # (transformer_captioner.py trains on 32-token des ids, not the
        # 50-token BERT inputs)
        t_cap = min(t, self.config.model.max_des_len + 2)
        seq = ids.reshape(b * l, t)[:, :t_cap][:, :-1]
        if train:
            seq, _ = self._mask_tokens(seq)
        logp = self.caption.model(obj_token, seq, causal_caption_mask(seq))
        return {
            "lang_cap": logp[:, 1:],  # the object token's row dropped
            "match_idx": match_idx,
            # the reference's target_ious = chamfer dist > -1: always good
            "good_bbox_masks": dist > -1.0,
            "pred_ious": dist.mean(),
        }

    def _forward_mlm(self, batch: dict, out: dict):
        ids = batch["input_ids"]
        b, l, t = ids.shape
        obj_token, _, _ = self._object_tokens(batch, out)
        seq = ids.reshape(b * l, t)[:, :-1]
        mask_seq, mask_index = self._mask_tokens(seq)
        logp = self.mlm.model(obj_token, mask_seq,
                              padding_caption_mask(mask_seq))
        return {"lang_mlm": logp[:, 1:], "mlm_mask_index": mask_index}


    def _mask_tokens(self, seq: torch.Tensor):
        """:func:`mask_caption_tokens` of the token ids ``seq`` (rows of
        the global batch's ids under data parallel, this rank's rows
        kept)."""
        masked, index = mask_caption_tokens(
            self.shard.cat(seq), self.config.model.vocab_size,
            generator=self.mask_generator)
        return self.shard.own(masked), self.shard.own(index)


def _drop_dead_caption_keys(state_dict, prefix, *args):
    """The loader's one filter: a reference-layout dict's dead early-guide
    decoder entries (``src_attn``, ``sublayer.1``;
    ``export_jointnet_state_dict`` writes them as zero attention and
    identity norms) have no module here, so they are removed in place."""
    heads = (f"{prefix}caption.model.", f"{prefix}mlm.model.")
    for key in [k for k in state_dict if k.startswith(heads)]:
        if any(s in key for s in DEAD_KEYS):
            del state_dict[key]


def ref_gt_boxes(batch: dict, mean_size_arr: torch.Tensor):
    """Per-sentence GT reference boxes: center, and mean_size[class] +
    residual (param2obb_batch_tensor, model_util_scannet.py:187-190)."""
    gt_center = batch["ref_center_label_list"][..., 0:3]
    gt_size = (mean_size_arr[batch["ref_size_class_label_list"].long()]
               + batch["ref_size_residual_label_list"])
    return gt_center, gt_size


def init_weights_(module: nn.Module, seed: int) -> None:
    """Fill every parameter and BN statistic from a numpy generator seeded
    with ``seed``, in state-dict order: fan-in-scaled normal weights,
    small biases, unit-ish norm scales, random BN running statistics
    (so a random model exercises the BN arithmetic). The caption
    decoders' sin/cos position table keeps its values."""
    rng = np.random.default_rng(seed)
    named = dict(module.named_modules())
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            owner, _, leaf = name.rpartition(".")
            mod = named[owner]
            shape = tuple(t.shape)
            if leaf in ("num_batches_tracked", "position_ids", "pe"):
                continue
            if leaf == "running_mean":
                v = rng.normal(0.0, 0.1, shape)
            elif leaf == "running_var":
                v = rng.uniform(0.5, 1.5, shape)
            elif isinstance(mod, nn.Embedding):
                v = rng.normal(0.0, 0.02, shape)
            elif leaf in ("bias", "b_2") or leaf.startswith("bias_"):
                v = rng.normal(0.0, 0.01, shape)
            elif t.dim() == 1:  # LayerNorm / BN scales, PReLU slopes
                base = 0.25 if isinstance(mod, PReLU) else 1.0
                v = base + rng.normal(0.0, 0.05, shape)
            else:
                fan_in = int(np.prod(shape[1:]))
                v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
            t.copy_(torch.from_numpy(v.astype(np.float32)))
