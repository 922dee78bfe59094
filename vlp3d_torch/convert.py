"""JAX (flax) trees -> the port's reference-layout state dict.

The port's own copy of the numpy export code in
``vlp3d/models/torch_export.py``, restricted to the submodules the port
has (backbone, voting, proposal, relation, BERT text mode, match,
contrast, the caption and MLM decoders, the answer head), and the
converters of the single-task models: ScanQA with MCAN (the LSTM
language encoder, the MCAN encoder-decoder, the masked AttFlat pools,
the VoteNet head), RefNet and CapNet (the top-down captioner), and the
variant and dormant modules: MLCVNet's CGNL voting (inside JointNet's
``vgen``) and detector, the DETR proposal head, the xbert captioner, the
cross-modal MLM and ENet. Takes the flax ``params`` and ``batch_stats``
as nested dicts of numpy arrays and returns a dict of CPU tensors that
the port's model accepts with ``load_state_dict(sd, strict=True)``:
``jax_to_torch_state_dict`` for JointNet, ``scanqa_to_torch_state_dict``,
``refnet_to_torch_state_dict``, ``capnet_to_torch_state_dict``,
``mlcvnet_detector_to_torch_state_dict``, ``detr_to_torch_state_dict``,
``caption_xbert_to_torch_state_dict``,
``lang_cross_mlm_to_torch_state_dict`` and ``enet_to_torch_state_dict``. JointNet's key names are the
reference 3DVLP checkpoint's, so the port loads those checkpoints too.

Layouts: a flax Dense kernel (in, out) becomes a Linear weight (out, in)
or a k=1 conv weight (out, in, 1[, 1]); flax BatchNorm params + stats
become weight/bias/running_mean/running_var + num_batches_tracked=0; the
SA first layer's split ``first_xyz``/``first_feat`` kernels are joined
into one conv weight over [xyz_rel, features]; a PReLU keeps its slope a
channel (the JAX export, ``torch_export.py``, writes the mean where the
reference declares one slope; the port computes what JAX computes, so it
keeps them all).

Every ``convert_*`` function takes the module's subtree and writes into
``out`` under ``prefix`` (empty, or ending in ".").
"""

from __future__ import annotations

import numpy as np
import torch

from vlp3d_torch.models.caption import PE_ROWS, sinusoidal_positions

__all__ = ["jax_to_torch_state_dict", "scanqa_to_torch_state_dict",
           "refnet_to_torch_state_dict", "capnet_to_torch_state_dict",
           "mlcvnet_detector_to_torch_state_dict", "detr_to_torch_state_dict",
           "caption_xbert_to_torch_state_dict",
           "lang_cross_mlm_to_torch_state_dict", "enet_to_torch_state_dict",
           "pillar_encoder_to_torch_state_dict"]


def _f32(v) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(v), dtype=np.float32)


def conv_weight(kernel, rank: int) -> np.ndarray:
    """Dense kernel (in, out) -> conv k=1 weight (out, in, 1[, 1])."""
    w = _f32(kernel).T
    return np.ascontiguousarray(w.reshape(w.shape + (1,) * rank))


def dense(p, name: str, out: dict):
    """Dense -> Conv1d k=1 (weight (out, in, 1))."""
    out[name + ".weight"] = conv_weight(p["kernel"], 1)
    if "bias" in p:
        out[name + ".bias"] = _f32(p["bias"])


def bn(params, stats, name: str, out: dict):
    out[name + ".weight"] = _f32(params["scale"])
    out[name + ".bias"] = _f32(params["bias"])
    out[name + ".running_mean"] = _f32(stats["mean"])
    out[name + ".running_var"] = _f32(stats["var"])
    out[name + ".num_batches_tracked"] = np.array(0, dtype=np.int64)


def lin(p, name: str, out: dict):
    out[name + ".weight"] = np.ascontiguousarray(_f32(p["kernel"]).T)
    if "bias" in p:
        out[name + ".bias"] = _f32(p["bias"])


def ln(p, name: str, out: dict):
    out[name + ".weight"] = _f32(p["scale"])
    out[name + ".bias"] = _f32(p["bias"])


def convert_sa(params, stats, prefix: str, out: dict):
    """SAModule -> PointnetSAModuleVotes keys (SharedMLP Conv2d, no bias)."""
    w0 = np.concatenate([_f32(params["first_xyz"]["kernel"]),
                         _f32(params["first_feat"]["kernel"])], axis=0)
    out[f"{prefix}mlp_module.layer0.conv.weight"] = conv_weight(w0, 2)
    bn(params["BatchNorm_0"], stats["BatchNorm_0"],
       f"{prefix}mlp_module.layer0.bn.bn", out)
    pm, sm = params["PointMLP_0"], stats["PointMLP_0"]
    j = 1
    while f"Dense_{j - 1}" in pm:
        out[f"{prefix}mlp_module.layer{j}.conv.weight"] = conv_weight(
            pm[f"Dense_{j - 1}"]["kernel"], 2)
        bn(pm[f"BatchNorm_{j - 1}"], sm[f"BatchNorm_{j - 1}"],
           f"{prefix}mlp_module.layer{j}.bn.bn", out)
        j += 1


def convert_point_mlp(pm, sm, prefix: str, out: dict):
    """PointMLP -> SharedMLP keys (``prefix`` + layer{j}...)."""
    i = 0
    while f"Dense_{i}" in pm:
        out[f"{prefix}layer{i}.conv.weight"] = conv_weight(
            pm[f"Dense_{i}"]["kernel"], 2)
        bn(pm[f"BatchNorm_{i}"], sm[f"BatchNorm_{i}"],
           f"{prefix}layer{i}.bn.bn", out)
        i += 1


def convert_fp(params, stats, prefix: str, out: dict):
    convert_point_mlp(params["PointMLP_0"], stats["PointMLP_0"],
                      f"{prefix}mlp.", out)


def convert_backbone(params, stats, prefix: str, out: dict):
    for sa in ("sa1", "sa2", "sa3", "sa4"):
        convert_sa(params[sa], stats[sa], f"{prefix}{sa}.", out)
    for fp in ("fp1", "fp2"):
        convert_fp(params[fp], stats[fp], f"{prefix}{fp}.", out)


def convert_cgnl(params, prefix: str, out: dict):
    """SpatialCGNL -> the reference's ``t``, ``p``, ``g`` (Conv2d 1x1,
    no bias), ``z`` and ``gn``. JAX's ``z_kernel`` (groups, gc, out / groups)
    becomes the grouped conv's (out, gc, 1, 1) weight, output channel
    ``g * (out / groups) + o`` reading group ``g``."""
    for name in ("t", "p", "g"):
        out[f"{prefix}{name}.weight"] = conv_weight(params[name]["kernel"], 2)
    zk = _f32(params["z_kernel"])
    groups, gc, og = zk.shape
    out[f"{prefix}z.weight"] = np.ascontiguousarray(
        zk.transpose(0, 2, 1).reshape(groups * og, gc, 1, 1))
    ln(params["GroupNorm_0"], f"{prefix}gn", out)


def convert_voting(params, stats, prefix: str, out: dict):
    """VotingModule, or MLCVVotingModule with its CGNL block (``cgnl``,
    the reference's ``sa1``). JAX's ``export_jointnet_state_dict`` drops
    that block (ROADMAP C20); this converter carries it."""
    if "cgnl" in params:
        convert_cgnl(params["cgnl"], f"{prefix}sa1.", out)
    for i, (conv, bnn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        dense(params[f"Dense_{i}"], f"{prefix}{conv}", out)
        bn(params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"],
           f"{prefix}{bnn}", out)
    dense(params["Dense_2"], f"{prefix}conv3", out)


def convert_proposal(params, stats, prefix: str, out: dict):
    if "Dense_0" in params:  # use_vote_weight
        q = f"{prefix}votes_weight_predictor."
        dense(params["Dense_0"], q + "0", out)
        bn(params["BatchNorm_0"], stats["BatchNorm_0"], q + "1", out)
        out[q + "2.weight"] = _f32(params["PReLU_0"]["alpha"])
        dense(params["Dense_1"], q + "3", out)
    convert_sa(params["vote_aggregation"], stats["vote_aggregation"],
               f"{prefix}vote_aggregation.", out)
    rp, rs = params["roi_heads"], stats["roi_heads"]
    q = f"{prefix}proposal."
    dense(rp["Dense_0"], q + "convs.0", out)
    bn(rp["BatchNorm_0"], rs["BatchNorm_0"], q + "convs.1", out)
    dense(rp["Dense_1"], q + "convs.3", out)
    bn(rp["BatchNorm_1"], rs["BatchNorm_1"], q + "convs.4", out)
    dense(rp["Dense_2"], q + "objectness_predictor", out)
    dense(rp["Dense_3"], q + "box_predictor", out)
    dense(rp["Dense_4"], q + "heading_cls_predictor", out)
    dense(rp["Dense_5"], q + "heading_reg_predictor", out)
    dense(rp["Dense_6"], q + "sem_cls_predictor", out)
    if "Dense_7" in rp:
        dense(rp["Dense_7"], q + "alpha_predictor", out)


def convert_mha(p, prefix: str, out: dict):
    for fc in ("fc_q", "fc_k", "fc_v", "fc_o"):
        lin(p[fc], f"{prefix}attention.{fc}", out)
    ln(p["LayerNorm_0"], f"{prefix}layer_norm", out)


def convert_decoder_layer(p, prefix: str, out: dict):
    convert_mha(p["self_attention"], f"{prefix}self_attention.", out)
    convert_mha(p["enc_dec_attention"], f"{prefix}enc_dec_attention.", out)
    lin(p["ffn"]["Dense_0"], f"{prefix}ffn.linear1", out)
    lin(p["ffn"]["Dense_1"], f"{prefix}ffn.linear2", out)
    ln(p["LayerNorm_0"], f"{prefix}norm", out)


def convert_relation(params, stats, prefix: str, out: dict):
    q = f"{prefix}features_concat."
    dense(params["Dense_0"], q + "0", out)
    bn(params["BatchNorm_0"], stats["BatchNorm_0"], q + "1", out)
    out[q + "2.weight"] = _f32(params["PReLU_0"]["alpha"])
    dense(params["Dense_1"], q + "3", out)
    i = 0
    while f"self_attn_{i}" in params:
        for j, idx in enumerate((0, 3, 6)):
            lin(params[f"attn_fc{i}_{j}"],
                f"{prefix}self_attn_fc.{i}.{idx}", out)
        for j, idx in enumerate((2, 5)):
            ln(params[f"attn_ln{i}_{j}"], f"{prefix}self_attn_fc.{i}.{idx}",
               out)
        convert_mha(params[f"self_attn_{i}"], f"{prefix}self_attn.{i}.", out)
        lin(params[f"obj_embedding_{i}"], f"{prefix}obj_embedding.{i}", out)
        lin(params[f"bbox_embedding_{i}"], f"{prefix}bbox_embedding.{i}", out)
        i += 1


def convert_embeddings(e, prefix: str, out: dict):
    """BertEmbeddings -> ``prefix`` + word / position / token-type tables,
    LayerNorm and the ``position_ids`` buffer."""
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        if name in e:  # DistilBERT has no token-type table
            out[f"{prefix}{name}.weight"] = _f32(e[name]["embedding"])
    ln(e["LayerNorm"], f"{prefix}LayerNorm", out)
    max_pos = np.asarray(e["position_embeddings"]["embedding"]).shape[0]
    out[f"{prefix}position_ids"] = np.arange(max_pos, dtype=np.int64)[None, :]


def convert_bert_layer(lp, prefix: str, out: dict):
    """BertLayer (or a BertFusionLayer's ``self`` sublayer, without the
    feed-forward) -> xbert keys under ``prefix``."""
    lin(lp["query"], f"{prefix}attention.self.query", out)
    lin(lp["key"], f"{prefix}attention.self.key", out)
    lin(lp["value"], f"{prefix}attention.self.value", out)
    lin(lp["attention_output"], f"{prefix}attention.output.dense", out)
    ln(lp["attention_LayerNorm"], f"{prefix}attention.output.LayerNorm", out)
    if "intermediate" in lp:
        lin(lp["intermediate"], f"{prefix}intermediate.dense", out)
        lin(lp["output"], f"{prefix}output.dense", out)
        ln(lp["output_LayerNorm"], f"{prefix}output.LayerNorm", out)


def convert_fusion_layer(lp, prefix: str, out: dict):
    """BertFusionLayer -> its self-attention sublayer, ``crossattention``
    (xq / xk / xv / xout / xln) and the feed-forward, in xbert's keys."""
    convert_bert_layer(lp["self"], prefix, out)
    q = f"{prefix}crossattention."
    lin(lp["xq"], f"{q}self.query", out)
    lin(lp["xk"], f"{q}self.key", out)
    lin(lp["xv"], f"{q}self.value", out)
    lin(lp["xout"], f"{q}output.dense", out)
    ln(lp["xln"], f"{q}output.LayerNorm", out)
    lin(lp["intermediate"], f"{prefix}intermediate.dense", out)
    lin(lp["output"], f"{prefix}output.dense", out)
    ln(lp["output_LayerNorm"], f"{prefix}output.LayerNorm", out)


def convert_text_encoder(params, prefix: str, out: dict):
    """BertTextEncoder text-mode tree -> xbert keys under ``prefix``bert."""
    p = f"{prefix}bert."
    convert_embeddings(params["embeddings"], f"{p}embeddings.", out)
    i = 0
    while f"layer_{i}" in params:
        convert_bert_layer(params[f"layer_{i}"], f"{p}encoder.layer.{i}.",
                           out)
        i += 1


def convert_lang(params, prefix: str, out: dict):
    convert_text_encoder(params["text_encoder"], f"{prefix}text_encoder.",
                         out)
    lin(params["proj"], f"{prefix}proj", out)
    if "lang_cls" in params:
        lin(params["lang_cls"], f"{prefix}lang_cls.0", out)


def convert_match(params, prefix: str, out: dict, stats=None):
    """MatchModule -> ``match.{0,3,6}``, the cross-attention layers and,
    where the tree has them, ``lang_emb_cross_attn`` / ``lang_emb_proj``
    (convs) and ``reg_head`` (linears), whose BatchNorms read ``stats``.
    flax numbers the Dense and BatchNorm modules in call order: the
    lang-emb branch (it has ``prelu0``) takes Dense_3-5 and BatchNorm_0-1,
    the regression head the next three and two."""
    for i, idx in enumerate((0, 3, 6)):
        lin(params[f"Dense_{i}"], f"{prefix}match.{idx}", out)
    d = n = 0
    if "prelu0" in params:  # use_lang_emb
        convert_mha(params["lang_emb_cross_attn"],
                    f"{prefix}lang_emb_cross_attn.", out)
        q = f"{prefix}lang_emb_proj."
        for j, idx in enumerate((0, 3, 6)):
            dense(params[f"Dense_{3 + j}"], f"{q}{idx}", out)
        for j, idx in enumerate((1, 4)):
            bn(params[f"BatchNorm_{j}"], stats[f"BatchNorm_{j}"], f"{q}{idx}",
               out)
            out[f"{q}{idx + 1}.weight"] = _f32(params[f"prelu{j}"]["alpha"])
        d, n = 3, 2
    if f"Dense_{3 + d}" in params:  # use_reg_head
        q = f"{prefix}reg_head."
        for j, idx in enumerate((0, 3, 6)):
            lin(params[f"Dense_{3 + d + j}"], f"{q}{idx}", out)
        for j, idx in enumerate((1, 4)):
            bn(params[f"BatchNorm_{n + j}"], stats[f"BatchNorm_{n + j}"],
               f"{q}{idx}", out)
    i = 0
    while f"grounding_cross_attn_{i}" in params:
        convert_decoder_layer(params[f"grounding_cross_attn_{i}"],
                              f"{prefix}grounding_cross_attn.{i}.", out)
        i += 1


def convert_contrast(params, prefix: str, out: dict):
    """ContrastModule -> the reference's keys: bias-free linears
    (``pc_proj_iou`` sits in a Sequential) and ``nce_loss.tau``."""
    lin(params["pc_proj"], f"{prefix}pc_proj", out)
    lin(params["text_proj"], f"{prefix}text_proj", out)
    lin(params["pc_proj_iou"], f"{prefix}pc_proj_iou.0", out)
    out[f"{prefix}nce_loss.tau"] = _f32(params["tau"])


def ref_norm(p, name: str, out: dict):
    """RefLayerNorm (the annotated transformer's a_2 / b_2 naming)."""
    out[name + ".a_2"] = _f32(p["scale"])
    out[name + ".b_2"] = _f32(p["bias"])


def convert_caption(params, prefix: str, out: dict):
    """CaptionDecoder -> TransformerDecoderModel keys under ``prefix``
    (``caption.model.`` / ``mlm.model.``), as
    ``export_caption_state_dict`` writes them but without the dead
    early-guide entries (``src_attn``, ``sublayer.1``), which the port's
    decoder has no module for."""
    emb = _f32(params["embed"]["embedding"])
    out[prefix + "tgt_embed.0.lut.weight"] = emb
    out[prefix + "tgt_embed.1.pe"] = sinusoidal_positions(
        PE_ROWS, emb.shape[1])[None]
    ref_norm(params["final_ln"], prefix + "decoder.norm", out)
    lin(params["generator"], prefix + "generator.proj", out)
    i = 0
    while f"layer_{i}" in params:
        lp, q = params[f"layer_{i}"], f"{prefix}decoder.layers.{i}"
        ref_norm(lp["ln_attn"], f"{q}.sublayer.0.norm", out)
        ref_norm(lp["ln_ffn"], f"{q}.sublayer.2.norm", out)
        for j, k in enumerate(("q", "k", "v", "o")):
            lin(lp["self_attn"][k], f"{q}.self_attn.linears.{j}", out)
        lin(lp["ffn1"], f"{q}.feed_forward.w_1", out)
        lin(lp["ffn2"], f"{q}.feed_forward.w_2", out)
        i += 1


def convert_attflat(params, prefix: str, out: dict):
    """AttFlat -> MCAN's keys: ``mlp.fc.linear``, ``mlp.linear``,
    ``linear_merge``."""
    lin(params["Dense_0"], f"{prefix}mlp.fc.linear", out)
    lin(params["Dense_1"], f"{prefix}mlp.linear", out)
    lin(params["linear_merge"], f"{prefix}linear_merge", out)


def convert_answer(params, prefix: str, out: dict):
    """AnswerModule -> ``attflat_visual`` and the ``answer_cls``
    Sequential (linears at 0 and 3)."""
    convert_attflat(params["attflat_visual"], f"{prefix}attflat_visual.", out)
    lin(params["Dense_0"], f"{prefix}answer_cls.0", out)
    lin(params["Dense_1"], f"{prefix}answer_cls.3", out)


def convert_lstm_lang(params, prefix: str, out: dict):
    """LSTMLangModule -> ``lstm.{weight_ih,weight_hh,bias_hh}_l0[_reverse]``
    and ``lang_cls.1``. flax writes the cells at ``OptimizedLSTMCell_0``
    (forward) and ``OptimizedLSTMCell_1`` (backward), input kernels
    ``ii/if/ig/io`` (no bias) and hidden ``hi/hf/hg/ho`` (with bias);
    torch's layout stacks the gates i, f, g, o along the rows."""
    for cell, sfx in (("OptimizedLSTMCell_0", ""),
                      ("OptimizedLSTMCell_1", "_reverse")):
        if cell not in params:
            continue
        c = params[cell]
        out[f"{prefix}lstm.weight_ih_l0{sfx}"] = np.ascontiguousarray(
            np.concatenate([_f32(c[g]["kernel"]) for g in
                            ("ii", "if", "ig", "io")], axis=1).T)
        out[f"{prefix}lstm.weight_hh_l0{sfx}"] = np.ascontiguousarray(
            np.concatenate([_f32(c[g]["kernel"]) for g in
                            ("hi", "hf", "hg", "ho")], axis=1).T)
        out[f"{prefix}lstm.bias_hh_l0{sfx}"] = np.concatenate(
            [_f32(c[g]["bias"]) for g in ("hi", "hf", "hg", "ho")])
    if "Dense_0" in params:
        lin(params["Dense_0"], f"{prefix}lang_cls.1", out)


def convert_mcan(params, prefix: str, out: dict):
    """MCAN_ED -> ``enc_list.{i}`` (SA: mhatt, norm1, ffn, norm2) and
    ``dec_list.{i}`` (SGA: mhatt1, mhatt2, norm1-3, ffn)."""
    def mhatt(p, q):
        for name in ("linear_v", "linear_k", "linear_q", "linear_merge"):
            lin(p[name], f"{q}{name}", out)

    def ffn(p, q):
        lin(p["Dense_0"], f"{q}mlp.fc.linear", out)
        lin(p["Dense_1"], f"{q}mlp.linear", out)

    for kind, n_att in (("enc", 1), ("dec", 2)):
        i = 0
        while f"{kind}_{i}" in params:
            lp, q = params[f"{kind}_{i}"], f"{prefix}{kind}_list.{i}."
            for j in range(n_att):
                mhatt(lp[f"MHAtt_{j}"],
                      f"{q}mhatt{'' if n_att == 1 else j + 1}.")
            for j in range(n_att + 1):
                ref_norm(lp[f"RefLayerNorm_{j}"], f"{q}norm{j + 1}", out)
            ffn(lp["FFN_0"], f"{q}ffn.")
            i += 1


def convert_votenet_head(params, stats, prefix: str, out: dict):
    """VoteNetProposalModule -> ``vote_aggregation``, ``conv1-3``,
    ``bn1-2``."""
    convert_sa(params["vote_aggregation"], stats["vote_aggregation"],
               f"{prefix}vote_aggregation.", out)
    for i in range(3):
        dense(params[f"Dense_{i}"], f"{prefix}conv{i + 1}", out)
    for i in range(2):
        bn(params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"],
           f"{prefix}bn{i + 1}", out)


def scanqa_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX ScanQA (params, batch_stats) -> the port's ScanQA state dict
    (a gradient tree converts the same way)."""
    p, st = dict(params), dict(batch_stats)
    sd: dict = {}
    convert_lstm_lang(p["lang_net"], "lang_net.", sd)
    convert_backbone(p["detection_backbone"], st["detection_backbone"],
                     "detection_backbone.", sd)
    convert_voting(p["voting_net"], st["voting_net"], "voting_net.", sd)
    convert_votenet_head(p["proposal_net"], st["proposal_net"],
                         "proposal_net.", sd)
    lin(p["lang_feat_linear"], "lang_feat_linear.0", sd)
    lin(p["object_feat_linear"], "object_feat_linear.0", sd)
    convert_mcan(p["fusion_backbone"], "fusion_backbone.", sd)
    for head in ("object_cls", "lang_cls", "answer_cls"):
        if f"{head}_0" in p:
            lin(p[f"{head}_0"], f"{head}.0", sd)
            lin(p[f"{head}_1"], f"{head}.3", sd)
    convert_attflat(p["attflat_lang"], "attflat_lang.", sd)
    convert_attflat(p["attflat_visual"], "attflat_visual.", sd)
    ref_norm(p["fusion_norm"], "fusion_norm", sd)
    return to_tensors(sd)


def _detection_stack(p, st, sd):
    convert_backbone(p["backbone_net"], st["backbone_net"], "backbone_net.",
                     sd)
    convert_voting(p["vgen"], st["vgen"], "vgen.", sd)
    convert_proposal(p["proposal"], st["proposal"], "proposal.", sd)
    convert_relation(p["relation"], st["relation"], "relation.", sd)


def refnet_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX RefNet (params, batch_stats) -> the port's RefNet state dict."""
    p, st = dict(params), dict(batch_stats)
    sd: dict = {}
    _detection_stack(p, st, sd)
    convert_lstm_lang(p["lang"], "lang.", sd)
    lin(p["lang_proj"], "lang_proj", sd)
    lin(p["lang_emb_proj"], "lang_emb_proj", sd)
    convert_match(p["match"], "match.", sd, stats=st.get("match", {}))
    return to_tensors(sd)


def capnet_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX CapNet (params, batch_stats) -> the port's CapNet state dict."""
    p, st = dict(params), dict(batch_stats)
    sd: dict = {}
    _detection_stack(p, st, sd)
    c, q = p["caption"], "caption."
    for name in ("word_proj", "hidden_proj", "map_previous", "obj_fc",
                 "query_proj", "map_lang", "classifier"):
        lin(c[name], q + name, sd)
    ln(c["obj_ln"], q + "obj_ln", sd)
    convert_mha(c["dec_att2"], q + "dec_att2.", sd)
    return to_tensors(sd)


def mlcvnet_detector_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX MLCVNetDetector -> the port's: ``backbone_net``, ``vgen`` (with
    its CGNL), and ``pnet`` (``vote_aggregation``, ``cgnl1-2``, the
    head's bias-free ``conv0-1`` as ``conv1-2``, ``bn0-1`` as ``bn1-2``,
    ``predictor`` as ``conv3``)."""
    p, st = dict(params), dict(batch_stats)
    sd: dict = {}
    convert_backbone(p["backbone_net"], st["backbone_net"], "backbone_net.",
                     sd)
    convert_voting(p["vgen"], st["vgen"], "vgen.", sd)
    convert_sa(p["vote_aggregation"], st["vote_aggregation"],
               "pnet.vote_aggregation.", sd)
    for name in ("cgnl1", "cgnl2"):
        convert_cgnl(p[name], f"pnet.{name}.", sd)
    for i in range(2):
        dense(p[f"conv{i}"], f"pnet.conv{i + 1}", sd)
        bn(p[f"bn{i}"], st[f"bn{i}"], f"pnet.bn{i + 1}", sd)
    dense(p["predictor"], "pnet.conv3", sd)
    return to_tensors(sd)


def detr_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX DETRProposalModule -> the port's (the same names; ``layer_{i}``
    as ``layers.{i}``, each attention's ``LayerNorm_0`` as ``norm``)."""
    p, st = dict(params), dict(batch_stats)
    sd: dict = {}
    convert_sa(p["vote_aggregation"], st["vote_aggregation"],
               "vote_aggregation.", sd)
    for i in (1, 2):
        dense(p[f"conv{i}"], f"conv{i}", sd)
        bn(p[f"bn{i}"], st[f"bn{i}"], f"bn{i}", sd)
    for name in ("input_proj", "hidden_ffn", "class_head", "bbox_mlp0",
                 "bbox_mlp1"):
        lin(p[name], name, sd)
    for name in ("decoder_norm", "hidden_norm"):
        ln(p[name], name, sd)
    i = 0
    while f"layer_{i}" in p:
        lp, q = p[f"layer_{i}"], f"layers.{i}."
        for att in ("self_attn", "multihead_attn"):
            for fc in ("fc_q", "fc_k", "fc_v", "fc_o"):
                lin(lp[att][fc], f"{q}{att}.{fc}", sd)
            ln(lp[att]["LayerNorm_0"], f"{q}{att}.norm", sd)
        for name in ("linear_offset", "linear1", "linear2"):
            lin(lp[name], q + name, sd)
        ln(lp["norm3"], q + "norm3", sd)
        i += 1
    return to_tensors(sd)


def caption_xbert_to_torch_state_dict(params) -> dict:
    """JAX CaptionModuleX -> the port's: ``embeddings``, the decoder's
    ``layer.{i}`` in xbert's keys and its LM head ``cls`` (``transform``,
    ``ln`` as ``transform.LayerNorm``, ``decoder``)."""
    p = dict(params)
    sd: dict = {}
    convert_embeddings(p["embeddings"], "embeddings.", sd)
    dec = p["decoder"]
    i = 0
    while f"layer_{i}" in dec:
        convert_fusion_layer(dec[f"layer_{i}"], f"decoder.layer.{i}.", sd)
        i += 1
    lin(dec["cls"]["transform"], "decoder.cls.transform.dense", sd)
    ln(dec["cls"]["ln"], "decoder.cls.transform.LayerNorm", sd)
    lin(dec["cls"]["decoder"], "decoder.cls.decoder", sd)
    return to_tensors(sd)


def lang_cross_mlm_to_torch_state_dict(params) -> dict:
    """JAX LangCrossMLM -> the port's: ``text_encoder`` (xbert keys),
    ``proj``, ``pc_proj``, ``cross_attn.{i}`` and ``prediction``
    (PredictionHead's Dense_0 / LayerNorm_0 / Dense_1 as ``dense``,
    ``layer_norm``, ``decoder``)."""
    p = dict(params)
    sd: dict = {}
    convert_text_encoder(p["text_encoder"], "text_encoder.", sd)
    lin(p["proj"], "proj", sd)
    lin(p["pc_proj"], "pc_proj", sd)
    i = 0
    while f"cross_attn_{i}" in p:
        convert_mha(p[f"cross_attn_{i}"], f"cross_attn.{i}.", sd)
        i += 1
    head = p["prediction"]
    lin(head["Dense_0"], "prediction.dense", sd)
    ln(head["LayerNorm_0"], "prediction.layer_norm", sd)
    lin(head["Dense_1"], "prediction.decoder", sd)
    return to_tensors(sd)


def enet_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX ENetEncoder -> the port's: ``initial``, ``blocks.{i}`` for
    ``block{i}`` and ``classifier``; a flax conv kernel (kh, kw, in, out)
    becomes a Conv2d weight (out, in, kh, kw)."""
    sd: dict = {}

    def walk(p, st, prefix):
        for name, node in p.items():
            q = f"{prefix}{name}"
            if "kernel" in node:
                sd[f"{q}.weight"] = np.ascontiguousarray(
                    _f32(node["kernel"]).transpose(3, 2, 0, 1))
                if "bias" in node:
                    sd[f"{q}.bias"] = _f32(node["bias"])
            elif "alpha" in node:
                sd[f"{q}.weight"] = _f32(node["alpha"])
            elif "scale" in node:
                bn(node, st[name], q, sd)
            else:
                walk(node, st.get(name, {}), q + ".")

    p, st = dict(params), dict(batch_stats)
    walk({"initial": p["initial"]}, st, "")
    i = 0
    while f"block{i}" in p:
        walk(p[f"block{i}"], st[f"block{i}"], f"blocks.{i}.")
        i += 1
    if "classifier" in p:
        walk({"classifier": p["classifier"]}, st, "")
    return to_tensors(sd)


def pillar_encoder_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX PillarEncoder -> the port's: ``Dense_0`` (9, 64) becomes
    ``conv.weight`` (64, 9, 1), ``BatchNorm_0`` ``bn.*``."""
    sd: dict = {}
    dense(params["Dense_0"], "conv", sd)
    bn(params["BatchNorm_0"], batch_stats["BatchNorm_0"], "bn", sd)
    return to_tensors(sd)


def to_tensors(sd: dict) -> dict:
    # np.array copies: flax leaves may be read-only views
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def jax_to_torch_state_dict(params, batch_stats) -> dict:
    """JAX JointNet (params, batch_stats) -> the port's JointNet state dict.

    Every head the tree holds is carried, the answer head (VQA) included.
    A gradient tree has the parameters' structure and converts the same
    way (pass the parameters' ``batch_stats`` for the statistics' slots;
    the caption decoders' ``pe`` slot holds the position table).
    """
    params, stats = dict(params), dict(batch_stats)
    sd: dict = {}
    convert_backbone(params["backbone_net"], stats["backbone_net"],
                     "backbone_net.", sd)
    convert_voting(params["vgen"], stats["vgen"], "vgen.", sd)
    convert_proposal(params["proposal"], stats["proposal"], "proposal.", sd)
    convert_relation(params["relation"], stats["relation"], "relation.", sd)
    if "lang" in params:
        convert_lang(params["lang"], "lang.", sd)
    if "match" in params:
        convert_match(params["match"], "match.", sd,
                      stats=stats.get("match", {}))
    if "constrast" in params:  # the reference's spelling
        convert_contrast(params["constrast"], "constrast.", sd)
    for head in ("caption", "mlm"):
        if head in params:
            convert_caption(params[head], f"{head}.model.", sd)
    if "answer" in params:
        convert_answer(params["answer"], "answer.", sd)
    return to_tensors(sd)
