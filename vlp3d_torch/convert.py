"""JAX (flax) trees -> the port's reference-layout state dict.

The port's own copy of the numpy export code in
``vlp3d/models/torch_export.py``, restricted to the submodules the port
has (backbone, voting, proposal, relation, BERT text mode, match,
contrast, the caption and MLM decoders, the answer head). Takes the flax
``params`` and ``batch_stats`` as nested dicts of numpy arrays and
returns a dict of CPU tensors that
``vlp3d_torch.models.JointNet.load_state_dict(sd, strict=True)`` accepts.
The key names are the reference 3DVLP checkpoint's, so the port loads
those checkpoints too.

Layouts: a flax Dense kernel (in, out) becomes a Linear weight (out, in)
or a k=1 conv weight (out, in, 1[, 1]); flax BatchNorm params + stats
become weight/bias/running_mean/running_var + num_batches_tracked=0; the
SA first layer's split ``first_xyz``/``first_feat`` kernels are joined
into one conv weight over [xyz_rel, features].

Every ``convert_*`` function takes the module's subtree and writes into
``out`` under ``prefix`` (empty, or ending in ".").
"""

from __future__ import annotations

import numpy as np
import torch

from vlp3d_torch.models.caption import PE_ROWS, sinusoidal_positions

__all__ = ["jax_to_torch_state_dict"]


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


def convert_voting(params, stats, prefix: str, out: dict):
    for i, (conv, bnn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        dense(params[f"Dense_{i}"], f"{prefix}{conv}", out)
        bn(params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"],
           f"{prefix}{bnn}", out)
    dense(params["Dense_2"], f"{prefix}conv3", out)


def convert_proposal(params, stats, prefix: str, out: dict):
    if "Dense_0" in params:
        raise NotImplementedError(
            "use_vote_weight trees are not ported yet; see ROADMAP.md "
            "queue A item 9a (options of slice 1)")
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


def convert_text_encoder(params, prefix: str, out: dict):
    """BertTextEncoder text-mode tree -> xbert keys under ``prefix``bert."""
    p = f"{prefix}bert."
    e = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{p}embeddings.{name}.weight"] = _f32(e[name]["embedding"])
    ln(e["LayerNorm"], f"{p}embeddings.LayerNorm", out)
    max_pos = np.asarray(e["position_embeddings"]["embedding"]).shape[0]
    out[f"{p}embeddings.position_ids"] = np.arange(max_pos,
                                                   dtype=np.int64)[None, :]
    i = 0
    while f"layer_{i}" in params:
        lp, q = params[f"layer_{i}"], f"{p}encoder.layer.{i}"
        lin(lp["query"], f"{q}.attention.self.query", out)
        lin(lp["key"], f"{q}.attention.self.key", out)
        lin(lp["value"], f"{q}.attention.self.value", out)
        lin(lp["attention_output"], f"{q}.attention.output.dense", out)
        ln(lp["attention_LayerNorm"], f"{q}.attention.output.LayerNorm", out)
        lin(lp["intermediate"], f"{q}.intermediate.dense", out)
        lin(lp["output"], f"{q}.output.dense", out)
        ln(lp["output_LayerNorm"], f"{q}.output.LayerNorm", out)
        i += 1


def convert_lang(params, prefix: str, out: dict):
    convert_text_encoder(params["text_encoder"], f"{prefix}text_encoder.",
                         out)
    lin(params["proj"], f"{prefix}proj", out)
    if "lang_cls" in params:
        lin(params["lang_cls"], f"{prefix}lang_cls.0", out)


def convert_match(params, prefix: str, out: dict):
    if "Dense_3" in params or "Dense_6" in params:
        raise NotImplementedError(
            "use_lang_emb / use_reg_head trees are not ported yet; see "
            "ROADMAP.md queue A item 9a (options of slice 1)")
    for i, idx in enumerate((0, 3, 6)):
        lin(params[f"Dense_{i}"], f"{prefix}match.{idx}", out)
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
        convert_match(params["match"], "match.", sd)
    if "constrast" in params:  # the reference's spelling
        convert_contrast(params["constrast"], "constrast.", sd)
    for head in ("caption", "mlm"):
        if head in params:
            convert_caption(params[head], f"{head}.model.", sd)
    if "answer" in params:
        convert_answer(params["answer"], "answer.", sd)
    return to_tensors(sd)
