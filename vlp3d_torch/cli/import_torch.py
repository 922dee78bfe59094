"""Import a reference PyTorch checkpoint as the port's snapshot.

The port's counterpart of ``vlp3d/cli/import_torch.py``: it takes any of
the reference's snapshot flavours (model.pth / model_last.pth /
ground_model*.pth / caption_model.pth, saved by
lib/joint/solver_3dvlp.py, or checkpoint.tar, whose "model_state_dict"
it takes; train_3dvlp.py:160-171), strips nn.DataParallel's ``module.``
prefix, and writes a :func:`~vlp3d_torch.train.checkpoint.save_params`
snapshot that ``--model_dir`` and ``--pretrain`` read:

    python -m vlp3d_torch.cli.import_torch \\
        --checkpoint runs/XYZ/model_last.pth --out ckpt/
    python -m vlp3d_torch.cli.predict --model_dir ckpt/ ...

The port's names are the reference's, so there is no mapping: the
JointNet the checkpoint describes (:func:`config_from_state_dict`, its
heads and options read from which keys it holds, its BERT text mode
``--fusion_layer`` layers deep) takes exactly the keys it carries, with
``load_state_dict(strict=True)``. The rest are dropped: the BERT layers
from ``--fusion_layer`` on, the BERT MLM head, the decoders' dead
early-guide entries. These are the keys ``import_jointnet_state_dict``
(``vlp3d/models/torch_import.py``) leaves unread. A one-slope PReLU of
the reference loads onto every channel.
"""

from __future__ import annotations

import argparse

import torch

from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
from vlp3d_torch.models.jointnet import JointNet
from vlp3d_torch.train.checkpoint import save_params


def read_reference_checkpoint(path: str) -> dict:
    """A reference ``.pth`` state dict, or a checkpoint.tar's
    ``model_state_dict``, with any ``module.`` prefix stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]  # checkpoint.tar flavour
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()
              if k.startswith("module.")}
    return sd


def config_from_state_dict(sd: dict, fusion_layer: int = 6) -> Config:
    """The Config of the JointNet whose weights ``sd`` holds: the input
    width and the relation's multiview width from their first layers'
    shapes, each optional head and option from its keys (the gating of
    ``import_jointnet_state_dict``), the caption vocabulary, the answer
    count and (with the lang-emb branch, whose last layer scores every
    proposal) the proposal count from their output layers."""
    defaults = ModelConfig()

    def has(key):
        return key in sd

    use_answer = has("answer.answer_cls.0.weight")
    caption = ("caption.model.generator.proj.weight"
               if has("caption.model.generator.proj.weight")
               else "mlm.model.generator.proj.weight")
    lang_emb = has("match.lang_emb_proj.0.weight")
    model = ModelConfig(
        num_proposal=(sd["match.lang_emb_proj.6.weight"].shape[0] if lang_emb
                      else defaults.num_proposal),
        input_feature_dim=sd[
            "backbone_net.sa1.mlp_module.layer0.conv.weight"].shape[1] - 3,
        multiview_dim=sd["relation.obj_embedding.0.weight"].shape[1],
        fusion_layer=fusion_layer,
        use_distil=(has("lang.proj.weight") and not has(
            "lang.text_encoder.bert.embeddings.token_type_embeddings.weight")),
        no_reference=not has("match.match.0.weight"),
        use_lang_classifier=has("lang.lang_cls.0.weight"),
        use_con=has("constrast.pc_proj.weight"),
        no_caption=not has("caption.model.generator.proj.weight"),
        use_mlm=has("mlm.model.generator.proj.weight"),
        use_answer=use_answer,
        num_answers=(sd["answer.answer_cls.3.weight"].shape[0] if use_answer
                     else defaults.num_answers),
        vocab_size=sd[caption].shape[0] if has(caption)
        else defaults.vocab_size,
        use_lang_emb=lang_emb,
        use_reg_head=has("match.reg_head.0.weight"),
        use_vote_weight=has("proposal.votes_weight_predictor.0.weight"),
        use_kl_loss=has("proposal.proposal.alpha_predictor.weight"),
        use_mlcv_net=has("vgen.sa1.t.weight"),
    )
    return Config(dataset=DatasetConfig(), model=model)


def import_state_dict(sd: dict, fusion_layer: int = 6, device=None):
    """(the port's state dict of the checkpoint's JointNet, the keys of
    ``sd`` it does not carry). Raises where a key the model needs is
    missing or a shape differs."""
    config = config_from_state_dict(sd, fusion_layer)
    model = JointNet(config, device=device)
    own = model.state_dict()
    kept = {k: v for k, v in sd.items() if k in own}
    model.load_state_dict(kept, strict=True)
    return model.state_dict(), [k for k in sd if k not in own]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help=".pth state dict or checkpoint.tar")
    p.add_argument("--out", required=True, help="output snapshot directory")
    p.add_argument("--name", default="model",
                   help="snapshot name (load_params(out, name))")
    p.add_argument("--fusion_layer", type=int, default=6,
                   help="BERT text-mode depth (config_bert.json's "
                        "fusion_layer; ALBEF default 6)")
    p.add_argument("--device", type=str, default=None,
                   help="device the model is built and loaded on (default: "
                        "the current CUDA device); cpu for the plain ops")
    args = p.parse_args(argv)

    sd = read_reference_checkpoint(args.checkpoint)
    state, dropped = import_state_dict(sd, args.fusion_layer, args.device)
    path = save_params(args.out, args.name, state)
    heads = sorted({k.split(".")[0] for k in state})
    print(f"import_torch: kept {len(sd) - len(dropped)} keys, dropped "
          f"{len(dropped)} ({', '.join(heads)}) -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
