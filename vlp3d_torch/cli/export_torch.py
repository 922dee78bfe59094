"""Export the port's snapshot as a reference PyTorch state dict.

The port's counterpart of ``vlp3d/cli/export_torch.py``, the inverse of
:mod:`vlp3d_torch.cli.import_torch`: hand the weights back to the
reference stack (its evaluation harnesses, visualizers, further
finetuning).

    python -m vlp3d_torch.cli.export_torch --model_dir ckpt/ --out model.pth
    # then, on the reference side:
    #   model.load_state_dict(torch.load("model.pth"), strict=False)

The snapshot's names are already the reference's. What the export adds
is what ``export_jointnet_state_dict`` (``vlp3d/models/torch_export.py``)
writes beyond them: the decoders' dead early-guide entries (zero
``src_attn`` linears, identity ``sublayer.1`` norms) and, where the
reference declares one PReLU slope (the vote-weight predictor, the
lang-emb branch), the mean of the port's per-channel slopes (their
value, where they are all equal). The
reference also serializes weights the port does not carry (the BERT
layers from fusion_layer on, its MaskedLM head): ``--base
<original.pth>`` carries those through unchanged from the checkpoint
first imported, and the result loads with strict=True; without it, load
with strict=False.
"""

from __future__ import annotations

import argparse
import re

import torch

from vlp3d_torch.cli.import_torch import read_reference_checkpoint
from vlp3d_torch.train.checkpoint import load_params

# the reference's nn.PReLU() sites, one slope each
# (proposal_module_fcos.py:54, refnet/match_module.py)
SCALAR_PRELU = ("proposal.votes_weight_predictor.2.weight",
                "match.lang_emb_proj.2.weight",
                "match.lang_emb_proj.5.weight")


def reference_state_dict(sd: dict) -> dict:
    """The port's state dict -> the reference model's layout."""
    out = dict(sd)
    for key in SCALAR_PRELU:
        if key in out:
            w = out[key]
            out[key] = w[:1].clone() if bool((w == w[0]).all()) \
                else w.mean().reshape(1)
    layer = re.compile(r"^((?:caption|mlm)\.model\.decoder\.layers\.\d+)"
                       r"\.self_attn\.linears\.0\.weight$")
    for key in sd:
        m = layer.match(key)
        if not m:
            continue
        q, d_model = m.group(1), sd[key].shape[0]
        for j in range(4):
            out[f"{q}.src_attn.linears.{j}.weight"] = torch.zeros(
                d_model, d_model)
            out[f"{q}.src_attn.linears.{j}.bias"] = torch.zeros(d_model)
        out[f"{q}.sublayer.1.norm.a_2"] = torch.ones(d_model)
        out[f"{q}.sublayer.1.norm.b_2"] = torch.zeros(d_model)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True,
                   help="snapshot directory (save_params root)")
    p.add_argument("--name", default="model",
                   help="snapshot name inside --model_dir")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--base", default=None,
                   help="reference .pth to merge: keys the export does not "
                        "produce (the BERT tail etc.) carry through "
                        "unchanged, so the result loads with strict=True")
    p.add_argument("--dp_prefix", action="store_true",
                   help="prepend 'module.' to every key (the layout "
                        "nn.DataParallel checkpoints carry)")
    args = p.parse_args(argv)

    out = reference_state_dict(load_params(args.model_dir, args.name))
    n_exported = len(out)
    carried = 0
    if args.base:
        for k, v in read_reference_checkpoint(args.base).items():
            if k not in out:
                out[k] = v
                carried += 1
    if args.dp_prefix:
        out = {"module." + k: v for k, v in out.items()}
    torch.save(out, args.out)
    extra = f" + {carried} carried from --base" if args.base else ""
    print(f"export_torch: {n_exported} exported keys{extra} -> {args.out}"
          + ("" if args.base else " (load with strict=False)"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
