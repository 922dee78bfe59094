"""The port's HF BERT loader and safetensors reader against the JAX
package and the ``safetensors`` package, on the CPU.

* The safetensors reader gives what the ``safetensors`` package gives
  for a seeded file of every dtype it reads, and raises, naming the
  tensor, on a truncated file, an unknown dtype and overlapping offsets.
* The HF BERT loader's encoder output on the stand-in checkpoint is
  within 1e-5 of JAX's ``load_hf_bert_params`` path (bare and ``bert.``
  names, ``pytorch_model.bin`` and ``model.safetensors``), and the keys
  it leaves are JAX's (ROADMAP C25: past ``fusion_layer`` they differ).
"""

import os

import jax
import numpy as np
import pytest
import torch

from vlp3d.cli.validate import _bert_config_from_state_dict
from vlp3d.models.bert import BertTextEncoder as JaxBertTextEncoder
from vlp3d.models.bert import load_hf_bert_params
from vlp3d_torch.data.safetensors_file import DTYPES, read_safetensors
from vlp3d_torch.data.standins import write_bert_assets
from vlp3d_torch.models.bert import (
    BertConfig,
    BertTextEncoder,
    bert_config_from_state_dict,
    load_hf_bert,
    read_hf_state_dict,
)

BERT_TOL = 1e-5


def seeded_tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, dtype in DTYPES.items():
        if dtype.is_floating_point:
            t = torch.randn(3, 5, generator=g).to(dtype) * 7
        elif dtype == torch.bool:
            t = torch.randint(0, 2, (4, 2), generator=g).bool()
        else:
            info = torch.iinfo(dtype)
            t = torch.randint(max(info.min, -(2 ** 31)),
                              min(info.max, 2 ** 31 - 1), (6,), generator=g,
                              dtype=torch.int64).to(dtype)
        out[f"t_{name.lower()}"] = t
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 3)
    return out


def test_safetensors_reader_is_the_package_s(tmp_path):
    from safetensors.torch import load_file, save_file

    path = str(tmp_path / "all.safetensors")
    save_file(seeded_tensors(), path, metadata={"format": "pt"})
    want, got = load_file(path), read_safetensors(path)
    assert list(got) == list(want) or set(got) == set(want)
    assert set(got) == set(want) and len(got) == len(DTYPES) + 2
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


def _raw(path):
    with open(path, "rb") as f:
        return f.read()


def test_safetensors_reader_refuses_broken_files(tmp_path):
    import json
    import struct

    from safetensors.torch import save_file

    path = str(tmp_path / "t.safetensors")
    save_file({"a": torch.ones(4), "b": torch.arange(8.0)}, path)
    raw = _raw(path)
    cut = str(tmp_path / "cut.safetensors")
    with open(cut, "wb") as f:
        f.write(raw[:-4])
    with pytest.raises(ValueError, match="truncated"):
        read_safetensors(cut)
    with open(cut, "wb") as f:
        f.write(raw[:6])
    with pytest.raises(ValueError, match="no header length"):
        read_safetensors(cut)

    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])

    def rewrite(h):
        text = json.dumps(h).encode()
        with open(cut, "wb") as f:
            f.write(struct.pack("<Q", len(text)) + text + raw[8 + n:])

    rewrite(dict(header, a=dict(header["a"], dtype="C64")))
    with pytest.raises(ValueError, match="'a' has dtype 'C64'"):
        read_safetensors(cut)
    first = min(header["a"]["data_offsets"][0], header["b"]["data_offsets"][0])
    late = "a" if header["a"]["data_offsets"][0] > first else "b"
    moved = dict(header[late])
    size = moved["data_offsets"][1] - moved["data_offsets"][0]
    moved["data_offsets"] = [first + 4, first + 4 + size]
    rewrite(dict(header, **{late: moved}))
    with pytest.raises(ValueError, match="overlaps"):
        read_safetensors(cut)


# ------------------------------------------------------------- HF BERT


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    write_bert_assets(str(d))
    return d


def jax_encoder_output(sd, ids, mask):
    """JAX's validate path: the config from the checkpoint, init,
    load_hf_bert_params, the deterministic forward."""
    cfg = _bert_config_from_state_dict(sd)
    enc = JaxBertTextEncoder(cfg)
    variables = enc.init(jax.random.key(0), ids, mask)
    params = load_hf_bert_params({"text_encoder": variables["params"]},
                                 sd)["text_encoder"]
    return cfg, np.asarray(enc.apply({"params": params}, ids, mask,
                                     deterministic=True))


@pytest.mark.parametrize("layout", ["bare", "bert_prefix", "safetensors"])
def test_hf_bert_loader_matches_jax(bert_dir, tmp_path, layout):
    sd = read_hf_state_dict(str(bert_dir))
    d = str(bert_dir)
    if layout == "bert_prefix":
        sd = {"bert." + k if not k.startswith("pooler") else k: v
              for k, v in sd.items()}
    elif layout == "safetensors":
        from safetensors.torch import save_file

        d = str(tmp_path / "st")
        os.makedirs(d)
        save_file({k: v.contiguous() for k, v in sd.items()},
                  os.path.join(d, "model.safetensors"))
        sd = read_hf_state_dict(d)  # the safetensors file, no package
    np_sd = {k: v.numpy() for k, v in sd.items()}
    ids = np.zeros((2, 12), np.int32)
    ids[0, :6] = [2, 5, 7, 9, 13, 3]
    ids[1, :9] = [2, 28, 24, 6, 15, 25, 6, 17, 3]
    mask = (ids != 0).astype(np.int32)
    jcfg, want = jax_encoder_output(np_sd, ids, mask)
    cfg = bert_config_from_state_dict(sd)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "intermediate_size",
                  "max_position_embeddings", "fusion_layer"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    enc = BertTextEncoder(cfg, device="cpu").eval()
    unused = load_hf_bert(enc, sd)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long(),
                  torch.from_numpy(mask).long()).numpy()
    assert np.abs(got - want).max() <= BERT_TOL
    consumed = ("embeddings.", "encoder.layer.", "bert.embeddings.",
                "bert.encoder.layer.")
    assert unused == [k for k in sd if not k.startswith(consumed)]
    assert sorted(unused) == ["pooler.dense.bias", "pooler.dense.weight"]


def test_hf_bert_loader_lists_layers_past_fusion_c25(bert_dir):
    """ROADMAP C25: JAX's check counts every ``encoder.layer.*`` key as
    consumed; the port returns the ones its text encoder did not take, so
    the layers from fusion_layer on are listed."""
    sd = read_hf_state_dict(str(bert_dir))
    cfg = bert_config_from_state_dict(sd)
    enc = BertTextEncoder(BertConfig(**{
        **{f: getattr(cfg, f) for f in ("vocab_size", "hidden_size",
                                        "num_hidden_layers",
                                        "num_attention_heads",
                                        "intermediate_size",
                                        "max_position_embeddings")},
        "fusion_layer": 1}), device="cpu")
    unused = load_hf_bert(enc, sd)
    tail = [k for k in sd if k.startswith("encoder.layer.1.")]
    assert tail and sorted(unused) == sorted(tail + ["pooler.dense.weight",
                                                     "pooler.dense.bias"])
    # a shape that disagrees is refused, naming the tensor
    bad = dict(sd)
    bad["embeddings.LayerNorm.weight"] = torch.ones(3)
    with pytest.raises(ValueError, match="embeddings.LayerNorm.weight"):
        load_hf_bert(enc, bad)
