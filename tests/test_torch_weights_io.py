"""Weights in and out of the port against the JAX package, on the CPU.

* ``import_torch`` on a reference ``.pth`` written by JAX's
  ``export_jointnet_state_dict`` gives JAX's ``import_jointnet_state_dict``
  followed by ``convert.jax_to_torch_state_dict``, key by key and bit for
  bit: as a ``.pth``, inside a checkpoint.tar and with nn.DataParallel's
  ``module.`` prefix; a reference checkpoint's BERT tail and MLM head are
  dropped.
* ``export_torch`` then ``import_torch`` gives back the snapshot
  (``export_torch`` against JAX's CLI: ``test_torch_export_torch.py``).

The HF BERT loader and the safetensors reader are in
``test_torch_hf_bert.py``.
"""

import jax
import numpy as np
import pytest
import shutil
import torch

from test_torch_flags import (
    JaxJointNet,
    _train_batch,
    jax_tiny_config,
    seeded,
)
from vlp3d.models.torch_export import export_jointnet_state_dict
from vlp3d.models.torch_import import import_jointnet_state_dict
from vlp3d_torch.cli import export_torch, import_torch
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import tiny_config
from vlp3d_torch.train.checkpoint import load_params, save_params

FUSION = 2  # tiny_config's BERT text-mode depth
FLAGS = {
    "heads": dict(use_con=True, no_caption=False),
    "options": dict(use_con=True, no_caption=False, use_mlm=True,
                    use_answer=True, use_vote_weight=True, use_kl_loss=True,
                    use_lang_emb=True, use_reg_head=True),
    # the --synthetic --smoke CLIs' model
    "default": dict(use_con=False, no_caption=False),
}
SEEDS = {"heads": 5, "options": 8, "default": 7}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test writes snapshots of ~130-450 MB (BERT's 30522-word
    embedding); remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def jax_params(flags, seed):
    """Seeded JAX JointNet (params, batch_stats) in the shapes of its
    init, with no init compile."""
    jmod = JaxJointNet(jax_tiny_config(**flags))
    b0 = _train_batch(tiny_config(**flags))
    shapes = jax.eval_shape(lambda b: jmod.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "aug": jax.random.key(2)}, b, train=True), b0)
    return seeded(shapes, seed)


@pytest.fixture(scope="module")
def weights():
    """name -> (params, stats, the reference dict, JAX's import of it
    through convert), each built once."""
    cache = {}

    def get(name):
        if name not in cache:
            params, stats = jax_params(FLAGS[name], SEEDS[name])
            sd = reference_dict(params, stats)
            jp, js = import_jointnet_state_dict(sd, fusion_layer=FUSION)
            cache[name] = (params, stats, sd, jax_to_torch_state_dict(
                jax.device_get(jp), jax.device_get(js)))
        return cache[name]

    return get


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def reference_dict(params, stats):
    """JAX's reference-layout export, plus what a reference checkpoint
    carries that neither package reads: the BERT layers from fusion_layer
    on and the BertForMaskedLM head."""
    sd = _tensors(export_jointnet_state_dict(params, stats))
    layer0 = "lang.text_encoder.bert.encoder.layer.0."
    for k in [k for k in sd if k.startswith(layer0)]:
        for i in (FUSION, FUSION + 1):
            sd[k.replace(".layer.0.", f".layer.{i}.")] = sd[k].clone()
    sd["lang.text_encoder.cls.predictions.bias"] = torch.zeros(30522)
    sd["lang.text_encoder.cls.predictions.transform.dense.weight"] = (
        torch.ones(768, 768))
    return sd


def assert_equal_dicts(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("flags,flavour", [
    ("heads", "pth"), ("heads", "tar"), ("heads", "module"),
    ("options", "pth")])
def test_import_torch_is_jax_import_through_convert(tmp_path, flags,
                                                    flavour, capsys,
                                                    weights):
    _, _, sd, want = weights(flags)

    path = str(tmp_path / "ref.pth")
    if flavour == "tar":
        torch.save({"model_state_dict": sd, "epoch": 3}, path)
    elif flavour == "module":
        torch.save({"module." + k: v for k, v in sd.items()}, path)
    else:
        torch.save(sd, path)
    out = str(tmp_path / "imported")
    assert import_torch.main(["--checkpoint", path, "--out", out,
                              "--fusion_layer", str(FUSION),
                              "--device", "cpu"]) == 0
    got = load_params(out, "model")
    assert_equal_dicts(got, want)
    dropped = len(sd) - len(want)
    assert f"kept {len(want)} keys, dropped {dropped}" in capsys.readouterr(
        ).out
    # the tail, the MLM head and the dead early-guide keys went
    assert not any(".layer.2." in k or ".cls." in k or ".src_attn." in k
                   for k in got)


def test_import_torch_refuses_a_checkpoint_missing_a_key(tmp_path,
                                                         weights):
    sd = dict(weights("heads")[2])
    del sd["relation.features_concat.1.running_var"]
    path = str(tmp_path / "ref.pth")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="running_var"):
        import_torch.main(["--checkpoint", path, "--out", str(tmp_path / "o"),
                           "--fusion_layer", str(FUSION), "--device", "cpu"])


def test_export_then_import_is_the_identity(tmp_path, weights):
    """Per-channel slopes are collapsed to their mean where the reference
    has one slope (as JAX's export does); on equal slopes the round trip
    gives back the snapshot bit for bit."""
    params, stats, _, _ = weights("options")
    sd = jax_to_torch_state_dict(params, stats)
    for key in export_torch.SCALAR_PRELU:
        sd[key] = torch.full_like(sd[key], float(sd[key][3]))
    save_params(str(tmp_path / "run"), "model", sd)
    ref = str(tmp_path / "ref.pth")
    export_torch.main(["--model_dir", str(tmp_path / "run"), "--out", ref])
    assert torch.load(ref)["match.lang_emb_proj.2.weight"].shape == (1,)
    import_torch.main(["--checkpoint", ref, "--out", str(tmp_path / "back"),
                       "--fusion_layer", str(FUSION), "--device", "cpu"])
    assert_equal_dicts(load_params(str(tmp_path / "back"), "model"), sd)
