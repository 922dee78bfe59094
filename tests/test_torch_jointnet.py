"""The grounding-inference slice of vlp3d_torch as a whole, on the CPU.

A flax JointNet at ``tiny_config(use_con=False, no_caption=True)`` gets
random BatchNorm statistics; its tree goes through
``jax_to_torch_state_dict`` into the port's JointNet (strict load). The
same seeded scenes then go through both: index outputs are equal, float
outputs agree within atol 1e-4 / rtol 1e-4, and ``pred_ref`` from the
port's GroundingPredictor equals the JAX GroundingPredictor's through
``__call__`` and ``run_padded``. Each model option (``use_distil``,
``use_lang_emb``, ``use_reg_head``, ``use_vote_weight``, ``mask_box``,
``reference_obj_gather``, ``use_kl_loss``, ``use_lang_classifier=False``,
``no_reference``) builds and its evaluation forward matches JAX's, from
seeded weights in the shapes of the flax init (tests/test_torch_flags.py
holds the options in training and at the module level). Also checked:
the port imports no JAX and nothing of vlp3d, a default-device
construction raises without a card, ``use_mlcv_net`` raises, and the
captioning and answer flags build their heads.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vlp3d.data.synthetic import make_batch as jax_make_batch
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.serving import GroundingPredictor as JaxPredictor
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.serving import STREAM_KEYS, GroundingPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
FLAGS = dict(use_con=False, no_caption=True)
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(seed, batch_size=BATCH):
    b = make_batch(tiny_config(**FLAGS), batch_size=batch_size,
                   num_points=256, seed=seed, istrain=0)
    return {k: b[k] for k in STREAM_KEYS}


@pytest.fixture(scope="module")
def pair():
    """(jax config, jax variables, port state dict)."""
    config = jax_tiny_config(**FLAGS)
    model = JaxJointNet(config)
    b0 = jax_make_batch(config, batch_size=BATCH, num_points=256, istrain=0)
    v = jax.device_get(jax.jit(
        lambda b: model.init({"params": jax.random.key(0)}, b, train=False)
    )(b0))
    rng = np.random.default_rng(1)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map_with_path(stat,
                                                         v["batch_stats"])}
    sd = jax_to_torch_state_dict(v["params"], v["batch_stats"])
    return config, v, sd


def test_make_batch_is_the_same_scene():
    want = jax_make_batch(jax_tiny_config(**FLAGS), batch_size=2,
                          num_points=128, seed=3)
    got = make_batch(tiny_config(**FLAGS), batch_size=2, num_points=128,
                     seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_jointnet_forward_matches_jax(pair):
    config, v, sd = pair
    batch = _scenes(5)
    model = JaxJointNet(config)
    want = jax.device_get(jax.jit(
        lambda vv, b: model.apply(vv, b, train=False, is_eval=True)
    )(v, batch))
    port = JointNet(tiny_config(**FLAGS), device="cpu")
    port.load_state_dict(sd, strict=True)
    got = port({k: torch.from_numpy(batch[k]) for k in STREAM_KEYS})
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds",
              "objectness_masks"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("cluster_ref", "objectness_scores", "pred_center", "pred_size",
              "pred_heading", "bbox_feature", "lang_fea", "lang_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_predictor_matches_jax(pair):
    config, v, sd = pair
    jax_pred = JaxPredictor(config, v, batch_size=BATCH)
    port = GroundingPredictor(tiny_config(**FLAGS), sd, batch_size=BATCH,
                              device="cpu")
    batches = [_scenes(6), _scenes(7)]
    got = port(batches)
    assert len(got) == 2
    for g, b in zip(got, batches):
        want = jax_pred([b])[0]
        np.testing.assert_array_equal(g["pred_ref"], np.asarray(
            want["pred_ref"]))
        for k in ("pred_center", "pred_size", "pred_heading"):
            np.testing.assert_allclose(g[k], np.asarray(want[k]), err_msg=k,
                                       **TOL)
    full = batches[0]
    for k_occ in (1, 3):
        part = {k: a[:k_occ] for k, a in full.items()}
        g = port.run_padded(part)
        want = jax_pred.run_padded(part)
        assert g["pred_ref"].shape == (BATCH, tiny_config().model.lang_num_max)
        np.testing.assert_array_equal(g["pred_ref"], np.asarray(
            want["pred_ref"]))
        # padding repeats row 0: padded rows predict what row 0 predicts
        assert (g["pred_ref"][k_occ:] == g["pred_ref"][0]).all()
    with pytest.raises(ValueError, match="occupancy"):
        port.run_padded(_scenes(8, batch_size=BATCH + 1))


def test_port_imports_no_jax_and_no_vlp3d():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vlp3d_torch\n"
        "for m in pkgutil.walk_packages(vlp3d_torch.__path__, "
        "'vlp3d_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vlp3d')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('vlp3d_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every submodule was imported


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JointNet(tiny_config(**FLAGS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GroundingPredictor(tiny_config(**FLAGS))


@pytest.mark.parametrize("flag,value", [("use_mlcv_net", True)])
def test_unported_flags_raise(flag, value):
    overrides = {**FLAGS, flag: value}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        JointNet(tiny_config(**overrides), device="cpu")


def _seeded_variables(model, batch, seed):
    """Seeded numpy weights in the shapes of the flax init (no compile):
    fan-in-scaled kernels, small biases, unit-ish scales, distinct PReLU
    slopes, random BatchNorm statistics."""
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, train=False), batch)
    rng = np.random.default_rng(seed)

    def param(path, a):
        name = path[-1].key
        if name == "alpha":
            return (0.25 + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)
        if name == "bias" or len(a.shape) < 2:
            return rng.normal(0.0, 0.01, a.shape).astype(np.float32)
        if name == "embedding":
            return rng.normal(0.0, 0.02, a.shape).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return rng.normal(0.0, fan_in ** -0.5, a.shape).astype(np.float32)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param,
                                                       shapes["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, shapes["batch_stats"])}


# each raised NotImplementedError (test_unported_flags_raise) until the
# slice that ported the model options
@pytest.mark.parametrize("flag,value", [
    ("use_distil", True), ("use_lang_emb", True), ("use_reg_head", True),
    ("use_vote_weight", True), ("mask_box", True),
    ("reference_obj_gather", True), ("use_kl_loss", True),
    ("use_lang_classifier", False), ("no_reference", True),
])
def test_flag_builds_and_matches_jax(flag, value):
    """The option builds, and the evaluation forward from converted
    weights matches JAX's: indices equal, every float output within
    TOL."""
    overrides = {**FLAGS, flag: value}
    model = JaxJointNet(jax_tiny_config(**overrides))
    batch = _scenes(9, batch_size=2)
    v = _seeded_variables(model, batch, 2)
    want = jax.device_get(jax.jit(
        lambda vv, b: model.apply(vv, b, train=False, is_eval=True))(v, batch))
    port = JointNet(tiny_config(**overrides), device="cpu")
    port.load_state_dict(jax_to_torch_state_dict(v["params"],
                                                 v["batch_stats"]),
                         strict=True)
    got = port({k: torch.from_numpy(a) for k, a in batch.items()},
               is_eval=True)
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **TOL)
    assert ("cluster_ref" in got) == (flag != "no_reference")


@pytest.mark.parametrize("no_caption", [True, False])
def test_answer_flag_builds_its_head(no_caption):
    """use_answer, which raised until the question-answering slice, builds
    the answer head (the reference's ``answer.*`` keys) beside whatever
    else the flags ask for, and the forward gives ``answer_scores`` of
    each question slot."""
    config = tiny_config(**{**FLAGS, "use_answer": True,
                            "no_caption": no_caption})
    model = JointNet(config, device="cpu")
    keys = [k for k in model.state_dict() if k.startswith("answer.")]
    assert len(keys) == 10
    assert any(k.startswith("caption.") for k in model.state_dict()) == (
        not no_caption)
    b = _scenes(3, batch_size=2)
    out = model({k: torch.from_numpy(v) for k, v in b.items()},
                is_eval=True)
    assert out["answer_scores"].shape == (2 * config.model.lang_num_max,
                                          config.model.num_answers)


@pytest.mark.parametrize("flag,value,head", [("use_mlm", True, "mlm"),
                                             ("no_caption", False, "caption")])
def test_caption_flags_build_their_heads(flag, value, head):
    """The captioning flags, which raised until the captioning slice,
    build their decoders."""
    model = JointNet(tiny_config(**{**FLAGS, flag: value}), device="cpu")
    assert any(k.startswith(f"{head}.model.") for k in model.state_dict())
