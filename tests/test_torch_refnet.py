"""RefNet (the 3DJCG grounding pipeline) of vlp3d_torch against the JAX
package, on the CPU, at the tiny configuration with ``no_caption``,
``use_con=False`` and ``use_mlm=False`` (the trainer's), 4 scenes of 256
points x 4 sentences of 30 GloVe tokens, ragged lengths 1 to 30. Weights:
a seeded fill of the flax model's shapes with small vote offsets and
~0.7 m boxes (tests/test_torch_train_qa.py's nudges), carried over by
``refnet_to_torch_state_dict`` and loaded with ``strict=True``. Stated
tolerances:

  * the evaluation forward: cluster_ref, lang_scores, lang_emb and the
    boxes within 1e-4, the sampled indices and objectness masks equal;
  * one train step of the joint loss (dropout off on both sides, the
    port following JAX's side of 0 at every ReLU input, within 1e-3 of 0
    where they differ): loss and every scalar metric atol 1e-4 / rtol
    1e-4; each gradient's median error within 1e-4 and every entry within
    5e-3 of the tensor's largest entry (tests/test_torch_train.py);
    BatchNorm statistics atol 1e-5 / rtol 1e-4;
  * the trainer's optimizer (``optax.adamw(lr, wd)``: one group, every
    parameter decayed) over 3 updates against optax: atol 1e-6;
  * ``python -m vlp3d_torch.cli.train_3djcg_g --synthetic --smoke
    --device cpu`` in process: exit, ``log.jsonl``'s train records with
    the JAX trainer's metric keys, its val records and ``best.json`` with
    its keys, every number finite, the snapshots written.
"""

import glob
import json
import os
import random

import jax
import numpy as np
import optax
import pytest
import torch

from vlp3d.data.synthetic import make_batch as jax_make_batch
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d.models.refnet import RefNet as JaxRefNet
from vlp3d_torch.cli import train_3djcg_g
from vlp3d_torch.convert import refnet_to_torch_state_dict
from vlp3d_torch.data.synthetic import tiny_config
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.models.refnet import RefNet

from torch_task_steps import (
    assert_flips_near_zero,
    assert_grads_match,
    assert_stats_match,
    drop_out,
    follow_kinks,
    jax_step,
    kink_names,
    no_dropout,
    seeded_variables,
    three_updates,
    to_torch_batch,
)

FLAGS = dict(no_caption=True, use_con=False, use_mlm=False)
BATCH, POINTS, T = 4, 256, 30


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=17):
    config = jax_tiny_config(**FLAGS)
    b = jax_make_batch(config, batch_size=BATCH, num_points=POINTS, seed=seed)
    rng = np.random.default_rng(seed + 1)
    l = config.model.lang_num_max
    b["lang_feat"] = rng.normal(size=(BATCH, l, T, 300)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=(BATCH, l)).astype(np.int32)
    lens[0, :2] = (1, T)
    b["lang_len"] = lens
    return b


@pytest.fixture(scope="module")
def jax_side():
    mp = no_dropout()
    try:
        config = jax_tiny_config(**FLAGS)
        model = JaxRefNet(config)
        batch = _batch()
        shapes = jax.eval_shape(lambda b: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
            train=True), batch)
        params, stats = seeded_variables(shapes)
        for leaf in params["vgen"]["Dense_2"].values():
            leaf *= 0.05
        params["proposal"]["roi_heads"]["Dense_3"]["bias"][:] = -1.0
        result = jax_step(model, lambda o, b: jax_joint_loss(config, o, b),
                          params, stats, batch)
    finally:
        mp.undo()
    return dict(params=params, stats=stats, batch=batch, result=result,
                kinks=kink_names(refnet_to_torch_state_dict, params, stats,
                                 result[3]))


def _port(jax_side):
    model = RefNet(tiny_config(**FLAGS), device="cpu")
    model.load_state_dict(refnet_to_torch_state_dict(jax_side["params"],
                                                     jax_side["stats"]),
                          strict=True)
    return model


def test_eval_forward_matches_jax(jax_side):
    want = jax_side["result"][4]
    got = _port(jax_side)(to_torch_batch(jax_side["batch"]))
    for k in ("sa1_inds", "aggregated_vote_inds", "objectness_masks"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("cluster_ref", "lang_scores", "lang_emb", "pred_center",
              "pred_size"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_train_step_matches_jax(jax_side):
    jmetrics, jgrads, jstats, _, _ = jax_side["result"]
    config = tiny_config(**FLAGS)
    model = _port(jax_side)
    drop_out(model)
    batch = to_torch_batch(jax_side["batch"])
    metrics = {}

    def run():
        loss, m = compute_joint_loss(config, model(batch, train=True), batch)
        loss.backward()
        metrics.update(m)

    flips = follow_kinks(model, jax_side["kinks"], run)
    assert_flips_near_zero(flips)
    assert set(jmetrics) <= set(metrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].detach().numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("ref_loss", "lang_loss", "vote_loss", "box_loss"):
        assert float(metrics[k].detach()) > 0, k
    held = assert_grads_match(model, refnet_to_torch_state_dict(
        jgrads, jax_side["stats"]), "refnet")
    assert any(n.startswith("lang.lstm.") for n in held)
    assert len(held) >= 0.9 * len(list(model.parameters())), held
    assert_stats_match(model, refnet_to_torch_state_dict(jax_side["params"],
                                                         jstats))


def test_optimizer_matches_optax_adamw():
    model = RefNet(tiny_config(**FLAGS), device="cpu")
    opt = train_3djcg_g.adamw_one_group(model, 2e-3, 0.1)
    assert len(opt.param_groups) == 1
    three_updates(model, opt, optax.adamw(2e-3, weight_decay=0.1))


def test_train_3djcg_g_cli_smoke(tmp_path, jax_side):
    random.seed(0)
    best = train_3djcg_g.main(["--synthetic", "--smoke", "--device", "cpu",
                               "--output_dir", str(tmp_path),
                               "--num_workers", "1"])
    (run,) = glob.glob(str(tmp_path / "*"))
    with open(os.path.join(run, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["phase"] == "train"]
    val = [r for r in records if r["phase"] == "val"]
    assert len(train) == len(val) == 2
    for r in train:
        assert set(r) == {"phase", "epoch"} | set(jax_side["result"][0])
        assert "ref_loss" in r
    for r in val:
        assert set(r) == {"phase", "epoch", "iou_rate_0.25", "iou_rate_0.5"}
    assert all(np.isfinite(v) for r in records for v in r.values()
               if isinstance(v, float))
    with open(os.path.join(run, "best.json")) as f:
        assert json.load(f) == best
    assert set(best) == {"epoch", "iou_rate_0.25", "iou_rate_0.5"}
    for name in ("ground_model.pth", "model_last.pth"):
        assert os.path.exists(os.path.join(run, name))
