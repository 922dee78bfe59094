"""CapNet (the 3DJCG captioning pipeline) of vlp3d_torch against the JAX
package, on the CPU, at the tiny configuration with the trainer's flags
(``no_caption``, ``no_reference``, ``use_con=False``, ``use_mlm=False``),
4 scenes of 256 points x 4 captions of 12 sos/eos-wrapped GloVe tokens,
a 23-word caption vocabulary, 16 proposals. Weights: a seeded fill of the
flax model's shapes with small vote offsets and ~0.7 m boxes, carried
over by ``capnet_to_torch_state_dict`` and loaded with ``strict=True``.
Stated tolerances:

  * ``query_local_masks`` on a tie-heavy case (most proposals non-objects
    at 1e30, duplicated boxes at equal distances, k from 1 to 15, the
    captioner's corner query, two seeds): equal to JAX's (``lax.top_k``
    takes the lowest index of a tie);
  * the evaluation forward with ``num_locals`` -1 and 3: lang_cap within
    1e-4, the sampled indices equal;
  * one train step of the joint detection loss + the caption CE with
    ``num_locals`` -1 and 3 (dropout off on both sides, the port following JAX's
    side of 0 at every ReLU input, the captioner's per word): loss and
    every scalar metric atol 1e-4 / rtol 1e-4; each gradient's median
    error within 1e-4 and every entry within 5e-3 of the tensor's
    largest entry (tests/test_torch_train.py); BatchNorm statistics atol
    1e-5 / rtol 1e-4;
  * the trainer's optimizer (``optax.adamw(lr, wd)``, one group) over 3
    updates against optax: atol 1e-6;
  * ``python -m vlp3d_torch.cli.train_3djcg_c --synthetic --smoke
    --device cpu`` (and ``--num_locals 2``) in process: exit,
    ``log.jsonl``'s train records with the JAX trainer's metric keys,
    its val records and ``best.json`` with its keys, every number finite,
    the snapshots written.
"""

import glob
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlp3d.data.synthetic import make_batch as jax_make_batch
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.geometry.boxes import get_3d_box_batch as jax_box_corners
from vlp3d.losses.captioning import compute_cap_loss as jax_cap_loss
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d.models.capnet import CapNet as JaxCapNet
from vlp3d.models.capnet import query_local_masks as jax_local_masks
from vlp3d_torch.cli import train_3djcg_c
from vlp3d_torch.cli.train_3djcg_c import caption_losses
from vlp3d_torch.cli.train_3djcg_g import adamw_one_group
from vlp3d_torch.convert import capnet_to_torch_state_dict
from vlp3d_torch.data.synthetic import tiny_config
from vlp3d_torch.models.capnet import CapNet, query_local_masks

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

FLAGS = dict(no_caption=True, use_con=False, use_mlm=False,
             no_reference=True)
BATCH, POINTS, T, VOCAB = 4, 256, 12, 23


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [3, 8])
def test_query_local_masks_ties_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, k = 6, 16
    size = rng.uniform(0.2, 1.0, (n, k, 3)).astype(np.float32)
    center = rng.uniform(0, 4, (n, k, 3)).astype(np.float32)
    center[:, 8:12] = center[:, 4:8]  # duplicated boxes: equal distances
    size[:, 8:12] = size[:, 4:8]
    center[:, 12] = center[:, 0]  # a box on the target: IoU >= 0.5
    size[:, 12] = size[:, 0]
    corners = np.array(jax_box_corners(size, np.zeros((n, k), np.float32),
                                       center))
    masks = (rng.random((n, k)) < 0.5).astype(np.float32)
    masks[0] = 0.0  # every proposal of row 0 a non-object
    masks[:, 4:12] = 1.0
    target = rng.integers(0, k, n).astype(np.int32)
    target[:2] = 0
    for num in (1, 3, 8, 12, 15):
        want = np.asarray(jax_local_masks(
            jnp.asarray(corners), jnp.asarray(target), jnp.asarray(masks),
            num, query_mode="corner"))
        got = query_local_masks(
            torch.from_numpy(corners), torch.from_numpy(target),
            torch.from_numpy(masks), num).numpy()
        assert np.array_equal(got, want), (seed, num)
        assert (got.sum(1) == num).all()


def _batch(seed=17):
    config = jax_tiny_config(**FLAGS)
    b = jax_make_batch(config, batch_size=BATCH, num_points=POINTS, seed=seed)
    rng = np.random.default_rng(seed + 1)
    l = config.model.lang_num_max
    b["lang_feat"] = rng.normal(size=(BATCH, l, T, 300)).astype(np.float32)
    ids = rng.integers(4, VOCAB, size=(BATCH, l, T))
    lens = rng.integers(3, T + 1, size=(BATCH, l))
    ids[..., 0] = 2  # sos
    for i in range(BATCH):
        for j in range(l):
            ids[i, j, lens[i, j] - 1] = 3  # eos
            ids[i, j, lens[i, j]:] = 0
    b["lang_ids"] = ids.astype(np.int64)
    return b


def _jax_losses(config):
    def loss(out, b):
        det, m = jax_joint_loss(config, out, b, reference=False)
        cap, acc = jax_cap_loss(out["lang_cap"], b["lang_ids"],
                                out["good_bbox_masks"])
        m = {k: v for k, v in m.items() if jnp.ndim(v) == 0}
        m.update(cap_loss=cap, cap_acc=acc, loss=det + cap)
        return det + cap, m
    return loss


@pytest.fixture(scope="module", params=[-1, 3], ids=["all", "locals3"])
def jax_side(request):
    mp = no_dropout()
    try:
        config = jax_tiny_config(**FLAGS)
        model = JaxCapNet(config, vocab_size=VOCAB, num_locals=request.param)
        batch = _batch()
        shapes = jax.eval_shape(lambda b: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
            train=True), batch)
        params, stats = seeded_variables(shapes)
        for leaf in params["vgen"]["Dense_2"].values():
            leaf *= 0.05
        params["proposal"]["roi_heads"]["Dense_3"]["bias"][:] = -1.0
        result = jax_step(model, _jax_losses(config), params, stats, batch)
    finally:
        mp.undo()
    return dict(params=params, stats=stats, batch=batch, result=result,
                num_locals=request.param,
                kinks=kink_names(capnet_to_torch_state_dict, params, stats,
                                 result[3]))


def _port(jax_side):
    model = CapNet(tiny_config(**FLAGS), VOCAB,
                   num_locals=jax_side["num_locals"], device="cpu")
    model.load_state_dict(capnet_to_torch_state_dict(jax_side["params"],
                                                     jax_side["stats"]),
                          strict=True)
    return model


def test_eval_forward_matches_jax(jax_side):
    want = jax_side["result"][4]
    got = _port(jax_side)(to_torch_batch(jax_side["batch"]))
    for k in ("sa1_inds", "aggregated_vote_inds", "objectness_masks"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    np.testing.assert_allclose(got["lang_cap"].numpy(),
                               np.asarray(want["lang_cap"]), rtol=0,
                               atol=1e-4)


def test_train_step_matches_jax(jax_side):
    jmetrics, jgrads, jstats, _, _ = jax_side["result"]
    config = tiny_config(**FLAGS)
    model = _port(jax_side)
    drop_out(model)
    batch = to_torch_batch(jax_side["batch"])
    metrics = {}

    def run():
        loss, m = caption_losses(config, model(batch, train=True), batch)
        loss.backward()
        metrics.update(m)

    flips = follow_kinks(model, jax_side["kinks"], run)
    assert_flips_near_zero(flips)
    assert set(jmetrics) == set(metrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].detach().numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("cap_loss", "vote_loss", "box_loss"):
        assert float(metrics[k].detach()) > 0, k
    held = assert_grads_match(model, capnet_to_torch_state_dict(
        jgrads, jax_side["stats"]), "capnet")
    # every captioner parameter but the attention's key bias, whose
    # gradient softmax makes zero
    assert {n for n in held if n.startswith("caption.")} == {
        n for n, _ in model.named_parameters() if n.startswith("caption.")
    } - {"caption.dec_att2.attention.fc_k.bias"}
    assert len(held) >= 0.9 * len(list(model.parameters())), held
    assert_stats_match(model, capnet_to_torch_state_dict(jax_side["params"],
                                                         jstats))


def test_optimizer_matches_optax_adamw():
    model = CapNet(tiny_config(**FLAGS), VOCAB, device="cpu")
    opt = adamw_one_group(model, 1e-3, 0.2)
    three_updates(model, opt, optax.adamw(1e-3, weight_decay=0.2))


@pytest.fixture(scope="module")
def jax_metric_keys():
    """The JAX trainer's train-step metric keys (traced, not compiled)."""
    config = jax_tiny_config(**FLAGS)
    model = JaxCapNet(config, vocab_size=VOCAB)
    batch = _batch()

    def metrics(b):
        v = model.init({"params": jax.random.key(0)}, b)
        out = model.apply(v, b, train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.key(1)})[0]
        return _jax_losses(config)(out, b)[1]

    return set(jax.eval_shape(metrics, batch))


@pytest.mark.parametrize("num_locals", ["-1", "2"])
def test_train_3djcg_c_cli_smoke(tmp_path, jax_metric_keys, num_locals):
    random.seed(0)
    best = train_3djcg_c.main(["--synthetic", "--smoke", "--device", "cpu",
                               "--output_dir", str(tmp_path),
                               "--num_workers", "1", "--num_locals",
                               num_locals])
    (run,) = glob.glob(str(tmp_path / "*"))
    with open(os.path.join(run, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["phase"] == "train"]
    val = [r for r in records if r["phase"] == "val"]
    assert len(train) == len(val) == 2
    for r in train:
        assert set(r) == {"phase", "epoch"} | jax_metric_keys
    for r in val:
        assert set(r) == {"phase", "epoch", "cap_acc", "cap_loss"}
    assert all(np.isfinite(v) for r in records for v in r.values()
               if isinstance(v, float))
    with open(os.path.join(run, "best.json")) as f:
        assert json.load(f) == best
    assert set(best) == {"epoch", "cap_acc", "cap_loss"}
    for name in ("caption_model.pth", "model_last.pth"):
        assert os.path.exists(os.path.join(run, name))
