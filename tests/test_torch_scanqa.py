"""The standalone ScanQA pipeline (MCAN) of vlp3d_torch against the JAX
package, on the CPU, at the tiny configuration (4 scenes of 256 points,
16 proposals, 30-token GloVe questions of ragged length, 37 answers).
Weights: a seeded fill of the flax model's shapes (``jax.eval_shape`` of
its init, no init compile) with small vote offsets, carried over by
``scanqa_to_torch_state_dict`` and loaded with ``strict=True``. Stated
tolerances:

  * the evaluation forward: answer_scores, cluster_ref, lang_scores and
    the boxes within 1e-4; the sampled indices and objectness masks
    equal;
  * ``compute_vqa_loss`` on seeded outputs, both answer branches (soft
    scores and one index), with a question whose best IoU is 0 for every
    proposal (the argmax then picks proposal 0): each term within 1e-6
    relative, the gradient of the total with respect to each output
    within 1e-6 of its largest entry;
  * one train step (dropout off on both sides, the port following JAX's
    side of 0 at every ReLU input, which must lie within 1e-3 of 0 where
    they differ): loss and every scalar metric atol 1e-4 / rtol 1e-4;
    each gradient's median error within 1e-4 and every entry within 5e-3
    of the tensor's largest entry (tests/test_torch_train.py); BatchNorm
    statistics after it atol 1e-5 / rtol 1e-4;
  * the trainer's optimizer (Adam with coupled L2 after clip_grad_value
    1.0, one group, MultiStepLR by epoch) over 3 updates of seeded
    gradients against the JAX trainer's optax chain: atol 1e-6, with a
    milestone crossed;
  * ``python -m vlp3d_torch.cli.train_scanqa --synthetic --smoke --device
    cpu`` in process: exit, ``log.jsonl``'s train records with the JAX
    trainer's metric keys and its val records and ``best.json`` with its
    keys, every number finite, the snapshots written.
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
from vlp3d.losses.vqa import compute_vqa_loss as jax_vqa_loss
from vlp3d.models.scanqa import ScanQA as JaxScanQA
from vlp3d_torch.cli import train_scanqa
from vlp3d_torch.convert import scanqa_to_torch_state_dict
from vlp3d_torch.data.synthetic import tiny_config
from vlp3d_torch.losses.vqa import compute_vqa_loss
from vlp3d_torch.models.scanqa import ScanQA

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

BATCH, POINTS, T, NUM_ANSWERS = 4, 256, 30, 37


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=17):
    """make_batch plus the squeezed one-question fields of the ScanQA
    loader: GloVe-like features of ragged length (1 and T included), the
    reference labels of the question's object, soft answer scores."""
    b = jax_make_batch(jax_tiny_config(), batch_size=BATCH, num_points=POINTS,
                       seed=seed)
    rng = np.random.default_rng(seed + 1)
    b["lang_feat"] = rng.normal(size=(BATCH, T, 300)).astype(np.float32)
    b["lang_len"] = np.array([1, T, 7, 12], np.int32)
    for src, dst in train_scanqa.RENAMES.items():
        if src in b:
            b[dst] = b[src][:, 0]
    cats = (rng.random((BATCH, NUM_ANSWERS)) < 0.1).astype(np.float32)
    cats[:, 0] += cats.sum(-1) == 0
    b["answer_cats"] = cats
    b["answer_cat_scores"] = (cats * rng.choice([0.3, 0.6, 0.9, 1.0], size=(
        BATCH, NUM_ANSWERS))).astype(np.float32)
    b["answer_cat"] = np.argmax(cats, -1).astype(np.int32)
    return b


def _mean_size():
    return jax_tiny_config().dataset.mean_size_arr()


@pytest.fixture(scope="module")
def jax_side():
    mp = no_dropout()
    try:
        model = JaxScanQA(jax_tiny_config(), num_answers=NUM_ANSWERS)
        batch = _batch()
        shapes = jax.eval_shape(lambda b: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
            train=True), batch)
        params, stats = seeded_variables(shapes)
        for leaf in params["voting_net"]["Dense_2"].values():
            leaf *= 0.05  # votes near their seeds: every loss live
        mean = jnp.asarray(_mean_size())
        result = jax_step(model, lambda o, b: jax_vqa_loss(o, b, mean),
                          params, stats, batch)
    finally:
        mp.undo()
    return dict(params=params, stats=stats, batch=batch, result=result,
                kinks=kink_names(scanqa_to_torch_state_dict, params, stats,
                                 result[3]))


def _port(jax_side):
    model = ScanQA(tiny_config(), NUM_ANSWERS, device="cpu")
    model.load_state_dict(scanqa_to_torch_state_dict(jax_side["params"],
                                                     jax_side["stats"]),
                          strict=True)
    return model


def test_eval_forward_matches_jax(jax_side):
    want = jax_side["result"][4]
    got = _port(jax_side)(to_torch_batch(jax_side["batch"]))
    for k in ("sa1_inds", "aggregated_vote_inds", "objectness_masks"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("answer_scores", "cluster_ref", "lang_scores", "pred_size",
              "center", "size_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_train_step_matches_jax(jax_side):
    jmetrics, jgrads, jstats, _, _ = jax_side["result"]
    model = _port(jax_side)
    drop_out(model)
    batch = to_torch_batch(jax_side["batch"])
    mean = torch.as_tensor(_mean_size())
    metrics = {}

    def run():
        out = model(batch, train=True)
        loss, m = compute_vqa_loss(out, batch, mean)
        loss.backward()
        metrics.update(m)

    flips = follow_kinks(model, jax_side["kinks"], run)
    assert_flips_near_zero(flips)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].detach().numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("answer_loss", "vote_loss", "ref_loss", "lang_loss",
              "center_loss"):
        assert float(metrics[k].detach()) > 0, k
    held = assert_grads_match(model, scanqa_to_torch_state_dict(
        jgrads, jax_side["stats"]), "scanqa")
    assert len(held) >= 0.9 * len(list(model.parameters())), held
    assert_stats_match(model, scanqa_to_torch_state_dict(jax_side["params"],
                                                         jstats))


def _loss_inputs(seed):
    """Seeded ScanQA outputs (16 proposals) and the squeezed batch; the
    last question's object lies far from every proposal (every IoU 0)."""
    rng = np.random.default_rng(seed)
    b = _batch(seed)
    b["ref_center_label"] = b["ref_center_label"].copy()
    b["ref_center_label"][-1] = 100.0
    k, s, ns = 16, 64, 18

    def f(*shape, scale=1.0, lo=None):
        if lo is not None:
            return rng.uniform(lo, scale, shape).astype(np.float32)
        return (scale * rng.normal(size=shape)).astype(np.float32)

    out = {
        "seed_xyz": f(BATCH, s, 3, lo=0.0, scale=6.0),
        "seed_inds": rng.integers(0, POINTS, (BATCH, s)).astype(np.int32),
        "aggregated_vote_xyz": f(BATCH, k, 3, lo=0.0, scale=6.0),
        "objectness_scores": f(BATCH, k, 2),
        "heading_scores": f(BATCH, k, 1),
        "heading_residuals_normalized": f(BATCH, k, 1),
        "size_scores": f(BATCH, k, ns),
        "size_residuals_normalized": f(BATCH, k, ns, 3, scale=0.3),
        "sem_cls_scores": f(BATCH, k, 18),
        "pred_size": f(BATCH, k, 3, lo=0.3, scale=1.5),
        "cluster_ref": f(BATCH, k),
        "lang_scores": f(BATCH, 18),
        "answer_scores": f(BATCH, NUM_ANSWERS),
    }
    out["vote_xyz"] = out["seed_xyz"] + f(BATCH, s, 3, scale=0.3)
    out["center"] = out["aggregated_vote_xyz"] + f(BATCH, k, 3, scale=0.2)
    out["pred_center"] = out["center"]
    return out, b


@pytest.mark.parametrize("soft", [True, False], ids=["bce", "ce"])
def test_vqa_loss_matches_jax(soft):
    outputs, batch = _loss_inputs(5)
    if not soft:
        del batch["answer_cat_scores"]
    floats = [k for k, v in outputs.items() if v.dtype == np.float32]
    mean = _mean_size()

    def jloss(fl):
        loss, m = jax_vqa_loss({**outputs, **fl}, batch, jnp.asarray(mean))
        return loss, m

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(outputs[k]) for k in floats})
    tout = to_torch_batch(outputs)
    for k in floats:
        tout[k].requires_grad_(True)
    loss, m = compute_vqa_loss(tout, to_torch_batch(batch),
                               torch.as_tensor(mean))
    loss.backward()
    labels = np.asarray(jm["cluster_labels"])
    assert labels[-1, 0] == 1 and labels[-1].sum() == 1  # every IoU 0
    assert np.array_equal(m["cluster_labels"].numpy(), labels)
    for k, want in jm.items():
        if np.ndim(want) == 0:
            np.testing.assert_allclose(float(m[k]), float(want), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    for k in floats:
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        grad = tout[k].grad  # None where no term reads the output
        got = np.zeros_like(want) if grad is None else grad.numpy()
        assert np.abs(got - want).max() <= 1e-6 * scale, k


def test_optimizer_matches_the_trainers_optax_chain():
    """3 updates of seeded gradients (about a third above the clip at 1)
    with steps_per_epoch 1 and a milestone at epoch 1: the second update
    runs at lr x 0.2."""
    model = ScanQA(tiny_config(), NUM_ANSWERS, device="cpu")
    args = train_scanqa.build_parser().parse_args(
        ["--lr", "2e-3", "--wd", "0.1", "--lr_decay_step", "1", "5"])
    opt = train_scanqa.vqa_optimizer(model, args, 1)
    assert [len(g["params"]) for g in opt.param_groups] == [
        len(list(model.parameters()))]
    milestones, rate = (1, 5), args.lr_decay_rate

    def lr(step):  # the JAX trainer's _lr
        e = step // 1
        k = sum((e >= m).astype(jnp.int32) for m in milestones)
        return args.lr * (rate ** k)

    tx = optax.chain(optax.clip(1.0), optax.add_decayed_weights(args.wd),
                     optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                     optax.scale_by_learning_rate(lr))
    three_updates(model, opt, tx)


def test_train_scanqa_cli_smoke(tmp_path, jax_side):
    random.seed(0)
    best = train_scanqa.main(["--synthetic", "--smoke", "--device", "cpu",
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
    for r in val:
        assert set(r) == {"phase", "epoch", "answer_acc_1", "answer_acc_10"}
    assert all(np.isfinite(v) for r in records for v in r.values()
               if isinstance(v, float))
    with open(os.path.join(run, "best.json")) as f:
        assert json.load(f) == best
    assert set(best) == {"epoch", "answer_acc_1", "answer_acc_10"}
    assert 0.0 <= best["answer_acc_1"] <= best["answer_acc_10"] <= 1.0
    for name in ("model.pth", "model_last.pth"):
        assert os.path.exists(os.path.join(run, name))
