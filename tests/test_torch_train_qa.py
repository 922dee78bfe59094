"""The ScanQA training path of vlp3d_torch against the JAX package, on the
CPU: the VQA optimizer recipe, a whole VQA-recipe train step, the
Solver's answer EM and the ``train_qa`` CLI.

  * ``make_optimizer(optim_name="adam", single_group=True,
    clip_grad_value=...)`` over 3 updates of seeded gradients against
    ``vlp3d.train.optimizer.make_optimizer``'s optax chain (clip, coupled
    L2, Adam, one group; atol 1e-6), with a parameter that gets no
    gradient, with AMSGrad, and under ``grad_accum=2`` (the clip acts on
    the accumulated mean gradient);
  * one train step of ``JointNet(use_answer=True)`` under that recipe
    (lr 5e-4, wd 1e-5, clip 1.0, the step schedule) from a flax model
    converted by ``jax_to_torch_state_dict``, on a seeded batch with soft
    answer labels (the BCE branch) and dropout off on both sides, the
    port's forward following JAX's side of 0 at every ReLU input that
    lies within 1e-3 of it, held to tests/test_torch_train.py's
    tolerances: loss and scalar metrics
    atol 1e-4 / rtol 1e-4; each gradient's median error within 1e-4 and
    every entry within 5e-3 of the tensor's largest entry; parameters
    after the step within 2e-5 where the gradients agree firmly (90% of
    entries; firm on the gradient Adam sees, clip(g) + wd p, where the
    coupled decay can cancel a gradient) and within 2.2 lr everywhere;
    BatchNorm statistics atol 1e-5 / rtol 1e-4; the frozen BERT
    bit-equal. The JAX step and its gradients come from one jitted
    function, compiled once;
  * ``Solver.eval_epoch`` over a ScanQA val split whose last batch is
    partial, its ``answer_acc_at1`` / ``answer_acc_at10`` against JAX
    ``answer_accuracy`` over the question slots the items fill (within
    1e-6);
  * ``python -m vlp3d_torch.cli.train_qa --synthetic --smoke --device
    cpu`` in process: info.json's ``num_answers``, the vocabulary file,
    the best model keyed on ``answer_acc_at1`` and ``--auto_resume``
    (``--pretrain`` runs in tests/test_torch_vqa.py, the shorter of the
    two files: this one compiles the JAX step).
"""

import dataclasses
import json
import os
import random

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.eval.vqa import answer_accuracy as jax_answer_accuracy
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d.models.attention import PositionwiseFeedForward as JaxFeedForward
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.train import schedules as jsched
from vlp3d.train.optimizer import make_optimizer as jax_make_optimizer
from vlp3d_torch.cli import train_qa
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import make_batch, synthetic_qa, tiny_config
from vlp3d_torch.data.tokenizer import HashTokenizer
from vlp3d_torch.data.vqa_dataset import ScanQADataset, build_answer_vocab
from vlp3d_torch.models import JointNet
from vlp3d_torch.models.layers import Dropout
from vlp3d_torch.train import schedules
from vlp3d_torch.train.optimizer import label_params, make_optimizer
from vlp3d_torch.train.solver import Solver
from vlp3d_torch.train.state import (
    backward_and_step,
    batch_to_device,
    make_train_step,
)

FLAGS = dict(use_answer=True, no_caption=True, use_con=False)
NUM_ANSWERS = 37
BATCH = 4
LR, WD, CLIP = 5e-4, 1e-5, 1.0
VQA = dict(optim_name="adam", single_group=True)
FLIP_TOL = 1e-3  # |input| of a kink that decided differently


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _answers(config):
    return dataclasses.replace(config, model=dataclasses.replace(
        config.model, num_answers=NUM_ANSWERS))


def _step_lr(e, lr0):
    return jsched.step_lr(e, lr0, (100, 200), 0.2)


# ---------------------------------------------------------------- optimizer


class _Toy(nn.Module):
    """A base module, a module-LR-group module (one group under the VQA
    recipe), and the frozen text encoder."""

    def __init__(self, rng):
        super().__init__()

        def leaf(*shape):
            m = nn.Module()
            m.w = nn.Parameter(torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)))
            return m

        self.backbone_net = leaf(5, 3)
        self.match = leaf(4)
        self.lang = nn.Module()
        self.lang.text_encoder = leaf(6)

    NAMES = ("backbone_net.w", "match.w", "lang.text_encoder.w")

    def tree(self):
        return {"backbone_net": {"w": self.backbone_net.w.detach().numpy()},
                "match": {"w": self.match.w.detach().numpy()},
                "lang": {"text_encoder": {
                    "w": self.lang.text_encoder.w.detach().numpy()}}}


def _leaves(tree):
    return {"backbone_net.w": tree["backbone_net"]["w"],
            "match.w": tree["match"]["w"],
            "lang.text_encoder.w": tree["lang"]["text_encoder"]["w"]}


@pytest.mark.parametrize("amsgrad", [False, True])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_vqa_optimizer_matches_optax(amsgrad, grad_accum):
    """3 updates (3 x grad_accum micro-batches, each through
    make_train_step's backward_and_step) against the optax chain, after
    every micro-batch. Gradients are ~N(0, 2): about a third of the
    entries exceed the clip at 1, and wd is large enough (0.3) for the
    coupled decay to move the moments. match.w gets no gradient in
    micro-batches 1-2 (``.grad`` None there, zeros on the JAX side): its
    coupled decay still enters its moments."""
    rng = np.random.default_rng(4)
    toy = _Toy(rng)
    params = jax.tree_util.tree_map(jnp.asarray, toy.tree())
    kw = dict(base_lr=2e-3, module_lr=7e-4, weight_decay=0.3,
              steps_per_epoch=2, amsgrad=amsgrad, clip_grad_value=CLIP,
              grad_accum=grad_accum, **VQA)
    jopt = jax_make_optimizer(lr_schedule=_step_lr, **kw)
    opt = make_optimizer(
        toy, lr_schedule=lambda e, lr0: schedules.step_lr(
            e, lr0, (100, 200), 0.2), **kw)
    assert label_params(toy, single_group=True) == {
        "backbone_net.w": "base", "match.w": "base",
        "lang.text_encoder.w": "frozen"}
    assert [g["name"] for g in opt.param_groups] == ["base"]
    frozen = toy.lang.text_encoder.w.detach().clone()
    state = jopt.init(params)
    for micro in range(3 * grad_accum):
        grads = jax.tree_util.tree_map(
            lambda a: (2.0 * rng.normal(size=a.shape)).astype(np.float32),
            toy.tree())
        grads["lang"]["text_encoder"]["w"][:] = 0.0
        no_grad = micro in (1, 2)
        if no_grad:
            grads["match"]["w"][:] = 0.0
        updates, state = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        loss = sum((toy.get_parameter(n) * torch.from_numpy(g)).sum()
                   for n, g in _leaves(grads).items()
                   if toy.get_parameter(n).requires_grad
                   and not (n == "match.w" and no_grad))
        backward_and_step(loss, opt)
        assert opt.step_count == (micro + 1) // grad_accum
        for name, want in _leaves(jax.device_get(params)).items():
            np.testing.assert_allclose(
                toy.get_parameter(name).detach().numpy(), want, rtol=1e-6,
                atol=1e-6, err_msg=f"{name} after micro-batch {micro + 1}")
    assert torch.equal(toy.lang.text_encoder.w, frozen)


def test_unknown_optimizer_name_raises():
    with pytest.raises(ValueError, match="optim_name"):
        make_optimizer(_Toy(np.random.default_rng(0)), optim_name="sgd")


# ------------------------------------------------ the train step as a whole


def _batch(config, seed=17):
    """make_batch plus the loader's answer labels: multi-hot answer_cats
    and soft answer_cat_scores (B, L, A), answer_cat their first label."""
    b = make_batch(config, batch_size=BATCH, num_points=256, seed=seed)
    rng = np.random.default_rng(seed + 100)
    l, a = config.model.lang_num_max, NUM_ANSWERS
    cats = (rng.random((BATCH, l, a)) < 0.08).astype(np.float32)
    cats[..., 0] += (cats.sum(-1) == 0)  # every question has an answer
    scores = cats * rng.choice([0.3, 0.6, 0.9, 1.0], size=(BATCH, l, a))
    b["answer_cats"] = cats
    b["answer_cat_scores"] = scores.astype(np.float32)
    b["answer_cat"] = np.argmax(cats, -1).astype(np.int32)
    b["random"] = np.float32(0.7)
    return b


@pytest.fixture(scope="module")
def jax_side():
    """(params, batch_stats, the port's state dict, the batch, and the
    JAX step's new params, statistics, metrics and gradients), from one
    compile of one jitted function: the body of
    ``vlp3d.train.state.make_train_step`` (the joint loss's gradients
    with the new BatchNorm statistics, then the optax update), with the
    gradients it used as an output. The weights are a seeded fill of the
    model's shapes (``jax.eval_shape`` of its init, no compile)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)
    try:
        config = _answers(jax_tiny_config(**FLAGS))
        model = JaxJointNet(config)
        batch = _batch(_answers(tiny_config(**FLAGS)))
        shapes = jax.eval_shape(lambda b: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
            train=True), batch)
        rng = np.random.default_rng(1)

        def param(path, a):
            name = path[-1].key
            if name in ("scale", "negative_slope") or (
                    name == "weight" and len(a.shape) == 1):
                return (1.0 + rng.normal(0.0, 0.05, a.shape)).astype(
                    np.float32)
            if name == "bias" or len(a.shape) < 2:
                return rng.normal(0.0, 0.01, a.shape).astype(np.float32)
            if name == "embedding":
                return rng.normal(0.0, 0.02, a.shape).astype(np.float32)
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, a.shape).astype(
                np.float32)

        def stat(path, a):
            if path[-1].key == "var":
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

        params = jax.tree_util.tree_map_with_path(param, shapes["params"])
        # tests/test_torch_train.py's nudges: every loss live
        for leaf in params["vgen"]["Dense_2"].values():
            leaf *= 0.05
        params["proposal"]["roi_heads"]["Dense_3"]["bias"][:] = -1.0
        stats = jax.tree_util.tree_map_with_path(stat,
                                                 shapes["batch_stats"])
        opt = jax_make_optimizer(
            base_lr=LR, module_lr=LR, weight_decay=WD, steps_per_epoch=100,
            lr_schedule=_step_lr, clip_grad_value=CLIP, **VQA)

        def loss_fn(p, b):
            out, upd = model.apply(
                {"params": p, "batch_stats": stats}, b, train=True,
                rngs={"dropout": jax.random.key(0), "aug": jax.random.key(0)},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=_kink_input)
            loss, m = jax_joint_loss(config, out, b)
            scalars = {k: v for k, v in m.items() if jnp.ndim(v) == 0}
            return loss, (scalars, upd["batch_stats"], upd["intermediates"])

        @jax.jit
        def run(b):
            grads, (metrics, new_stats, kinks) = jax.grad(
                loss_fn, has_aux=True)(params, b)
            updates, _ = opt.update(grads, opt.init(params), params)
            return (optax.apply_updates(params, updates), new_stats,
                    metrics, grads, kinks)

        result = jax.device_get(run(batch))
    finally:
        mp.undo()
    return dict(params=params, stats=stats, batch=batch, result=result,
                sd=jax_to_torch_state_dict(params, stats),
                kink_names=_kink_names(params, stats, result[4]))


def _kink_input(mdl, _):
    """The modules whose output a ReLU or PReLU reads: every BatchNorm,
    the relation module's distance-MLP linears and the first linear of
    every attention block's feed-forward."""
    return isinstance(mdl, fnn.BatchNorm) or (
        mdl.name is not None and mdl.name.startswith("attn_fc")
        and not mdl.name.endswith("_2")) or (
            mdl.name == "Dense_0"
            and isinstance(mdl.parent, JaxFeedForward))


def _kink_names(params, stats, kinks):
    """{port module name: the JAX module's captured output}. A BatchNorm
    is found by its running mean and a feed-forward's first linear by its
    bias: each JAX one gets a distinct constant, and
    jax_to_torch_state_dict says where it lands."""
    paths = []

    def mark(path, a):
        keys = tuple(k.key for k in path)
        if keys[-1] != "mean" and keys[-3:] != ("ffn", "Dense_0", "bias"):
            return a
        paths.append(keys[:-1])
        return np.full(a.shape, len(paths), np.float32)

    marked = jax_to_torch_state_dict(
        jax.tree_util.tree_map_with_path(mark, params),
        jax.tree_util.tree_map_with_path(mark, stats))
    out = {}
    for key, v in marked.items():
        for leaf in (".running_mean", ".ffn.linear1.bias"):
            if key.endswith(leaf):
                node = kinks
                for k in paths[int(v[0]) - 1]:
                    node = node[k]
                out[key[:-len(leaf.rpartition(".")[2]) - 1]] = node[
                    "__call__"][0]
    for name, node in kinks["relation"].items():
        if not name.startswith("attn_fc"):
            continue
        i, j = name.removeprefix("attn_fc").split("_")
        out[f"relation.self_attn_fc.{i}.{(0, 3)[int(j)]}"] = node[
            "__call__"][0]
    return out


def _follow_jax_kinks(model, jax_side, run):
    """Run ``run()`` with every kink input of the port on JAX's side of 0:
    where a unit is positive in one package and not in the other, its
    value becomes JAX's, and its gradient still flows into the port's
    module (straight through). Returns {module: (units moved, largest
    |input| of such a unit on either side)}."""
    mods = dict(model.named_modules())
    flips, hooks = {}, []
    for name, want in jax_side["kink_names"].items():
        def follow(mod, args, out, name=name,
                   want=torch.from_numpy(np.array(want))):
            flipped = (out > 0) != (want > 0)
            if not bool(flipped.any()):
                return None
            flips[name] = (int(flipped.sum()), float(torch.maximum(
                out.detach()[flipped].abs(), want[flipped].abs()).max()))
            return out + torch.where(flipped, want - out.detach(), 0.0)

        hooks.append(mods[name].register_forward_hook(follow))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return flips


def test_vqa_train_step_matches_jax(jax_side):
    """A ReLU (or PReLU) whose input lies within float32 rounding of 0
    can decide differently in the two packages; with BatchNorm in
    training mode the unit's share then moves its whole channel's
    gradient and everything the forward ran before it
    (tests/test_torch_train.py), and the answer loss, a sum over the
    answers, makes that share large. So the port's forward takes JAX's
    decision at every such unit (found by comparing each kink's input with
    the JAX forward's), and such a unit must lie within FLIP_TOL of 0 on
    both sides. Every tensor is then held at test_torch_train.py's
    tolerances. A tensor whose gradient is zero in exact arithmetic (the
    AttFlat logit's bias: softmax ignores a shift shared by all proposals)
    is rounding noise on both sides: every entry below 1e-6."""
    jparams, jstats, jmetrics, jgrads, _ = jax_side["result"]
    config = _answers(tiny_config(**FLAGS))
    model = JointNet(config, device="cpu")
    model.load_state_dict(jax_side["sd"], strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(
        model, base_lr=LR, module_lr=LR, weight_decay=WD,
        steps_per_epoch=100, clip_grad_value=CLIP,
        lr_schedule=lambda e, lr0: schedules.step_lr(e, lr0, (100, 200),
                                                     0.2), **VQA)
    step = make_train_step(model, config, opt)
    metrics = {}
    flips = _follow_jax_kinks(model, jax_side, lambda: metrics.update(step(
        batch_to_device(jax_side["batch"], "cpu"),
        torch.Generator().manual_seed(0))))

    assert set(metrics) == set(jmetrics) and "answer_loss" in metrics
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in ("answer_loss", "vote_loss", "lang_loss", "box_loss"):
        assert float(metrics[k]) > 0, k  # the losses are live
    for name, (_, near) in flips.items():
        assert near <= FLIP_TOL, (name, near)

    want_grads = jax_to_torch_state_dict(jgrads, jstats)
    want_after = jax_to_torch_state_dict(jparams, jstats)
    labels = label_params(model, single_group=True)
    held = []
    firm_n = total_n = 0
    for name, p in model.named_parameters():
        wg, wa = want_grads[name].numpy(), want_after[name].numpy()
        if labels[name] == "frozen":
            assert p.grad is None and not wg.any(), name
            assert torch.equal(p.detach(), before[name]), name
            continue
        got_g = np.zeros_like(wg) if p.grad is None else p.grad.numpy()
        err = np.abs(got_g - wg)
        if name == "answer.attflat_visual.mlp.linear.bias":
            assert np.abs(wg).max() < 1e-6 and np.abs(got_g).max() < 1e-6
            continue
        scale = max(float(np.abs(wg).max()), 1e-3)
        held.append(name)
        assert np.median(err) <= 1e-4 * scale, f"grad {name}"
        assert err.max() <= 5e-3 * scale, f"grad {name}"
        diff = np.abs(p.detach().numpy() - wa)
        assert diff.max() <= 2.2 * LR, name
        # Adam's first update is lr * g' / (|g'| + eps) of the gradient it
        # sees, g' = clip(g) + wd p: firm where g' is
        seen = np.clip(wg, -CLIP, CLIP) + WD * before[name].numpy()
        firm = (np.abs(seen) >= np.maximum(20 * err, 1e-7)) | (
            (wg == 0) & (got_g == 0))
        if firm.any():
            assert diff[firm].max() <= 2e-5, name
        firm_n += int(firm.sum())
        total_n += firm.size
    answer = [n for n in held if n.startswith("answer.")]
    assert len(answer) == 9, held  # the answer head, but for the bias
    print(f"kinks that followed JAX (module: units, largest |input|) "
          f"{flips}; {len(held)} gradient tensors held")
    assert firm_n >= 0.9 * total_n, (firm_n, total_n)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_after[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------- the Solver's EM


def test_solver_answer_em_on_a_partial_batch_matches_jax(tmp_path):
    """2 scenes x 4 questions at lang_num_max 3: 4 val items (3 + 1
    questions a scene, two slots of each second item padded), batch 3,
    so the last batch holds one item. The EM counts the filled slots
    only; JAX answer_accuracy over those rows must give the same."""
    config = _answers(tiny_config(**FLAGS))
    config = dataclasses.replace(
        config,
        model=dataclasses.replace(config.model, lang_num_max=3),
        train=dataclasses.replace(config.train, batch_size=3,
                                  num_workers=1))
    qa, source = synthetic_qa(config)
    vocab, counter = build_answer_vocab(qa)
    val = ScanQADataset(
        qa, source, HashTokenizer(), split="val", answer_vocab=vocab,
        answer_counter=counter, num_answers=NUM_ANSWERS,
        num_points=config.dataset.num_points, lang_num_max=3,
        bert_max_len=config.model.bert_seq_len,
        mean_size_arr=config.dataset.mean_size_arr())
    assert len(val) == 4
    solver = Solver(config, val, val, str(tmp_path), device="cpu")
    solver.init_state()
    seen = []
    eval_step = solver.eval_step

    def recording(batch):
        out, metrics = eval_step(batch)
        seen.append((out["answer_scores"].numpy(),
                     batch["answer_cats"].numpy(),
                     batch["lang_num"].numpy()))
        return out, metrics

    solver.eval_step = recording
    result = solver.eval_epoch(0)
    solver.close()
    assert [len(s[2]) for s in seen] == [3, 1]
    rows_s, rows_c = [], []
    for scores, cats, lang_num in seen:
        b, l = cats.shape[:2]
        valid = (np.arange(l)[None] < lang_num[:, None]).reshape(-1)
        rows_s.append(scores[valid])
        rows_c.append(cats.reshape(b * l, -1)[valid])
    assert sum(len(r) for r in rows_s) == 8  # every question, once
    acc1, acc10 = jax_answer_accuracy(jnp.asarray(np.concatenate(rows_s)),
                                      jnp.asarray(np.concatenate(rows_c)))
    assert result["answer_acc_at1"] == pytest.approx(float(acc1), abs=1e-6)
    assert result["answer_acc_at10"] == pytest.approx(float(acc10), abs=1e-6)
    assert result["answer_acc_at10"] >= result["answer_acc_at1"]


# ------------------------------------------------------------- the CLI


def _run_cli(tmp_path, *extra):
    workdir = str(tmp_path / "qa")
    random.seed(0)
    best = train_qa.main(["--synthetic", "--smoke", "--device", "cpu",
                          "--workdir", workdir, *extra])
    return workdir, best


def test_train_qa_cli_smoke(tmp_path, capsys):
    workdir, best = _run_cli(tmp_path)
    with open(os.path.join(workdir, "info.json")) as f:
        info = json.load(f)
    with open(os.path.join(workdir, "answer_vocab.json")) as f:
        vocab = json.load(f)
    assert info["num_answers"] == len(vocab) == 4
    assert vocab == sorted(vocab)
    assert 0.0 <= best["answer_acc_at1"] <= best["answer_acc_at10"] <= 1.0
    assert best["sum"] == best["answer_acc_at1"]  # keyed on EM@1
    with open(os.path.join(workdir, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    val = [r for r in records if r["phase"] == "val"]
    train = [r for r in records if r["phase"] == "train"]
    assert len(val) == 2 and "answer_acc_at10" in val[-1]
    assert train and all(np.isfinite(r["answer_loss"]) for r in train)
    assert os.path.exists(os.path.join(workdir, "model.pth"))
    # --auto_resume on the run's own checkpoint continues the clock
    capsys.readouterr()
    _run_cli(tmp_path, "--auto_resume")
    assert "continuing at epoch 2" in capsys.readouterr().out
