"""The joint train step of vlp3d_torch against the JAX package, on the CPU.

Schedules and the AdamW / AMSGrad trajectory are held to
``vlp3d.train.schedules`` and ``vlp3d.train.optimizer.make_optimizer`` over
5 steps of seeded gradients (atol 1e-6). Then the slice as a whole: a flax
JointNet at ``tiny_config(use_con=True, no_caption=True)`` with random
BatchNorm statistics goes through ``jax_to_torch_state_dict`` into the
port's JointNet, and one ``make_train_step`` step runs in both from the
same seeded batch, with dropout off on both sides (the two frameworks'
generators cannot agree; dropout has its own test in
test_torch_modules.py). The random model is nudged (small vote offsets,
~0.7 m boxes) so that proposals land on GT boxes and every loss is live.
Stated tolerances:

  * loss and every scalar metric: atol 1e-4 / rtol 1e-4;
  * every gradient tensor: median error at most 1e-4 of the tensor's
    largest entry, and every entry within 5e-3 of it. The two differ
    because a ReLU or a max pool whose input lies within float32 rounding
    of its threshold can fall on either side in the two frameworks: the
    forward moves by 1e-7, but that one row's share of the gradient
    appears or vanishes, and every layer below sees it (measured here: one
    ReLU input of 7e-7 in the voting module, one entry of its BatchNorm
    bias gradient off by 1.3e-3 of the largest, all others by 2e-6, and
    the SA1 gradients below it off by a median 3.5e-5 of their largest);
  * every BatchNorm statistic after the step: atol 1e-5 / rtol 1e-4;
  * every parameter after the step: within 2e-5 wherever the two
    gradients agree in more than their first digit (|g| >= 20 |dg|, and
    above 1e-7: there Adam's first update, lr * g / (|g| + eps), is the
    same to 1e-5), which must hold for 90% of all entries; and within
    2.2 * lr everywhere (where a gradient is rounding noise around 0,
    e.g. a bias in front of a BatchNorm, its sign is noise in both
    frameworks and the updates can differ by the full step either way);
  * the frozen BERT parameters: bit-equal to before the step.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d.train import schedules as jsched
from vlp3d.train.optimizer import make_optimizer as jax_make_optimizer
from vlp3d.train.state import TrainState
from vlp3d.train.state import make_eval_step as jax_make_eval_step
from vlp3d.train.state import make_train_step as jax_make_train_step
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.models.layers import Dropout
from vlp3d_torch.train import schedules
from vlp3d_torch.train.optimizer import label_params, make_optimizer
from vlp3d_torch.train.state import (
    backward_and_step,
    batch_to_device,
    make_eval_step,
    make_train_step,
)

FLAGS = dict(use_con=True, no_caption=True)
BATCH = 4
OPT = dict(base_lr=2e-3, module_lr=5e-4, weight_decay=1e-3,
           steps_per_epoch=100)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("epoch", [0, 1, 49, 100, 199, 200, 250])
def test_schedules_match_jax(epoch):
    for lr0 in (2e-3, 5e-4):
        assert schedules.cosine_lr(epoch, lr0, 200) == pytest.approx(
            float(jsched.cosine_lr(epoch, lr0, 200)), rel=1e-5)  # f32 cos in JAX
        assert schedules.step_lr(epoch, lr0, (80, 120, 160), 0.1) == \
            pytest.approx(jsched.step_lr(epoch, lr0, (80, 120, 160), 0.1))
    assert schedules.bn_momentum_torch(epoch) == jsched.bn_momentum_torch(epoch)


# ---------------------------------------------------------------- optimizer


class _Toy(nn.Module):
    """Parameters under a base module, two module-LR groups and the
    frozen text encoder."""

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
        self.lang.proj = leaf(3, 2)
        self.lang.text_encoder = leaf(6)

    def tree(self):
        return {
            "backbone_net": {"w": self.backbone_net.w.detach().numpy().copy()},
            "match": {"w": self.match.w.detach().numpy().copy()},
            "lang": {"proj": {"w": self.lang.proj.w.detach().numpy().copy()},
                     "text_encoder": {
                         "w": self.lang.text_encoder.w.detach().numpy().copy()}},
        }


def _leaves(tree):
    return {"backbone_net.w": tree["backbone_net"]["w"],
            "match.w": tree["match"]["w"],
            "lang.proj.w": tree["lang"]["proj"]["w"],
            "lang.text_encoder.w": tree["lang"]["text_encoder"]["w"]}


@pytest.mark.parametrize("amsgrad", [False, True])
@pytest.mark.parametrize("cosine", [False, True])
def test_adamw_trajectory_matches_jax(amsgrad, cosine):
    rng = np.random.default_rng(0)
    toy = _Toy(rng)
    params = jax.tree_util.tree_map(jnp.asarray, toy.tree())
    kw = dict(base_lr=2e-3, module_lr=5e-4, weight_decay=1e-2,
              steps_per_epoch=2, amsgrad=amsgrad)
    jopt = jax_make_optimizer(
        lr_schedule=(lambda e, lr0: jsched.cosine_lr(e, lr0, 3))
        if cosine else None, **kw)
    opt = make_optimizer(
        toy, lr_schedule=(lambda e, lr0: schedules.cosine_lr(e, lr0, 3))
        if cosine else None, **kw)
    assert label_params(toy) == {
        "backbone_net.w": "base", "match.w": "module",
        "lang.proj.w": "module", "lang.text_encoder.w": "frozen"}
    assert not toy.lang.text_encoder.w.requires_grad
    frozen_before = toy.lang.text_encoder.w.detach().clone()
    state = jopt.init(params)
    for step in range(5):
        # shrinking gradients, so AMSGrad's running maximum matters
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) / (1 + step)).astype(
                np.float32), toy.tree())
        grads["lang"]["text_encoder"]["w"][:] = 0.0  # stop_gradient in JAX
        updates, state = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        for name, g in _leaves(grads).items():
            p = toy.get_parameter(name)
            p.grad = torch.from_numpy(g.copy()) if p.requires_grad else None
        opt.step()
        for name, want in _leaves(jax.device_get(params)).items():
            np.testing.assert_allclose(
                toy.get_parameter(name).detach().numpy(), want, rtol=1e-6,
                atol=1e-6, err_msg=f"{name} after step {step + 1}")
    assert torch.equal(toy.lang.text_encoder.w, frozen_before)
    if cosine:  # each group anneals from its own base LR to the same eta_min
        lrs = {g["name"]: g["lr"] for g in opt.param_groups}
        assert lrs["base"] == pytest.approx(
            schedules.cosine_lr(2, 2e-3, 3)) and lrs["module"] == \
            pytest.approx(schedules.cosine_lr(2, 5e-4, 3))


def test_adamw_updates_a_parameter_without_a_gradient_as_optax():
    """A parameter with no gradient in a step (``.grad`` None, as the
    contrast head's before epoch 50) moves as optax moves one with a zero
    gradient: moments decay, weight decay applies."""
    rng = np.random.default_rng(3)
    toy = _Toy(rng)
    params = jax.tree_util.tree_map(jnp.asarray, toy.tree())
    kw = dict(base_lr=2e-3, module_lr=5e-4, weight_decay=0.5,
              steps_per_epoch=2)
    jopt = jax_make_optimizer(**kw)
    opt = make_optimizer(toy, **kw)
    state = jopt.init(params)
    for step in range(4):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32),
            toy.tree())
        grads["lang"]["text_encoder"]["w"][:] = 0.0
        if step >= 1:  # match.w gets no gradient from the second step on
            grads["match"]["w"][:] = 0.0
        updates, state = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        for name, g in _leaves(grads).items():
            p = toy.get_parameter(name)
            p.grad = (torch.from_numpy(g.copy())
                      if p.requires_grad and (name != "match.w" or step == 0)
                      else None)
        opt.step()
        for name, want in _leaves(jax.device_get(params)).items():
            np.testing.assert_allclose(
                toy.get_parameter(name).detach().numpy(), want, rtol=1e-6,
                atol=1e-6, err_msg=f"{name} after step {step + 1}")


@pytest.mark.parametrize("amsgrad", [False, True])
def test_adamw_grad_accum_trajectory_matches_jax(amsgrad):
    """grad_accum=2 against optax.MultiSteps over 8 micro-batches with a
    cosine schedule, each micro-batch through make_train_step's
    ``backward_and_step`` (``.grad`` cleared at a window's start,
    ``backward(loss / k)`` adds, a step on every k-th). match.w gets no
    gradient in micro-batch 3 (one half of a window) and in neither of
    micro-batches 4-5 (a whole window: ``.grad`` stays None), where JAX
    sees zeros. lang.proj.w's gradients are ~1e-8, near Adam's eps, where
    a sum of the micro-batches' gradients would move it otherwise than
    their mean does (elsewhere Adam's update does not see the scale).
    Parameters are compared after every micro-batch: they hold still
    inside a window."""
    k, n_micro = 2, 8
    rng = np.random.default_rng(5)
    toy = _Toy(rng)
    params = jax.tree_util.tree_map(jnp.asarray, toy.tree())
    kw = dict(base_lr=2e-3, module_lr=5e-4, weight_decay=1e-2,
              steps_per_epoch=1, amsgrad=amsgrad, grad_accum=k)
    jopt = jax_make_optimizer(
        lr_schedule=lambda e, lr0: jsched.cosine_lr(e, lr0, 3), **kw)
    opt = make_optimizer(
        toy, lr_schedule=lambda e, lr0: schedules.cosine_lr(e, lr0, 3), **kw)
    state = jopt.init(params)
    for micro in range(n_micro):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) / (1 + micro)).astype(
                np.float32), toy.tree())
        grads["lang"]["text_encoder"]["w"][:] = 0.0
        # near Adam's eps, where the update tells a mean from a sum
        grads["lang"]["proj"]["w"] *= 1e-8
        no_grad = micro in (3, 4, 5)
        if no_grad:
            grads["match"]["w"][:] = 0.0
        updates, state = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)

        # a loss whose gradient is this micro-batch's
        loss = sum((toy.get_parameter(name) * torch.from_numpy(g)).sum()
                   for name, g in _leaves(grads).items()
                   if toy.get_parameter(name).requires_grad
                   and not (name == "match.w" and no_grad))
        backward_and_step(loss, opt)
        if micro == 4:  # a window's first micro-batch without a gradient
            assert toy.match.w.grad is None
        assert opt.step_count == (micro + 1) // k
        for name, want in _leaves(jax.device_get(params)).items():
            np.testing.assert_allclose(
                toy.get_parameter(name).detach().numpy(), want, rtol=1e-6,
                atol=1e-6, err_msg=f"{name} after micro-batch {micro + 1}")


# tests/test_torch_train_qa.py holds the VQA recipe as a whole.
@pytest.mark.parametrize("kw", [{"optim_name": "adam"}, {"single_group": True},
                                {"clip_grad_value": 1.0},
                                {"grad_accum": 2, "optim_name": "adam"},
                                {"optim_name": "adam", "single_group": True,
                                 "clip_grad_value": 0.5, "amsgrad": True}])
def test_vqa_optimizer_options_match_optax(kw):
    rng = np.random.default_rng(6)
    toy = _Toy(rng)
    params = jax.tree_util.tree_map(jnp.asarray, toy.tree())
    kw = dict(base_lr=2e-3, module_lr=5e-4, weight_decay=0.1,
              steps_per_epoch=2, **kw)
    jopt = jax_make_optimizer(**kw)
    opt = make_optimizer(toy, **kw)
    groups = 1 if kw.get("single_group") else 2
    assert len(opt.param_groups) == groups
    state = jopt.init(params)
    for micro in range(3 * kw.get("grad_accum", 1)):
        grads = jax.tree_util.tree_map(
            lambda a: (2.0 * rng.normal(size=a.shape)).astype(np.float32),
            toy.tree())
        grads["lang"]["text_encoder"]["w"][:] = 0.0
        updates, state = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        loss = sum((toy.get_parameter(name) * torch.from_numpy(g)).sum()
                   for name, g in _leaves(grads).items()
                   if toy.get_parameter(name).requires_grad)
        backward_and_step(loss, opt)
        for name, want in _leaves(jax.device_get(params)).items():
            np.testing.assert_allclose(
                toy.get_parameter(name).detach().numpy(), want, rtol=1e-6,
                atol=1e-6, err_msg=f"{name} after micro-batch {micro + 1}")


def test_remat_raises(monkeypatch):
    """remat builds, but a Dropout inside a rematerialised block raises:
    its recompute would draw another mask from the generator that
    set_dropout_generator installs, which the checkpoint does not
    restore."""
    from vlp3d_torch.models import backbone, layers

    model = JointNet(tiny_config(remat=True, **FLAGS), device="cpu")
    assert model.backbone_net.remat

    class FPWithDropout(layers.FPModule):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.drop = Dropout(0.1)

    monkeypatch.setattr(backbone, "FPModule", FPWithDropout)
    with pytest.raises(ValueError, match="Dropout"):
        JointNet(tiny_config(remat=True, **FLAGS), device="cpu")
    JointNet(tiny_config(**FLAGS), device="cpu")  # without remat it may


# ------------------------------------------------------- the slice as a whole


def _cosine(e, lr0):
    return jsched.cosine_lr(e, lr0, 200)


@pytest.fixture(scope="module")
def jax_side():
    """Initial (params, batch_stats, port state dict) and a jitted
    function running the JAX train step plus the gradients it used."""
    return jax_reference()


def jax_reference(batches=(), warm=(BATCH, 1), evaluate_too=True) -> dict:
    """:func:`jax_side`'s dict, tracing ``run`` at the batch sizes of
    ``warm`` (and ``evaluate`` with ``evaluate_too``), plus under
    ``"results"`` the JAX step on each of ``batches``, run while flax's
    Dropout is the identity (a file that needs one batch's step compiles
    one program)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)
    try:
        config = jax_tiny_config(**FLAGS)
        model = JaxJointNet(config)
        b0 = make_batch(tiny_config(**FLAGS), batch_size=BATCH,
                        num_points=256, seed=5)
        v = jax.device_get(jax.jit(lambda b: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
            train=True))(b0))
        rng = np.random.default_rng(1)

        def stat(path, a):
            if path[-1].key == "var":
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

        params = jax.tree_util.tree_map(np.array, v["params"])
        # nudge the random model so that every loss is live: votes stay
        # near their seeds (half of which lie on objects) and boxes are
        # ~0.7 m wide, so some proposals lie within 0.3 m of a GT center
        # and overlap it by more than 0.25
        for leaf in params["vgen"]["Dense_2"].values():
            leaf *= 0.05
        params["proposal"]["roi_heads"]["Dense_3"]["bias"][:] = -1.0
        stats = jax.tree_util.tree_map_with_path(stat, v["batch_stats"])
        opt = jax_make_optimizer(lr_schedule=_cosine, **OPT)
        train_step = jax_make_train_step(model, config, opt)
        eval_step = jax_make_eval_step(model, config)

        def loss_fn(p, batch):
            out, _ = model.apply(
                {"params": p, "batch_stats": stats}, batch, train=True,
                rngs={"dropout": jax.random.key(0), "aug": jax.random.key(0)},
                mutable=["batch_stats"])
            return jax_joint_loss(config, out, batch)[0]

        @jax.jit
        def run(batch):
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=opt.init(params))
            new, metrics = train_step(state, batch, jax.random.key(0))
            return (new.params, new.batch_stats, metrics,
                    jax.grad(loss_fn)(params, batch))

        @jax.jit
        def evaluate(batch):
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=None)
            return eval_step(state, batch)

        # trace every shape the tests use while flax's Dropout is the
        # identity: a later trace would draw dropout again
        for scenes in warm:
            jax.block_until_ready(run(make_batch(
                tiny_config(**FLAGS), batch_size=scenes, num_points=256,
                seed=6)))
        if evaluate_too:
            jax.block_until_ready(evaluate(make_batch(
                tiny_config(**FLAGS), batch_size=BATCH, num_points=256,
                seed=6)))
        results = [jax.device_get(run(b)) for b in batches]
    finally:
        mp.undo()
    return dict(params=params, stats=stats, run=run, evaluate=evaluate,
                sd=jax_to_torch_state_dict(params, stats), results=results)


def _port(sd):
    config = tiny_config(**FLAGS)
    model = JointNet(config, device="cpu")
    model.load_state_dict(sd, strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return config, model


def _batch(epoch, gate, seed=17, batch_size=BATCH):
    # seed 17: some proposals of the nudged model land on GT boxes, so the
    # box, reference, DIoU and contrast losses are all live
    b = make_batch(tiny_config(**FLAGS), batch_size=batch_size,
                   num_points=256, seed=seed, epoch=epoch)
    b["random"] = np.float32(gate)
    return b


# The epoch-60 case, where OCC/OSC are live, runs one scene: the JAX
# contrast module masks every scene's OSC logits with scene 0's objectness
# (see test_contrast_module_masks_each_scene_with_its_own_objectness in
# test_torch_modules.py), so on several scenes the two packages differ by
# design. The gate of 0.3 turns on copy-paste and the objectness masking
# of the labels.
@pytest.mark.parametrize("epoch,gate,scenes", [(0, 0.7, BATCH),
                                               (10, 0.3, BATCH),
                                               (60, 0.3, 1)])
def test_train_step_matches_jax(jax_side, epoch, gate, scenes):
    batch = _batch(epoch, gate, batch_size=scenes)
    jparams, jstats, jmetrics, jgrads = jax.device_get(jax_side["run"](batch))
    config, model = _port(jax_side["sd"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(
        model, lr_schedule=lambda e, lr0: schedules.cosine_lr(e, lr0, 200),
        **OPT)
    step = make_train_step(model, config, opt)
    metrics = step(batch_to_device(batch, "cpu"),
                   torch.Generator().manual_seed(0))
    assert_step_matches(model, before, metrics, jmetrics,
                        jax_to_torch_state_dict(jgrads, jstats),
                        jax_to_torch_state_dict(jparams, jstats), epoch)


def assert_step_matches(model, before, metrics, want_metrics, want_grads,
                        want_after, epoch):
    """The step's metrics, the gradients in ``.grad``, the parameters and
    BatchNorm statistics ``model`` holds after it against another run of
    the step (reference-layout names), at this file's stated tolerances;
    ``before`` is the state dict before the step.
    tests/test_torch_ddp.py holds the data-parallel step to it."""
    assert set(metrics) == set(want_metrics)
    for k, want in want_metrics.items():
        np.testing.assert_allclose(np.asarray(metrics[k]), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    for k in ("pos_ratio", "ref_loss", "diou_loss", "box_loss", "lang_loss"):
        assert float(metrics[k]) > 0, k  # every loss is live
    assert (float(metrics["con_loss"]) > 0) == (epoch >= 50)

    lr = {"base": OPT["base_lr"], "module": OPT["module_lr"]}
    labels = label_params(model)
    trained = firm_n = total_n = 0
    for name, p in model.named_parameters():
        wg, wa = want_grads[name].numpy(), want_after[name].numpy()
        if labels[name] == "frozen":
            assert p.grad is None and not wg.any(), name
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(wa, before[name].numpy())
            continue
        got_g = np.zeros_like(wg) if p.grad is None else p.grad.numpy()
        err = np.abs(got_g - wg)
        # floor: a gradient that is zero by construction (a bias in front
        # of a BatchNorm) is rounding noise of ~1e-7 in both frameworks
        scale = max(float(np.abs(wg).max()), 1e-3)
        assert np.median(err) <= 1e-4 * scale, f"grad {name}"
        assert err.max() <= 5e-3 * scale, f"grad {name}"
        diff = np.abs(p.detach().numpy() - wa)
        assert diff.max() <= 2.2 * lr[labels[name]], name
        firm = (np.abs(wg) >= np.maximum(20 * err, 1e-7)) | (
            (wg == 0) & (got_g == 0))
        if firm.any():
            assert diff[firm].max() <= 2e-5, name
        firm_n += int(firm.sum())
        total_n += firm.size
        trained += 1
    assert trained > 100
    assert firm_n >= 0.9 * total_n, (firm_n, total_n)

    stats = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_after[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            assert not torch.equal(buf, before[name]), name
            stats += 1
        elif name.endswith("num_batches_tracked"):
            assert int(buf) == 1
    assert stats == 2 * 24  # every BatchNorm of the model


def test_train_step_moves_the_epoch_gates(jax_side):
    """Before epoch 50 the contrast losses are gated off and ref weighs
    0.3; from epoch 50 on ref weighs 1.0."""
    config, model = _port(jax_side["sd"])
    opt = make_optimizer(model, **OPT)
    step = make_train_step(model, config, opt)
    early = step(batch_to_device(_batch(0, 0.7), "cpu"))
    config, model = _port(jax_side["sd"])
    step = make_train_step(model, config, make_optimizer(model, **OPT))
    late = step(batch_to_device(_batch(60, 0.7), "cpu"))
    assert float(early["con_loss"]) == 0.0
    np.testing.assert_allclose(
        float(late["loss"]) - float(early["loss"]),
        0.7 * float(early["ref_loss"]) + float(late["con_loss"]), atol=1e-4)


def test_eval_step_matches_jax(jax_side):
    batch = _batch(60, 0.7, seed=8)
    batch["istrain"] = np.int32(0)
    jout, jmetrics = jax.device_get(jax_side["evaluate"](batch))
    config, model = _port(jax_side["sd"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out, metrics = make_eval_step(model, config)(batch_to_device(batch, "cpu"))
    assert not model.training and not out["cluster_ref"].requires_grad
    for k in ("sa1_inds", "aggregated_vote_inds", "objectness_masks"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    np.testing.assert_allclose(out["cluster_ref"].numpy(),
                               np.asarray(jout["cluster_ref"]), rtol=1e-4,
                               atol=1e-4)
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k, v in model.state_dict().items():  # evaluation changes no state
        assert torch.equal(v, before[k]), k


def test_repeated_steps_on_one_batch_lower_the_loss(jax_side):
    """The vote and language losses are fixed objectives of one batch and
    must fall. The total need not: the box losses switch on as soon as a
    proposal lands within 0.3 m of a GT center (pos_ratio leaves 0)."""
    config, model = _port(jax_side["sd"])
    opt = make_optimizer(model, base_lr=5e-4, module_lr=5e-4,
                         weight_decay=1e-3)
    step = make_train_step(model, config, opt)
    batch = batch_to_device(_batch(0, 0.7), "cpu")
    runs = [step(batch) for _ in range(8)]
    for key in ("vote_loss", "lang_loss"):
        series = [float(m[key]) for m in runs]
        assert max(series[-3:]) < series[0], (key, series)
    assert all(np.isfinite(float(m["loss"])) for m in runs)
    assert opt.step_count == 8
