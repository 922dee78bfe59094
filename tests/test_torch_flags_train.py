"""The grounding model's options in training, vlp3d_torch against the JAX
package on the CPU: the loss terms they add, and whole train steps.

  * each loss term against ``vlp3d.losses`` on the same seeded inputs,
    value and input gradients (``jax.grad``) within atol 1e-5 / rtol
    1e-5: ``kl_loss`` (the KL branch of ``compute_diou_loss``),
    ``compute_vote_weight_loss``, the DIoU on boxes plus the regression
    head's offsets, and ``compute_joint_loss`` with ``detection=False``,
    with ``reference=False`` and with ``use_lang_classifier=False``
    (every metric, not only the loss: the detection metrics are computed
    either way);
  * one whole train step of a model with every option on (the
    vote-weight predictor, the KL head, box masking with the same
    injected draws on both sides, the reference's multiview read,
    DistilBERT, the lang-emb scorer, the regression head, no language
    classifier) from a flax model converted by
    ``jax_to_torch_state_dict``, AdamW on the cosine schedule, dropout off
    on both sides, the port following JAX's side of 0 at every ReLU /
    PReLU input within 1e-3 of it (tests/test_torch_train_qa.py's rule),
    held at tests/test_torch_train.py's tolerances: loss and scalar
    metrics atol 1e-4 / rtol 1e-4; each gradient's median error within
    1e-4 and every entry within 5e-3 of the tensor's largest entry;
    parameters after the step within 2e-5 where the gradients agree
    firmly (90% of the entries) and within 2.2 lr everywhere; BatchNorm
    statistics atol 1e-5 / rtol 1e-4; the frozen text encoder
    bit-equal. The options' biases in front of a BatchNorm have no
    gradient in exact arithmetic: rounding noise below 1e-4 on both
    sides;
  * one step under ``compute_dtype="bfloat16"`` against JAX's bfloat16
    step: the batch statistics of bfloat16 activations, summed in another
    order, move whole bfloat16 units between the two packages
    (tests/test_torch_flags.py), so the port takes JAX's output of every
    module a ReLU reads, and the step's own arithmetic is held at
    BF16_STEP (4x the largest error measured, CHANGES.md);
  * ``Solver(reference=False)`` over a ``no_reference`` model, where
    JAX's Solver raises (ROADMAP.md C8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.losses import grounding as jax_grounding
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.train import schedules as jsched
from vlp3d.train.optimizer import make_optimizer as jax_make_optimizer
from vlp3d_torch import convert
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.losses import grounding
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.models import JointNet
from vlp3d_torch.train import schedules
from vlp3d_torch.train.optimizer import label_params, make_optimizer
from vlp3d_torch.train.state import batch_to_device, make_train_step

from test_torch_flags import (  # noqa: I001 (a test module's helpers)
    BASE,
    OPTIONS,
    injected_box_masks,
    no_jax_dropout,
    no_port_dropout,
    seeded,
)
from test_torch_train_qa import (  # noqa: I001
    FLIP_TOL,
    _follow_jax_kinks,
    _kink_input,
    _kink_names,
)

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 4
OPT = dict(base_lr=2e-3, module_lr=5e-4, weight_decay=1e-3,
           steps_per_epoch=100)
# the bfloat16 step against JAX's: (loss and metrics, relative; gradient
# median and largest error, of the tensor's largest entry)
BF16_STEP = dict(metric=4 * 2.2e-7, median=4 * 3.7e-3, largest=4 * 1.9e-2)
# biases in front of a training-mode BatchNorm: zero gradient in exact
# arithmetic (the normalisation removes any shift), rounding noise in both
# packages, held below ZERO_GRAD
ZERO_BY_CONSTRUCTION = (
    "proposal.votes_weight_predictor.0.bias", "match.lang_emb_proj.0.bias",
    "match.lang_emb_proj.3.bias", "match.reg_head.0.bias",
    "match.reg_head.3.bias")
ZERO_GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- loss terms


def _diou_inputs(seed, b=3, l=4, k=16):
    rng = np.random.default_rng(seed)
    gt_center = rng.uniform(0, 4, (b, l, 3)).astype(np.float32)
    gt_size = rng.uniform(0.3, 1.5, (b, l, 3)).astype(np.float32)
    # proposals near the GT boxes, so IoUs are positive
    pick = rng.integers(0, l, (b, k))
    center = (np.take_along_axis(gt_center, pick[..., None], 1)
              + rng.normal(0, 0.15, (b, k, 3))).astype(np.float32)
    size = (np.take_along_axis(gt_size, pick[..., None], 1)
            * rng.uniform(0.7, 1.3, (b, k, 3))).astype(np.float32)
    floats = dict(
        pred_center=center, pred_size=size,
        cluster_ref=rng.normal(size=(b * l, k)).astype(np.float32),
        pred_center_reg=rng.uniform(-0.05, 0.05, (b, l, k, 3)).astype(
            np.float32),
        pred_size_reg=rng.uniform(-0.05, 0.05, (b, l, k, 3)).astype(
            np.float32),
        alpha=rng.uniform(-0.05, 0.05, (b, k, 6)).astype(np.float32))
    fixed = dict(
        objectness_masks=(rng.random((b, k)) < 0.6).astype(np.float32),
        gt_center=gt_center, gt_size=gt_size,
        lang_num=np.array([4, 2, 3], np.int32)[:b], epoch=np.int32(10),
        istrain=np.int32(1), random_gate=np.float32(0.3))
    return floats, fixed


def _jax_grads(fn, floats):
    """(value, {name: gradient}) of fn(**floats) in JAX, jitted."""
    names = list(floats)
    val, grads = jax.jit(jax.value_and_grad(
        lambda *a: fn(**dict(zip(names, a))),
        argnums=tuple(range(len(names)))))(
        *[jnp.asarray(floats[n]) for n in names])
    return float(val), dict(zip(names, (np.asarray(g) for g in grads)))


def _port_grads(fn, floats):
    ts = {n: torch.from_numpy(a.copy()).requires_grad_(True)
          for n, a in floats.items()}
    val = fn(**ts)
    val.backward()
    return float(val.detach()), {n: (t.grad.numpy() if t.grad is not None
                            else np.zeros_like(floats[n]))
                        for n, t in ts.items()}


def _hold(port, jax_side):
    (pv, pg), (jv, jg) = port, jax_side
    np.testing.assert_allclose(pv, jv, **TOL)
    for n in jg:
        np.testing.assert_allclose(pg[n], jg[n], err_msg=n, **TOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_kl_loss_matches_jax(seed):
    """The KL branch: only alpha gets a gradient (the boxes and GT are
    detached); channel 3 of alpha none."""
    floats, fixed = _diou_inputs(seed)

    def jfn(**f):
        return jax_grounding.compute_diou_loss(**f, **{
            k: jnp.asarray(v) for k, v in fixed.items()})["kl_loss"]

    def pfn(**f):
        return grounding.compute_diou_loss(**f, **{
            k: torch.as_tensor(v) for k, v in fixed.items()})["kl_loss"]

    port, want = _port_grads(pfn, floats), _jax_grads(jfn, floats)
    _hold(port, want)
    assert abs(port[0]) > 0.01
    assert not port[1]["pred_center"].any() and not port[1][
        "cluster_ref"].any()
    assert not port[1]["alpha"][..., 3].any() and port[1]["alpha"].any()


@pytest.mark.parametrize("seed", [1, 2])
def test_diou_with_regressed_boxes_matches_jax(seed):
    """ref_loss and diou_loss over boxes plus the regression offsets;
    the gradient reaches the offsets, the boxes and the confidences."""
    floats, fixed = _diou_inputs(seed)
    del floats["alpha"]
    for key in ("diou_loss", "ref_loss"):
        def jfn(**f):
            return jax_grounding.compute_diou_loss(**f, **{
                k: jnp.asarray(v) for k, v in fixed.items()})[key]

        def pfn(**f):
            return grounding.compute_diou_loss(**f, **{
                k: torch.as_tensor(v) for k, v in fixed.items()})[key]

        port, want = _port_grads(pfn, floats), _jax_grads(jfn, floats)
        _hold(port, want)
        assert port[0] > 0, key
    assert np.abs(port[1]["pred_center_reg"]).max() == 0  # ref_loss
    port = _port_grads(lambda **f: grounding.compute_diou_loss(**f, **{
        k: torch.as_tensor(v) for k, v in fixed.items()})["diou_loss"],
        floats)
    assert np.abs(port[1]["pred_center_reg"]).max() > 0
    # the offsets move the IoU, so the labels and the loss
    base = grounding.compute_diou_loss(**{
        k: torch.as_tensor(v) for k, v in {**floats, **fixed}.items()
        if not k.endswith("_reg")})["diou_loss"]
    assert float(base) != pytest.approx(port[0], abs=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_vote_weight_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (2, 32, 1)).astype(np.float32)
    w[0, :3, 0] = [0.0, 1.0, 1e-9]  # the clip at both ends
    seed_inds = rng.integers(0, 64, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.5).astype(np.int64)
    want = _jax_grads(lambda vote_weights: jax_grounding.
                      compute_vote_weight_loss(vote_weights, seed_inds, mask),
                      {"vote_weights": w})
    port = _port_grads(lambda vote_weights: grounding.compute_vote_weight_loss(
        vote_weights, torch.from_numpy(seed_inds), torch.from_numpy(mask)),
        {"vote_weights": w})
    _hold(port, want)


@pytest.mark.parametrize("case", [
    dict(detection=False), dict(reference=False),
    dict(use_lang_classifier=False)])
def test_joint_loss_switches_match_jax(case):
    """compute_joint_loss with the detection terms left out, the
    reference terms left out, or no language classifier: every metric
    within 1e-5 of JAX's, and the loss's gradients with respect to the
    outputs it reads."""
    flags = {**BASE, **OPTIONS, "use_distil": False,
             "use_lang_classifier": case.get("use_lang_classifier", True)}
    config = tiny_config(**flags)
    jconfig = jax_tiny_config(**flags)
    model = JointNet(config, device="cpu")
    batch = make_batch(config, batch_size=2, num_points=256, seed=17)
    batch["random"] = np.float32(0.3)
    with torch.no_grad():
        out = model(batch_to_device(batch, "cpu"), train=True)
    outputs = {k: v.detach().numpy() for k, v in out.items()
               if torch.is_tensor(v)}
    kw = {k: v for k, v in case.items() if k != "use_lang_classifier"}
    floats = {k: v for k, v in outputs.items()
              if v.dtype == np.float32 and k in (
                  "vote_xyz", "objectness_scores", "rois", "sem_cls_scores",
                  "heading_scores", "heading_residuals_normalized",
                  "pred_center", "pred_size", "cluster_ref", "alpha",
                  "vote_weights", "pred_center_reg", "pred_size_reg",
                  "lang_scores")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = batch_to_device(batch, "cpu")

    def jfn(**f):
        return jax_joint_loss(jconfig, {**outputs, **f}, jbatch, **kw)

    def pfn(**f):
        return compute_joint_loss(config, {**{
            k: torch.from_numpy(v) for k, v in outputs.items()}, **f},
            tbatch, **kw)

    jloss, jmetrics = jax.device_get(jax.jit(jfn)(**floats))
    ploss, pmetrics = pfn(**{k: torch.from_numpy(v)
                             for k, v in floats.items()})
    jm = {k: v for k, v in jmetrics.items() if np.ndim(v) == 0}
    pm = {k: v for k, v in pmetrics.items() if v.dim() == 0}
    assert set(pm) == set(jm), set(pm) ^ set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), err_msg=k, **TOL)
    assert "box_loss" in pm and "vote_loss" in pm  # computed either way
    if case.get("detection") is False:  # only the sum lost these terms
        full, _ = compute_joint_loss(config, {
            k: torch.from_numpy(v) for k, v in outputs.items()}, tbatch)
        det = config.loss.detection_scale * (
            pm["vote_loss"] + 0.1 * pm["objectness_loss"] + pm["box_loss"])
        np.testing.assert_allclose(float(full - ploss), float(det),
                                   rtol=1e-5)
    if case.get("reference") is False:
        assert "ref_loss" not in pm and "kl_loss" not in pm
    if "use_lang_classifier" in case:
        assert "lang_loss" not in pm and "lang_scores" not in outputs
    _hold(_port_grads(lambda **f: pfn(**f)[0], floats),
          _jax_grads(lambda **f: jfn(**f)[0], floats))


# ------------------------------------------------------- whole train steps


def _cosine(e, lr0):
    return jsched.cosine_lr(e, lr0, 200)


def jax_step(flags):
    """The JAX side of a whole step: seeded weights with
    tests/test_torch_train.py's nudges (every loss live), one batch, and
    one jitted function giving the new params, statistics, metrics,
    gradients and every ReLU / PReLU input (the body of
    ``vlp3d.train.state.make_train_step``)."""
    config = jax_tiny_config(**flags)
    model = JaxJointNet(config)
    batch = make_batch(tiny_config(**flags), batch_size=BATCH,
                       num_points=256, seed=17)
    batch["random"] = np.float32(0.7)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "aug": jax.random.key(2)}, b, train=True), batch)
    params, stats = seeded(shapes, 1)
    for leaf in params["vgen"]["Dense_2"].values():
        leaf *= 0.05
    params["proposal"]["roi_heads"]["Dense_3"]["bias"][:] = -1.0
    opt = jax_make_optimizer(lr_schedule=_cosine, **OPT)

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
        return (optax.apply_updates(params, updates), new_stats, metrics,
                grads, kinks)

    with no_jax_dropout(), injected_box_masks(tiny_config(**flags), BATCH):
        result = jax.device_get(run(batch))
    # bfloat16 activations (compute_dtype) compared as float32
    result = result[:4] + (jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), result[4]),)
    return dict(params=params, stats=stats, batch=batch, result=result,
                kink_names=_kink_names(params, stats, result[4]))


def port_step(flags, side, take_all=False):
    """The port's step from the same weights and batch, following JAX's
    kinks (with ``take_all``, taking JAX's value at every unit of those
    modules) -> (model, metrics, {module: units followed}, state
    before)."""
    config = tiny_config(**flags)
    model = no_port_dropout(JointNet(config, device="cpu"))
    model.load_state_dict(convert.jax_to_torch_state_dict(
        side["params"], side["stats"]), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(
        model, lr_schedule=lambda e, lr0: schedules.cosine_lr(e, lr0, 200),
        **OPT)
    step = make_train_step(model, config, opt)
    metrics = {}
    run = lambda: metrics.update(step(  # noqa: E731
        batch_to_device(side["batch"], "cpu"),
        torch.Generator().manual_seed(0)))
    with injected_box_masks(config, BATCH):
        if take_all:
            flips = _take_jax_outputs(model, side["kink_names"], run)
        else:
            flips = _follow_jax_kinks(model, side, run)
    return model, metrics, flips, before


def _take_jax_outputs(model, kink_names, run):
    """Run ``run()`` with every module of ``kink_names`` giving JAX's
    output (its gradient flows straight through into the port's module);
    returns {module: largest change}."""
    mods, moved, hooks = dict(model.named_modules()), {}, []
    for name, want in kink_names.items():
        def take(mod, args, out, name=name,
                 want=torch.from_numpy(np.array(want))):
            moved[name] = float((want - out.detach()).abs().max())
            return out + (want - out.detach())

        hooks.append(mods[name].register_forward_hook(take))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return moved


def test_train_step_with_every_option_matches_jax():
    flags = {**BASE, **OPTIONS}
    side = jax_step(flags)
    jparams, jstats, jmetrics, jgrads, _ = side["result"]
    model, metrics, flips, before = port_step(flags, side)

    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in ("kl_loss", "vote_weight_loss", "diou_loss", "ref_loss",
              "vote_loss"):
        assert float(metrics[k]) > 0, k  # the losses are live
    assert "lang_loss" not in metrics
    for name, (_, near) in flips.items():
        assert near <= FLIP_TOL, (name, near)

    want_grads = convert.jax_to_torch_state_dict(jgrads, jstats)
    want_after = convert.jax_to_torch_state_dict(jparams, jstats)
    lr = {"base": OPT["base_lr"], "module": OPT["module_lr"]}
    labels = label_params(model)
    firm_n = total_n = held = 0
    for name, p in model.named_parameters():
        wg, wa = want_grads[name].numpy(), want_after[name].numpy()
        if labels[name] == "frozen":
            assert p.grad is None and not wg.any(), name
            assert torch.equal(p.detach(), before[name]), name
            continue
        got_g = np.zeros_like(wg) if p.grad is None else p.grad.numpy()
        err = np.abs(got_g - wg)
        if name in ZERO_BY_CONSTRUCTION:
            assert np.abs(wg).max() < ZERO_GRAD, name
            assert np.abs(got_g).max() < ZERO_GRAD, name
            continue
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
        held += 1
    for name in ("proposal.votes_weight_predictor.0.weight",
                 "proposal.proposal.alpha_predictor.weight",
                 "match.lang_emb_proj.6.weight", "match.reg_head.6.weight",
                 "match.lang_emb_cross_attn.attention.fc_q.weight"):
        assert model.get_parameter(name).grad.abs().max() > 0, name
    assert firm_n >= 0.9 * total_n, (firm_n, total_n)
    print(f"kinks that followed JAX {flips}; {held} gradient tensors held")
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_after[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_bf16_train_step_matches_jax_bf16():
    """compute_dtype="bfloat16": one step against JAX's bfloat16 step.
    Batch statistics of bfloat16 activations summed in another order move
    whole bfloat16 units (tests/test_torch_flags.py), so the port takes
    JAX's output of every module a ReLU reads (gradient straight
    through), and the step's own arithmetic is held: the loss and every
    scalar metric within BF16_STEP["metric"] (relative, floor 1); each
    gradient's median and largest error within BF16_STEP of its largest
    entry."""
    flags = {**BASE, "compute_dtype": "bfloat16"}
    side = jax_step(flags)
    _, _, jmetrics, jgrads, _ = side["result"]
    model, metrics, flips, _ = port_step(flags, side, take_all=True)
    assert set(metrics) == set(jmetrics)
    worst_metric = max(
        abs(float(metrics[k]) - float(v)) / max(abs(float(v)), 1.0)
        for k, v in jmetrics.items())
    want_grads = convert.jax_to_torch_state_dict(jgrads, side["stats"])
    worst_median = worst_largest = 0.0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        wg = want_grads[name].numpy()
        got_g = np.zeros_like(wg) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(wg).max()), 1e-3)
        err = np.abs(got_g - wg) / scale
        worst_median = max(worst_median, float(np.median(err)))
        worst_largest = max(worst_largest, float(err.max()))
    print(f"bf16 step against JAX bf16: metrics {worst_metric}, gradient "
          f"median {worst_median}, largest {worst_largest} (of the "
          f"tensor's largest entry); kinks followed {flips}")
    assert worst_metric <= BF16_STEP["metric"]
    assert worst_median <= BF16_STEP["median"]
    assert worst_largest <= BF16_STEP["largest"]


# ------------------------------------------------- reference=False (C8)


def test_solver_without_reference_evaluates_where_jax_cannot(tmp_path):
    """ROADMAP.md C8: JAX's Solver(reference=False) over a no_reference
    model raises KeyError('cluster_ref') in its first eval epoch
    (get_eval reads cluster_ref, which the model does not build). The
    port's eval epoch skips the grounding evaluation instead; its loss and
    detection scalars, from JAX's initial weights, equal the means of
    JAX's ``make_eval_step(reference=False)`` over the same batches
    (atol 1e-4 / rtol 1e-4, the evaluation forward's tolerance): the
    solver's own jitted eval step, ``make_eval_step(..., reference=False)``.
    """
    import dataclasses

    from vlp3d.data.dataset import BatchIterator as JaxBatchIterator
    from vlp3d.data.synthetic import (
        make_synthetic_dataset as jax_make_synthetic_dataset,
    )
    from vlp3d.train.solver import Solver as JaxSolver
    from vlp3d_torch.data.synthetic import make_synthetic_dataset
    from vlp3d_torch.train.solver import Solver

    flags = {**BASE, "no_reference": True}

    def small(config):
        return dataclasses.replace(config, train=dataclasses.replace(
            config.train, batch_size=2, num_workers=1))

    jconfig, config = small(jax_tiny_config(**flags)), small(
        tiny_config(**flags))
    jval = jax_make_synthetic_dataset(jconfig, n_scenes=2, anns_per_scene=2,
                                      split="val", seed=2)
    jsolver = JaxSolver(jconfig, jval, jval, str(tmp_path / "jax"),
                        reference=False)
    sample = next(iter(JaxBatchIterator(jval, 2)))
    jsolver.init_state({k: v for k, v in sample.items()
                        if not isinstance(v, list)})
    with pytest.raises(KeyError, match="cluster_ref"):
        jsolver.eval_epoch(0)

    params = jax.device_get(jsolver.state.params)
    stats = jax.device_get(jsolver.state.batch_stats)
    eval_step = jsolver._get_steps(0)[2]  # the jitted step that raised
    want = []
    for host in JaxBatchIterator(jval, 2, drop_last=False):
        arrays = {k: v for k, v in host.items() if not isinstance(v, list)}
        want.append(jax.device_get(eval_step(jsolver.state, arrays)[1]))

    val = make_synthetic_dataset(config, n_scenes=2, anns_per_scene=2,
                                 split="val", seed=2)
    solver = Solver(config, val, val, str(tmp_path / "port"),
                    reference=False, device="cpu")
    solver.init_state()
    solver.model.load_state_dict(convert.jax_to_torch_state_dict(
        params, stats), strict=True)
    got = solver.eval_epoch(0)
    solver.close()
    assert len(want) == 1
    assert "iou_rate_0.5" not in got and "ref_loss" not in got
    assert set(want[0]) <= set(got)
    for k in want[0]:
        np.testing.assert_allclose(
            got[k], np.mean([float(w[k]) for w in want]), rtol=1e-4,
            atol=1e-4, err_msg=k)
