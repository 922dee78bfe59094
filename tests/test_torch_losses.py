"""vlp3d_torch losses and loss geometry against the JAX package, on the CPU.

Seeded numpy inputs go through each JAX loss function and its counterpart
in the port. Values and the gradients with respect to the float inputs
agree within atol 1e-5 / rtol 1e-5 (float32 sums in different orders);
integer outputs (assignments, labels) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp3d.config import Config as JConfig
from vlp3d.config import LossConfig as JLossConfig
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.geometry import boxes as jboxes
from vlp3d.geometry.nn_distance import huber_loss as jax_huber_loss
from vlp3d.geometry.nn_distance import nn_distance as jax_nn_distance
from vlp3d.losses import detection as jdet
from vlp3d.losses import grounding as jgr
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d_torch.config import Config, LossConfig
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.geometry import boxes
from vlp3d_torch.geometry.nn_distance import huber_loss, nn_distance
from vlp3d_torch.losses import detection as det
from vlp3d_torch.losses import grounding as gr
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.train.state import batch_to_device

TOL = dict(rtol=1e-5, atol=1e-5)


def both(jfn, tfn, floats, others=(), select=lambda out: out):
    """Run jfn / tfn on (floats..., others...) and compare the selected
    scalar and its gradient with respect to every float input."""
    jf = [jnp.asarray(a) for a in floats]
    jo = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in others]
    want, grads = jax.value_and_grad(
        lambda *f: select(jfn(*f, *jo)), argnums=tuple(range(len(jf))))(*jf)
    tf = [torch.from_numpy(a).requires_grad_(True) for a in floats]
    to = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in others]
    got = select(tfn(*tf, *to))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward()
    for t, g in zip(tf, grads):
        have = np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(have, np.asarray(g), **TOL)


def test_huber_loss():
    x = np.random.default_rng(0).normal(0, 1.5, (40,)).astype(np.float32)
    for delta in (1.0, 0.15):
        both(lambda e: jnp.sum(jax_huber_loss(e, delta)),
             lambda e: huber_loss(e, delta).sum(), [x])


@pytest.mark.parametrize("mode", [{}, {"l1": True},
                                  {"l1smooth": True, "delta": 0.5}])
def test_nn_distance(mode):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 9, 3)).astype(np.float32)
    b = rng.normal(size=(2, 5, 3)).astype(np.float32)
    b[:, 1] = b[:, 0]  # a tie: the lowest index wins
    want = jax_nn_distance(jnp.asarray(a), jnp.asarray(b), **mode)
    got = nn_distance(torch.from_numpy(a), torch.from_numpy(b),
                                  **mode)
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    both(lambda x, y: sum(jnp.sum(o) for o in
                          jax_nn_distance(x, y, **mode)[::2]),
         lambda x, y: sum(o.sum() for o in
                          nn_distance(x, y, **mode)[::2]), [a, b])


def _boxes(rng, shape):
    return (rng.uniform(0, 2, shape + (3,)).astype(np.float32),
            rng.uniform(0.4, 1.5, shape + (3,)).astype(np.float32))


def test_box3d_diou_and_iou_aabb():
    rng = np.random.default_rng(2)
    c1, s1 = _boxes(rng, (2, 1, 6))
    c2, s2 = _boxes(rng, (2, 4, 1))
    for pick in (0, 1):
        both(lambda *a: jnp.sum(jboxes.box3d_diou(*a)[pick]),
             lambda *a: boxes.box3d_diou(*a)[pick].sum(), [c1, s1, c2, s2])
    both(lambda *a: jnp.sum(jboxes.box3d_iou_aabb(*a)),
         lambda *a: boxes.box3d_iou_aabb(*a).sum(), [c1, s1, c2, s2])


def test_vote_loss():
    rng = np.random.default_rng(3)
    b, s, n = 2, 12, 40
    seed_xyz = rng.normal(size=(b, s, 3)).astype(np.float32)
    vote_xyz = (seed_xyz + rng.normal(0, 0.3, (b, s, 3))).astype(np.float32)
    seed_inds = rng.integers(0, n, (b, s)).astype(np.int32)
    vote_label = rng.normal(size=(b, n, 9)).astype(np.float32)
    vote_label[:, ::2] = np.tile(vote_label[:, ::2, :3], (1, 1, 3))  # ties
    mask = rng.integers(0, 2, (b, n)).astype(np.int64)
    both(jdet.compute_vote_loss, det.compute_vote_loss, [seed_xyz, vote_xyz],
         [seed_inds, vote_label, mask])


def _detection_inputs(rng, b=2, k=10, k2=6, num_class=18):
    center_label = np.zeros((b, k2, 3), np.float32)
    center_label[:, :4] = rng.uniform(0, 3, (b, 4, 3))
    agg = rng.uniform(0, 3, (b, k, 3)).astype(np.float32)
    agg[:, :5] = center_label[:, rng.integers(0, 4, 5)] + rng.normal(
        0, 0.1, (b, 5, 3)).astype(np.float32)  # some proposals near a GT
    preds = {
        "aggregated_vote_xyz": agg,
        "objectness_scores": rng.normal(size=(b, k, 2)).astype(np.float32),
        "heading_scores": rng.normal(size=(b, k, 1)).astype(np.float32),
        "heading_residuals_normalized": rng.normal(
            size=(b, k, 1)).astype(np.float32),
        "rois": rng.uniform(0.1, 1.0, (b, k, 6)).astype(np.float32),
        "sem_cls_scores": rng.normal(size=(b, k, num_class)).astype(
            np.float32),
    }
    targets = {
        "center_label": center_label,
        "heading_class_label": np.zeros((b, k2), np.int64),
        "heading_residual_label": np.zeros((b, k2), np.float32),
        "size_class_label": rng.integers(0, num_class, (b, k2)),
        "size_residual_label": rng.normal(0, 0.2, (b, k2, 3)).astype(
            np.float32),
        "sem_cls_label": rng.integers(0, num_class, (b, k2)),
    }
    return preds, targets


def test_objectness_loss():
    rng = np.random.default_rng(4)
    preds, targets = _detection_inputs(rng)
    args = [preds["aggregated_vote_xyz"], preds["objectness_scores"],
            targets["center_label"]]
    want = jdet.compute_objectness_loss(*map(jnp.asarray, args))
    got = det.compute_objectness_loss(*map(torch.from_numpy, args))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[1].sum() < got[1].numel()
    both(lambda *a: jdet.compute_objectness_loss(*a)[0],
         lambda *a: det.compute_objectness_loss(*a)[0], args)


@pytest.mark.parametrize("pick", range(4))
def test_box_and_sem_cls_loss(pick):
    rng = np.random.default_rng(5)
    preds, targets = _detection_inputs(rng)
    mean_size = rng.uniform(0.5, 1.5, (18, 3)).astype(np.float32)
    _, label, _, assign = det.compute_objectness_loss(
        torch.from_numpy(preds["aggregated_vote_xyz"]),
        torch.from_numpy(preds["objectness_scores"]),
        torch.from_numpy(targets["center_label"]))
    keys = ("aggregated_vote_xyz", "heading_scores",
            "heading_residuals_normalized", "rois", "sem_cls_scores")

    def jfn(*f):
        p = dict(zip(keys, f), object_assignment=jnp.asarray(assign.numpy()))
        t = {k: jnp.asarray(v) for k, v in targets.items()}
        return jdet.compute_box_and_sem_cls_loss(
            p, t, jnp.asarray(label.numpy()), 1, jnp.asarray(mean_size))[pick]

    def tfn(*f):
        p = dict(zip(keys, f), object_assignment=assign)
        t = {k: torch.from_numpy(v) for k, v in targets.items()}
        return det.compute_box_and_sem_cls_loss(
            p, t, label, 1, torch.from_numpy(mean_size))[pick]

    both(jfn, tfn, [preds[k] for k in keys])


@pytest.mark.parametrize("name", ["softmax_ranking_loss",
                                  "softmax_ranking_focal_loss",
                                  "sigmoid_ranking_loss",
                                  "sigmoid_ranking_focal_loss"])
def test_ranking_losses(name):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 4, 7)).astype(np.float32)
    t = rng.uniform(0, 1, (3, 4, 7)).astype(np.float32)
    t /= t.sum(-1, keepdims=True)
    mask = rng.integers(0, 2, (3, 4)).astype(np.float32)
    jfn, tfn = getattr(jgr, name), getattr(gr, name)
    if name == "softmax_ranking_loss":
        both(lambda a: jnp.sum(jfn(a, jnp.asarray(t), jnp.asarray(mask))),
             lambda a: tfn(a, torch.from_numpy(t),
                           torch.from_numpy(mask)).sum(), [x])
    elif name == "sigmoid_ranking_loss":
        both(lambda a: jfn(a, jnp.asarray(t)),
             lambda a: tfn(a, torch.from_numpy(t)), [x])
    else:
        m = mask if name.startswith("softmax") else np.broadcast_to(
            mask[..., None], x.shape).copy()
        both(lambda a: jfn(a, jnp.asarray(t), jnp.asarray(m)),
             lambda a: tfn(a, torch.from_numpy(t), torch.from_numpy(m)), [x])
        both(lambda a: jfn(a, jnp.asarray(t)),
             lambda a: tfn(a, torch.from_numpy(t)), [x])


def _diou_inputs(rng, b=3, l=4, k=12):
    gt_center, gt_size = _boxes(rng, (b, l))
    pred_center, pred_size = _boxes(rng, (b, k))
    # proposals on the GT boxes (iou well above 0.25), two of them for
    # sentence 0 so that the smoothing branch runs, and an exact tie
    for li in range(l):
        pred_center[:, li] = gt_center[:, li] + 0.02
        pred_size[:, li] = gt_size[:, li]
    pred_center[:, l] = gt_center[:, 0] - 0.03
    pred_size[:, l] = gt_size[:, 0]
    pred_center[:, l + 1], pred_size[:, l + 1] = pred_center[:, 1], pred_size[:, 1]
    return dict(
        pred_center=pred_center, pred_size=pred_size,
        cluster_ref=rng.normal(size=(b * l, k)).astype(np.float32),
        objectness_masks=rng.integers(0, 2, (b, k)).astype(np.float32),
        gt_center=gt_center, gt_size=gt_size,
        lang_num=np.array([l, 2, 1], np.int32)[:b],
    )


@pytest.mark.parametrize("epoch,istrain,gate", [(0, 1, 0.3), (0, 1, 0.7),
                                                (60, 1, 0.3), (10, 0, 0.3)])
def test_diou_loss(epoch, istrain, gate):
    a = _diou_inputs(np.random.default_rng(7))
    floats = ("pred_center", "pred_size", "cluster_ref")
    scal = dict(epoch=np.int32(epoch), istrain=np.int32(istrain),
                random_gate=np.float32(gate))

    def jfn(*f):
        kw = {k: jnp.asarray(v) for k, v in a.items()}
        kw.update(zip(floats, f))
        return jgr.compute_diou_loss(**kw, **{k: jnp.asarray(v)
                                              for k, v in scal.items()})

    def tfn(*f):
        kw = {k: torch.from_numpy(v) for k, v in a.items()}
        kw.update(zip(floats, f))
        return gr.compute_diou_loss(**kw, **{k: torch.tensor(v)
                                             for k, v in scal.items()})

    want = jfn(*[jnp.asarray(a[k]) for k in floats])
    got = tfn(*[torch.from_numpy(a[k]) for k in floats])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert got["cluster_labels"].sum() > 0
    both(jfn, tfn, [a[k] for k in floats],
         select=lambda o: o["ref_loss"] + o["diou_loss"])


def test_lang_classification_loss():
    rng = np.random.default_rng(8)
    scores = rng.normal(size=(12, 18)).astype(np.float32)
    cat = rng.integers(0, 18, (3, 4))
    lang_num = np.array([4, 2, 0], np.int32)
    both(jgr.compute_lang_classification_loss,
         gr.compute_lang_classification_loss, [scores], [cat, lang_num])


def test_attr_loss():
    rng = np.random.default_rng(9)
    b, s, n = 2, 24, 60
    votes = rng.normal(size=(b, s, 3)).astype(np.float32)
    seed_inds = rng.integers(0, n, (b, s)).astype(np.int32)
    inst = rng.integers(0, 5, (b, n))
    mask = rng.integers(0, 2, (b, n))
    both(lambda v: jgr.compute_attr_loss(v, jnp.asarray(seed_inds),
                                         jnp.asarray(inst), jnp.asarray(mask),
                                         num_instances=8),
         lambda v: gr.compute_attr_loss(v, torch.from_numpy(seed_inds),
                                        torch.from_numpy(inst),
                                        torch.from_numpy(mask),
                                        num_instances=8), [votes])


def test_debug_diagnostics():
    rng = np.random.default_rng(10)
    a = _diou_inputs(rng)
    ious = rng.uniform(0, 1, (3, 4, 12)).astype(np.float32)
    cat = rng.integers(0, 18, (3, 4))
    kw = dict(ious=ious, cluster_ref=a["cluster_ref"], object_cat=cat,
              gt_size=a["gt_size"], lang_num=a["lang_num"])
    want = jgr.compute_debug_diagnostics(**{k: jnp.asarray(v)
                                            for k, v in kw.items()})
    got = gr.compute_debug_diagnostics(**{k: torch.from_numpy(v)
                                          for k, v in kw.items()})
    assert set(got) == set(want) and len(got) == 5 + 2 + 36 + 1
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def _model_outputs(rng, config, batch):
    """A random stand-in for JointNet's outputs, at the config's shapes."""
    b, n = batch["point_clouds"].shape[:2]
    cfg = config.model
    s, k, l = cfg.sa_npoints[1], cfg.num_proposal, cfg.lang_num_max
    seed_inds = np.stack([rng.permutation(n)[:s] for _ in range(b)]).astype(
        np.int32)
    seed_xyz = np.take_along_axis(batch["point_clouds"][..., :3],
                                  seed_inds[..., None], axis=1)
    vote_xyz = seed_xyz + np.take_along_axis(
        batch["vote_label"][..., :3], seed_inds[..., None], axis=1) * 0.8
    preds, _ = _detection_inputs(rng, b=b, k=k)
    agg = vote_xyz[:, :k] + rng.normal(0, 0.05, (b, k, 3))
    out = dict(preds, seed_inds=seed_inds, seed_xyz=seed_xyz,
               vote_xyz=vote_xyz, aggregated_vote_xyz=agg,
               pred_center=agg + rng.normal(0, 0.05, (b, k, 3)),
               pred_size=rng.uniform(0.4, 1.2, (b, k, 3)),
               cluster_ref=rng.normal(size=(b * l, k)),
               objectness_masks=rng.integers(0, 2, (b, k)),
               lang_scores=rng.normal(size=(b * l, 18)),
               lang_con_loss=np.float32(0.37), iou_con_loss=np.float32(1.21))
    return {key: (v if v.dtype.kind == "i" else v.astype(np.float32))
            for key, v in ((k_, np.asarray(v_)) for k_, v_ in out.items())}


@pytest.mark.parametrize("epoch,attr,debug", [(0, False, False),
                                              (60, True, True)])
def test_joint_loss(epoch, attr, debug):
    rng = np.random.default_rng(11)
    flags = dict(use_con=True, no_caption=True)
    jc, tc = jax_tiny_config(**flags), tiny_config(**flags)
    jc = JConfig(dataset=jc.dataset, model=jc.model,
                 loss=JLossConfig(use_attr_loss=attr, debug=debug))
    tc = Config(dataset=tc.dataset, model=tc.model,
                loss=LossConfig(use_attr_loss=attr, debug=debug))
    batch = make_batch(tc, batch_size=3, num_points=256, seed=2, epoch=epoch)
    batch["random"] = np.float32(0.3)
    outs = _model_outputs(rng, tc, batch)
    floats = [k for k, v in outs.items() if v.dtype == np.float32]
    fixed = {k: v for k, v in outs.items() if k not in floats}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = batch_to_device(batch, "cpu")

    def jfn(*f):
        o = {k: jnp.asarray(v) for k, v in fixed.items()}
        o.update(zip(floats, f))
        return jax_joint_loss(jc, o, jbatch)

    def tfn(*f):
        o = {k: torch.from_numpy(v) for k, v in fixed.items()}
        o.update(zip(floats, f))
        return compute_joint_loss(tc, o, tbatch)

    _, want = jfn(*[jnp.asarray(outs[k]) for k in floats])
    _, got = tfn(*[torch.from_numpy(outs[k]) for k in floats])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert float(got["vote_loss"]) > 0 and float(got["ref_loss"]) >= 0
    both(jfn, tfn, [outs[k] for k in floats], select=lambda o: o[0])
