"""vlp3d_torch modules against their flax counterparts, on the CPU.

Each flax module is initialised from a fixed key, its BatchNorm running
statistics are overwritten with random numpy values (so the conversion of
every statistic is exercised), its tree goes through
``vlp3d_torch.convert``, and the port module loads it with strict=True.
The same seeded numpy inputs then go through both. Float outputs agree
within atol 1e-4 / rtol 1e-4; index outputs are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp3d.models.backbone import PointNet2Backbone as JBackbone
from vlp3d.models.bert import BertConfig as JBertConfig
from vlp3d.models.bert import LangModule as JLang
from vlp3d.models.layers import FPModule as JFP
from vlp3d.models.layers import SAModule as JSA
from vlp3d.models.match import MatchModule as JMatch
from vlp3d.models.proposal import ProposalModule as JProposal
from vlp3d.models.relation import RelationModule as JRelation
from vlp3d.models.voting import VotingModule as JVoting
from vlp3d_torch import convert
from vlp3d_torch.models.backbone import PointNet2Backbone
from vlp3d_torch.models.bert import BertConfig, LangModule
from vlp3d_torch.models.layers import FPModule, SAModule
from vlp3d_torch.models.match import MatchModule
from vlp3d_torch.models.proposal import ProposalModule
from vlp3d_torch.models.relation import RelationModule
from vlp3d_torch.models.voting import VotingModule, l2_normalize

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomize_stats(stats, seed=1):
    rng = np.random.default_rng(seed)

    def one(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, stats)


def flax_run(module, *args, **kwargs):
    """Init (fixed key, random BN stats) and apply a flax module at eval."""
    jargs = [jnp.asarray(a) for a in args]
    v = jax.jit(lambda *a: module.init(jax.random.key(0), *a, **kwargs))(
        *jargs)
    v = {"params": jax.device_get(v["params"]),
         "batch_stats": randomize_stats(jax.device_get(
             v.get("batch_stats", {})))}
    out = jax.jit(lambda vv, *a: module.apply(vv, *a, **kwargs))(v, *jargs)
    return v["params"], v["batch_stats"], jax.device_get(out)


def port(module, convert_fn, *tree):
    sd = {}
    convert_fn(*tree, "", sd)
    module.load_state_dict(convert.to_tensors(sd), strict=True)
    return module.eval()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_sa_module():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 2, (2, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 128, 5)).astype(np.float32)
    p, s, (jxyz, jf, jinds) = flax_run(JSA(32, 0.4, 8, [16, 16, 32]), xyz,
                                       feats)
    m = port(SAModule(32, 0.4, 8, [16, 16, 32], 5, device="cpu"),
             convert.convert_sa, p, s)
    new_xyz, f, inds = m(t(xyz), t(feats))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))
    close(new_xyz, jxyz)
    close(f, jf)


def test_fp_module():
    rng = np.random.default_rng(1)
    unknown = rng.normal(size=(2, 40, 3)).astype(np.float32)
    known = rng.normal(size=(2, 16, 3)).astype(np.float32)
    uf = rng.normal(size=(2, 40, 8)).astype(np.float32)
    kf = rng.normal(size=(2, 16, 12)).astype(np.float32)
    p, s, want = flax_run(JFP([32, 32]), unknown, known, uf, kf)
    m = port(FPModule([32, 32], 20, device="cpu"), convert.convert_fp, p, s)
    close(m(t(unknown), t(known), t(uf), t(kf)), want)


def test_backbone():
    rng = np.random.default_rng(2)
    pc = rng.uniform(0, 3, (2, 256, 7)).astype(np.float32)
    pc[:, -10:, :3] = 0.0  # zero padding, never sampled
    geo = dict(npoints=(64, 32, 16, 8), radii=(0.4, 0.8, 1.2, 1.6),
               nsamples=(8, 8, 4, 4))
    p, s, want = flax_run(JBackbone(input_feature_dim=4, **geo), pc)
    m = port(PointNet2Backbone(4, device="cpu", **geo),
             convert.convert_backbone, p, s)
    got = m(t(pc))
    assert set(got) == set(want)
    for k in ("sa1_inds", "sa2_inds", "fp2_inds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("sa4_features", "fp2_features", "fp2_xyz"):
        close(got[k], want[k])


def test_voting_module():
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(2, 32, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 32, 256)).astype(np.float32)
    p, s, (jxyz, jf) = flax_run(JVoting(1, 256), xyz, feats)
    m = port(VotingModule(1, 256, device="cpu"), convert.convert_voting, p, s)
    vxyz, vf = m(t(xyz), t(feats))
    close(vxyz, jxyz)
    close(vf, jf)
    norm = np.linalg.norm(np.asarray(jf), axis=-1, keepdims=True)
    close(l2_normalize(vf), np.asarray(jf) / np.maximum(norm, 1e-12))


def test_proposal_module():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(0, 3, (2, 64, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 64, 256)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    p, s, want = flax_run(JProposal(num_proposal=16), xyz, feats)
    m = port(ProposalModule(num_proposal=16, device="cpu"),
             convert.convert_proposal, p, s)
    got = m(t(xyz), t(feats))
    np.testing.assert_array_equal(got["aggregated_vote_inds"].numpy(),
                                  np.asarray(want["aggregated_vote_inds"]))
    np.testing.assert_array_equal(got["objectness_masks"].numpy(),
                                  np.asarray(want["objectness_masks"]))
    for k in ("objectness_scores", "rois", "sem_cls_scores", "pred_center",
              "pred_size", "pred_heading", "aggregated_vote_features"):
        close(got[k], want[k])


def test_relation_module():
    rng = np.random.default_rng(5)
    b, k = 2, 16
    args = (
        rng.normal(size=(b, k, 128)).astype(np.float32),
        rng.uniform(0, 3, (b, k, 3)).astype(np.float32),
        rng.uniform(0.2, 1.0, (b, k, 3)).astype(np.float32),
        rng.uniform(-1, 1, (b, k)).astype(np.float32),
        rng.normal(size=(b, 64, 7)).astype(np.float32),
        rng.integers(0, 64, (b, 32)).astype(np.int32),
        rng.integers(0, 32, (b, k)).astype(np.int32),
    )
    p, s, want = flax_run(
        JRelation(num_proposals=k, multiview_offset=3, multiview_dim=4),
        *args)
    m = port(RelationModule(multiview_offset=3, multiview_dim=4,
                            device="cpu"),
             convert.convert_relation, p, s)
    got = m(*map(t, args))
    for key in ("bbox_feature", "dist_weights", "relation_attn"):
        close(got[key], want[key])


SMALL_BERT = dict(vocab_size=200, hidden_size=32, num_attention_heads=4,
                  intermediate_size=64, max_position_embeddings=32,
                  fusion_layer=2)


def _tokens(rng, b, l, tlen):
    ids = rng.integers(1, 200, (b, l, tlen)).astype(np.int32)
    ids[..., 0] = 101 % 200
    for bi in range(b):
        for li in range(l):
            ids[bi, li, rng.integers(3, tlen):] = 0
    return ids, (ids != 0).astype(np.int32)


def test_lang_module():
    rng = np.random.default_rng(6)
    ids, mask = _tokens(rng, 2, 3, 10)
    jm = JLang(bert_config=JBertConfig(**SMALL_BERT))
    p, _, want = flax_run(jm, ids, mask)
    m = LangModule(bert_config=BertConfig(**SMALL_BERT), device="cpu")
    sd = {}
    convert.convert_lang(p, "", sd)
    m.load_state_dict(convert.to_tensors(sd), strict=True)
    got = m.eval()(t(ids), t(mask))
    for key in ("lang_fea", "lang_emb", "lang_scores"):
        close(got[key], want[key])


def test_match_module():
    rng = np.random.default_rng(7)
    b, l, k = 2, 3, 16
    bbox = rng.normal(size=(b, k, 128)).astype(np.float32)
    lang_fea = rng.normal(size=(b * l, 10, 128)).astype(np.float32)
    lang_emb = lang_fea[:, 0]
    masks = rng.integers(0, 2, (b, k)).astype(np.float32)
    jm = JMatch(num_proposals=k)
    jargs = [jnp.asarray(a) for a in (bbox, lang_fea, lang_emb, masks)]
    v = jax.jit(lambda *a: jm.init(jax.random.key(0), *a, lang_num_max=l))(
        *jargs)
    want = jax.jit(lambda vv, *a: jm.apply(vv, *a, lang_num_max=l))(
        v, *jargs)
    m = MatchModule(device="cpu")
    sd = {}
    convert.convert_match(jax.device_get(v["params"]), "", sd)
    m.load_state_dict(convert.to_tensors(sd), strict=True)
    got = m.eval()(t(bbox), t(lang_fea), lang_num_max=l)
    close(got["cluster_ref"], want["cluster_ref"])
    close(got["cross_box_feature"], want["cross_box_feature"])


# ------------------------------------------------------------ training mode
#
# Training-mode parity: batch-statistic BatchNorm with its running updates,
# the SA raw-row branch, copy-paste, the contrast head, and gradients. The
# two frameworks' random generators cannot agree, so dropout is switched
# off on both sides here (flax's Dropout patched to the identity, the
# port's probabilities set to 0) and tested on its own below. Gradients
# agree within atol 1e-5 / rtol 1e-4.

import flax.linen as fnn

from vlp3d.models.contrast import ContrastModule as JContrast
from vlp3d.models.match import copy_paste_features as jax_copy_paste
from vlp3d_torch.models.contrast import ContrastModule
from vlp3d_torch.models.layers import BatchNorm, Dropout
from vlp3d_torch.models.match import copy_paste_features

GTOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)


def zero_dropout(module):
    for m in module.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return module


def flax_train(module, args, cot_fn, n_float, **kwargs):
    """Init with random BN stats, apply with train-mode BN, and
    differentiate sum(cot_fn(out)) with respect to the params and the
    first ``n_float`` args. Returns (params, stats, out, new_stats,
    param_grads, arg_grads)."""
    jargs = [jnp.asarray(a) for a in args]
    v = jax.jit(lambda *a: module.init(jax.random.key(0), *a, **kwargs))(
        *jargs)
    params = jax.device_get(v["params"])
    stats = randomize_stats(jax.device_get(v.get("batch_stats", {})))

    def loss(p, *fl):
        out, upd = module.apply({"params": p, "batch_stats": stats}, *fl,
                                *jargs[n_float:], mutable=["batch_stats"],
                                **kwargs)
        return cot_fn(out), (out, upd.get("batch_stats", {}))

    (_, (out, new_stats)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(n_float + 1)), has_aux=True)(
            params, *jargs[:n_float])
    return (params, stats, jax.device_get(out), jax.device_get(new_stats),
            jax.device_get(grads[0]), jax.device_get(grads[1:]))


def grads_close(module, convert_fn, jgrads, jstats):
    """Every parameter's gradient against the converted JAX gradient tree:
    rtol 1e-4, atol 1e-5 of the tensor's largest entry (float32 sums over
    thousands of rows, in different orders)."""
    want = {}
    convert_fn(*( (jgrads, jstats) if jstats is not None else (jgrads,)),
               "", want)
    checked = 0
    for name, p in module.named_parameters():
        if not p.requires_grad:
            continue
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(got, want[name], err_msg=name, rtol=1e-4,
                                   atol=1e-5 * scale)
        checked += 1
    assert checked


def stats_close(module, convert_fn, jparams, jnew_stats):
    want = {}
    convert_fn(jparams, jnew_stats, "", want)
    checked = 0
    for name, buf in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name], err_msg=name,
                                       **TOL)
            checked += 1
    assert checked


def test_batchnorm_train_matches_flax():
    rng = np.random.default_rng(20)
    x = (rng.normal(size=(4, 10, 6)) * 3 + 5).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    p = {"scale": jnp.asarray(rng.normal(1, 0.1, 6), jnp.float32),
         "bias": jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32)}
    s = randomize_stats(jax.device_get(v["batch_stats"]))

    def loss(pp, xx):
        y, upd = jm.apply({"params": pp, "batch_stats": s}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (want, new)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    m = BatchNorm(6, device="cpu")
    sd = {}
    convert.bn(p, s, "m", sd)
    m.load_state_dict({k[2:]: v_ for k, v_ in convert.to_tensors(sd).items()})
    m.train()
    tx = t(x).requires_grad_(True)
    got = m(tx)
    close(got, want)
    got.backward(t(cot))
    # flax keeps the BIASED batch variance in the running average
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(new["mean"]),
                               **TOL)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(new["var"]),
                               **TOL)
    biased = x.reshape(-1, 6).var(axis=0)
    np.testing.assert_allclose(m.running_var.numpy(),
                               0.9 * np.asarray(s["var"]) + 0.1 * biased,
                               rtol=1e-4, atol=1e-5)
    assert int(m.num_batches_tracked) == 1
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GTOL)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(gp["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(gp["bias"]),
                               rtol=1e-4, atol=1e-4)
    # evaluation reads the running statistics and leaves them alone
    m.eval()
    before = m.running_mean.clone()
    m(t(x))
    assert torch.equal(m.running_mean, before)


@pytest.mark.parametrize("leaf_inputs", [True, False])
def test_sa_module_train(leaf_inputs):
    rng = np.random.default_rng(21)
    xyz = rng.uniform(0, 2, (2, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 128, 5)).astype(np.float32)
    n_float = 0 if leaf_inputs else 2  # leaf inputs take no gradient
    p, s, (jxyz, jf, jinds), new, gp, gargs = flax_train(
        JSA(32, 0.3, 8, [16, 16, 32], leaf_inputs=leaf_inputs), (xyz, feats),
        lambda out: jnp.sum(out[1] ** 2) + jnp.sum(out[0]), n_float,
        train=True)
    m = port(SAModule(32, 0.3, 8, [16, 16, 32], 5, leaf_inputs=leaf_inputs,
                      device="cpu"), convert.convert_sa, p, s).train()
    txyz, tf = t(xyz), t(feats)
    if not leaf_inputs:
        txyz.requires_grad_(True)
        tf.requires_grad_(True)
    new_xyz, f, inds = m(txyz, tf)
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))
    close(new_xyz, jxyz)
    close(f, jf)
    ((f ** 2).sum() + new_xyz.sum()).backward()
    grads_close(m, convert.convert_sa, gp, s)
    stats_close(m, convert.convert_sa, p, new)
    if not leaf_inputs:
        for have, want in ((txyz.grad, gargs[0]), (tf.grad, gargs[1])):
            want = np.asarray(want)
            np.testing.assert_allclose(
                have.numpy(), want, rtol=1e-4,
                atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_max_pool_gradient_splits_among_ties_as_jax():
    x = np.array([[[1.0, 3.0], [1.0, 3.0], [0.5, 3.0], [1.0, -1.0]]],
                 np.float32)  # (1, 4, 2): 3-way and 3-way ties over axis 1
    want = jax.grad(lambda a: jnp.sum(jnp.max(a, axis=1) * jnp.array(
        [2.0, 6.0])))(jnp.asarray(x))
    tx = t(x).requires_grad_(True)
    (tx.amax(dim=1) * torch.tensor([2.0, 6.0])).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-6)
    assert tx.grad[0, 0, 0] == pytest.approx(2.0 / 3)


@pytest.mark.parametrize("case", ["mixed", "none", "all", "one_scene_full"])
def test_copy_paste_features_is_exact(case):
    rng = np.random.default_rng(22)
    b, k, h = 3, 10, 4
    feats = rng.normal(size=(b, k, h)).astype(np.float32)
    mask = {
        "mixed": rng.integers(0, 2, (b, k)).astype(bool),
        "none": np.zeros((b, k), bool),
        "all": np.ones((b, k), bool),
        "one_scene_full": np.stack([np.ones(k, bool), np.zeros(k, bool),
                                    np.arange(k) % 3 == 0]),
    }[case]
    want = np.asarray(jax_copy_paste(jnp.asarray(feats), jnp.asarray(mask)))
    got = copy_paste_features(t(feats), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gate", [0.3, 0.7])
def test_match_module_train(no_flax_dropout, gate):
    rng = np.random.default_rng(23)
    b, l, k = 2, 3, 16
    bbox = rng.normal(size=(b, k, 128)).astype(np.float32)
    lang_fea = rng.normal(size=(b * l, 10, 128)).astype(np.float32)
    masks = rng.integers(0, 2, (b, k)).astype(np.float32)
    p, _, want, _, gp, gargs = flax_train(
        JMatch(num_proposals=k), (bbox, lang_fea, lang_fea[:, 0], masks),
        lambda out: jnp.sum(out["cluster_ref"] ** 2), 2, lang_num_max=l,
        train=True, random_gate=jnp.float32(gate))
    m = zero_dropout(MatchModule(device="cpu"))
    sd = {}
    convert.convert_match(p, "", sd)
    m.load_state_dict(convert.to_tensors(sd), strict=True)
    m.train()
    tb, tl = t(bbox).requires_grad_(True), t(lang_fea).requires_grad_(True)
    got = m(tb, tl, t(masks), lang_num_max=l, random_gate=np.float32(gate))
    close(got["cluster_ref"], want["cluster_ref"])
    (got["cluster_ref"] ** 2).sum().backward()
    grads_close(m, convert.convert_match, gp, None)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gargs[0]), **GTOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(gargs[1]), **GTOL)
    if gate < 0.5:  # copy-paste ran: evaluation mode gives another answer
        m.eval()
        plain = m(t(bbox), t(lang_fea), t(masks), lang_num_max=l,
                  random_gate=np.float32(gate))
        assert not torch.allclose(plain["cluster_ref"], got["cluster_ref"],
                                  atol=1e-3)


def _contrast_inputs(rng, b=2, l=3, k=12, h=128):
    gt_center = rng.uniform(0, 3, (b, l, 3)).astype(np.float32)
    gt_size = rng.uniform(0.5, 1.2, (b, l, 3)).astype(np.float32)
    pred_center = rng.uniform(0, 3, (b, k, 3)).astype(np.float32)
    pred_size = rng.uniform(0.5, 1.2, (b, k, 3)).astype(np.float32)
    for li in range(l):  # two proposals on every GT box
        for j in (0, 1):
            pred_center[:, 2 * li + j] = gt_center[:, li] + 0.03 * (j + 1)
            pred_size[:, 2 * li + j] = gt_size[:, li]
    masks = np.ones((b, k), np.float32)
    masks[:, -3:] = 0.0
    masks[:, 1] = 0.0  # a positive that objectness rejects
    return [rng.normal(size=(b, k, h)).astype(np.float32),
            rng.normal(size=(b * l, h)).astype(np.float32),
            pred_center, pred_size, gt_center, gt_size, masks,
            np.array([3, 2], np.int32)[:b]]


def _port_contrast(p):
    m = ContrastModule(device="cpu")
    sd = {}
    convert.convert_contrast(p, "", sd)
    m.load_state_dict(convert.to_tensors(sd), strict=True)
    return m


@pytest.mark.parametrize("epoch", [0, 60])
def test_contrast_module(epoch):
    args = _contrast_inputs(np.random.default_rng(24)) + [np.int32(epoch)]
    p, _, want, _, gp, gargs = flax_train(
        JContrast(), args,
        lambda out: out["lang_con_loss"] + 2.0 * out["iou_con_loss"], 4)
    m = _port_contrast(p)
    targs = [torch.as_tensor(a) for a in args]
    for a in targs[:4]:
        a.requires_grad_(True)
    got = m(*targs)
    for key in ("lang_con_loss", "iou_con_loss"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-5, atol=1e-5)
        assert (float(got[key]) > 0) == (epoch >= 50)
    (got["lang_con_loss"] + 2.0 * got["iou_con_loss"]).backward()
    grads_close(m, convert.convert_contrast, gp, None)
    for a, g in zip(targs[:2], gargs[:2]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GTOL)
    # the boxes are detached: no gradient reaches them
    assert targs[2].grad is None and targs[3].grad is None
    assert not np.asarray(gargs[2]).any() and not np.asarray(gargs[3]).any()


def test_contrast_module_masks_each_scene_with_its_own_objectness():
    """The OSC logits of scene b are masked with scene b's objectness. (The
    JAX module broadcasts the (B, 1, K) column mask against (B, 1, K, K)
    logits, which lines the mask's batch axis up with the singleton one,
    and then reads row 0: every scene gets scene 0's mask, and a positive
    proposal that scene 0 rejects contributes 1e9. With one scene a call,
    or one mask for all scenes, the two agree.) So the port on a batch of
    scenes with different masks must equal the mean of the JAX module over
    the scenes taken one at a time."""
    rng = np.random.default_rng(27)
    args = _contrast_inputs(rng)
    args[6][0, 2] = 0.0  # scene 0 rejects a positive that scene 1 keeps
    args[6][1, -3:] = 1.0
    jm = JContrast()
    jargs = [jnp.asarray(a) for a in args] + [jnp.int32(60)]
    v = jm.init(jax.random.key(0), *jargs)
    m = _port_contrast(jax.device_get(v["params"]))
    got = m(*[torch.as_tensor(a) for a in args], torch.tensor(60))
    l = args[4].shape[1]
    per_scene = []
    for bi in range(2):
        one = [a[bi * l:(bi + 1) * l] if i == 1 else a[bi:bi + 1]
               for i, a in enumerate(jargs[:-1])]
        per_scene.append(jm.apply(v, *one, jnp.int32(60)))
    for key in ("lang_con_loss", "iou_con_loss"):
        want = np.mean([float(o[key]) for o in per_scene])
        np.testing.assert_allclose(float(got[key]), want, rtol=1e-5)
        assert 0 < float(got[key]) < 10
    batched = jm.apply(v, *jargs)
    assert float(batched["iou_con_loss"]) > 1e6  # the reference's fault


def test_lang_module_train_freezes_the_encoder(no_flax_dropout):
    rng = np.random.default_rng(25)
    ids, mask = _tokens(rng, 2, 3, 10)
    jm = JLang(bert_config=JBertConfig(**SMALL_BERT))
    p, _, want, _, gp, _ = flax_train(
        jm, (ids, mask), lambda out: jnp.sum(out["lang_scores"] ** 2)
        + jnp.sum(out["lang_fea"] ** 2), 0, train=True)
    m = zero_dropout(LangModule(bert_config=BertConfig(**SMALL_BERT),
                                device="cpu"))
    sd = {}
    convert.convert_lang(p, "", sd)
    m.load_state_dict(convert.to_tensors(sd), strict=True)
    m.train()
    got = m(t(ids), t(mask))
    close(got["lang_scores"], want["lang_scores"])
    ((got["lang_scores"] ** 2).sum() + (got["lang_fea"] ** 2).sum()).backward()
    frozen = [n for n, q in m.named_parameters() if not q.requires_grad]
    assert frozen and all(n.startswith("text_encoder.") for n in frozen)
    assert all(q.grad is None for n, q in m.named_parameters()
               if n.startswith("text_encoder."))
    assert not any(np.asarray(g).any() for g in jax.tree_util.tree_leaves(
        gp["text_encoder"]))
    for name in ("proj", "lang_cls.0"):
        mod = m.get_submodule(name)
        jp = gp["proj" if name == "proj" else "lang_cls"]
        np.testing.assert_allclose(mod.weight.grad.numpy(),
                                   np.asarray(jp["kernel"]).T, rtol=1e-4,
                                   atol=1e-4)


def test_dropout_rate_scaling_and_generator():
    d = Dropout(0.5)
    x = torch.ones(200, 200)
    d.train()
    d.generator = torch.Generator().manual_seed(3)
    y = d(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.02
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 2.0))
    d.generator = torch.Generator().manual_seed(3)
    assert torch.equal(d(x), y)  # the mask is the generator's
    assert not torch.equal(d(x), y)
    d.eval()
    assert d(x) is x
    d.train()
    d.p = 0.0
    assert d(x) is x


def test_lang_module_train_draws_dropout_in_the_frozen_encoder():
    rng = np.random.default_rng(26)
    ids, mask = _tokens(rng, 2, 3, 10)
    m = LangModule(bert_config=BertConfig(**SMALL_BERT), device="cpu")
    from vlp3d_torch.models.layers import set_dropout_generator
    set_dropout_generator(m, torch.Generator().manual_seed(0))
    m.eval()
    ref = m(t(ids), t(mask))["lang_fea"]
    m.train()
    noisy = m(t(ids), t(mask))["lang_fea"]
    assert not torch.allclose(ref, noisy, atol=1e-4)
