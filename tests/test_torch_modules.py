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
