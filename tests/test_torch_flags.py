"""The grounding model's options in vlp3d_torch against the JAX package,
on the CPU: each module that an option changes, and the whole JointNet.

Seeded numpy weights fill the flax modules' shapes (``jax.eval_shape``,
no init compile; every PReLU slope distinct, 0.25 + N(0, 0.1)), go
through ``vlp3d_torch.convert`` into the port's modules (strict loads),
and the same seeded inputs go through both, in evaluation and in
training mode, with dropout off on both sides (the generators cannot
agree; tests/test_torch_modules.py holds dropout). Stated tolerances:

  * each module (the vote-weight predictor and the KL head inside the
    proposal module, the lang-emb scorer and the regression head inside
    the match module, DistilBERT and the language module without a
    classifier): the options' outputs atol 1e-5 / rtol 1e-5, BatchNorm
    statistics after a training forward atol 1e-5 / rtol 1e-4, indices
    equal; the module's other outputs at tests/test_torch_modules.py's
    atol 1e-4 / rtol 1e-4 (in training, the vote aggregation's batch
    statistics over 64 votes carry float32 rounding to 3e-5);
  * ``mask_boxes``: JAX's three draws, injected into the port's, give
    JAX's boxes bit for bit; the port's own draws mask 0.3 of 2^14
    boxes within 4 sigma;
  * ``reference_obj_gather``: the rows the object embedding reads equal
    JAX's bit for bit (a pure gather), the module's output within 1e-5;
  * the bfloat16 backbone (``compute_dtype="bfloat16"``) against JAX's
    bfloat16 backbone over 3 seeds, evaluation and training: indices
    equal; each feature's largest and mean error, of its largest entry,
    within BF16_BOUNDS (4x the largest measured over these seeds, see
    CHANGES.md). In evaluation the two are equal in nearly every entry
    (the matmuls round alike; a last-bit difference moves one bfloat16
    unit, 0.4%); in training the batch variance E[x^2] - E[x]^2 carries
    the two packages' summation orders into every normalised value, and
    whole bfloat16 units move. The gap to the port's own float32 forward
    is reported; in evaluation it must exceed the mean bound;
  * the whole JointNet (every option at once with injected box masks,
    and ``no_reference``; each option alone is
    tests/test_torch_jointnet.py's): indices equal; in evaluation floats
    within atol 1e-4 / rtol 1e-4 (tests/test_torch_jointnet.py's); in
    training, with the port following JAX's side of 0 at every ReLU /
    PReLU input, each float tensor within TRAIN_MAX of its largest entry
    and its median error within TRAIN_MEDIAN of it (measured: 2.3e-4 and
    2.4e-5; batch statistics over 2 scenes carry float32 rounding into
    every layer after them).

The reference layout declares one PReLU slope where JAX keeps one a
channel: ``export_jointnet_state_dict`` writes their mean, and the port
loads that (1,) weight strictly, on every channel.
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlp3d.models.proposal as jax_proposal_mod
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.models.backbone import PointNet2Backbone as JaxBackbone
from vlp3d.models.bert import LangModule as JaxLang
from vlp3d.models.bert import distilbert_config as jax_distilbert_config
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.models.match import MatchModule as JaxMatch
from vlp3d.models.proposal import ProposalModule as JaxProposal
from vlp3d.models.proposal import mask_boxes as jax_mask_boxes
from vlp3d.models.relation import RelationModule as JaxRelation
from vlp3d.models.torch_export import export_jointnet_state_dict
from vlp3d_torch import convert
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.models import proposal as port_proposal_mod
from vlp3d_torch.models.backbone import PointNet2Backbone
from vlp3d_torch.models.bert import LangModule, distilbert_config
from vlp3d_torch.models.layers import Dropout, PReLU
from vlp3d_torch.models.match import MatchModule
from vlp3d_torch.models.proposal import MASK_RATE, ProposalModule, mask_boxes
from vlp3d_torch.models.relation import RelationModule

from test_torch_train_qa import (  # noqa: I001 (a test module's helpers)
    FLIP_TOL,
    _follow_jax_kinks,
    _kink_input,
    _kink_names,
)

BASE = dict(use_con=False, no_caption=True)
# every option of the grounding model that the port gained with them
OPTIONS = dict(use_distil=True, use_lang_emb=True, use_reg_head=True,
               use_vote_weight=True, mask_box=True, reference_obj_gather=True,
               use_kl_loss=True, use_lang_classifier=False)
BATCH = 2
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
OTHER_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_modules.py's
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_MAX, TRAIN_MEDIAN = 1e-3, 1e-4
# bfloat16 backbone against JAX's, of each feature's largest entry: (the
# largest error, the mean error), 4x the largest measured over the seeds
# of test_bf16_backbone_matches_jax_bf16, by mode (CHANGES.md)
BF16_BOUNDS = {False: (4 * 7.9e-3, 4 * 2.4e-5), True: (4 * 2.93e-2, 4 * 1.8e-3)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def no_jax_dropout():
    """flax's Dropout as the identity while a JAX function is traced."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)
    try:
        yield
    finally:
        mp.undo()


def no_port_dropout(module):
    for m in module.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return module


def seeded(shapes, seed: int):
    """(params, batch_stats) of numpy arrays in the shapes of a flax
    init: fan-in-scaled kernels, small biases, unit-ish scales, distinct
    PReLU slopes, random BatchNorm statistics."""
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

    return (jax.tree_util.tree_map_with_path(param, shapes["params"]),
            jax.tree_util.tree_map_with_path(stat,
                                             shapes.get("batch_stats", {})))


def jax_apply(module, params, stats, *args, train: bool, kinks=False,
              **kw):
    """module.apply under jit with dropout off -> (outputs, new
    batch_stats or None), as numpy; with ``kinks`` (training) also the
    output of every module a ReLU or PReLU reads
    (tests/test_torch_train_qa.py's ``_kink_input``)."""
    variables = {"params": params, "batch_stats": stats}

    def run(v, *a):
        if train:
            out, upd = module.apply(
                v, *a, train=True, rngs={"dropout": jax.random.key(0),
                                         "aug": jax.random.key(1)},
                mutable=["batch_stats"] + (["intermediates"] if kinks
                                           else []),
                capture_intermediates=_kink_input if kinks else False, **kw)
            return (out, upd["batch_stats"]) + (
                (upd["intermediates"],) if kinks else ())
        return module.apply(v, *a, train=False, **kw), None

    with no_jax_dropout():
        return jax.device_get(jax.jit(run)(variables, *args))


def port_module(module, convert_fn, params, stats):
    sd = {}
    convert_fn(params, stats, "", sd)
    module.load_state_dict(convert.to_tensors(sd), strict=True)
    return no_port_dropout(module)


def assert_outputs(got: dict, want: dict, tol: dict, keys=None):
    """Every key of ``want`` (or ``keys``): integers equal, floats within
    ``tol``."""
    for k in keys or want:
        w = np.asarray(want[k])
        g = got[k].detach().float().numpy() if torch.is_tensor(got[k]) \
            else np.asarray(got[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


def assert_stats(module, new_stats, convert_fn, params):
    """The port module's BatchNorm statistics after its training forward
    equal JAX's updated batch_stats."""
    sd = {}
    convert_fn(params, new_stats, "", sd)
    n = 0
    for name, buf in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), sd[name], err_msg=name,
                                       **STAT_TOL)
            n += 1
    assert n > 0


# ------------------------------------------------------------ the modules


def _votes(seed, b=BATCH, v=32, c=256):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 3, (b, v, 3)).astype(np.float32)
    f = rng.normal(size=(b, v, c)).astype(np.float32)
    return xyz, f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("vote_weight,kl", [(True, True), (True, False),
                                            (False, True)])
def test_proposal_options_match_jax(vote_weight, kl, train):
    """The vote-weight predictor (conv, BN, per-channel PReLU, conv,
    sigmoid; the aggregation groups the weighted features) and the KL
    head's alpha (sigmoid * 0.1 - 0.05). In training only these and the
    statistics are held: the vote aggregation's own training forward is
    tests/test_torch_modules.py's (a ReLU within rounding of 0 behind a
    batch-statistics BatchNorm moves its channel; the whole model's
    training forward below follows JAX's side of 0)."""
    xyz, feats = _votes(3)
    jmod = JaxProposal(num_proposal=16, use_vote_weight=vote_weight,
                       use_kl_loss=kl)
    shapes = jax.eval_shape(lambda a, b: jmod.init(
        {"params": jax.random.key(0)}, a, b), xyz, feats)
    params, stats = seeded(shapes, 4)
    want, new = jax_apply(jmod, params, stats, xyz, feats, train=train)
    port = port_module(ProposalModule(18, 1, 16, use_vote_weight=vote_weight,
                                      use_kl_loss=kl, device="cpu"),
                       convert.convert_proposal, params, stats)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert set(got) == set(want)
    assert ("vote_weights" in got) == vote_weight and ("alpha" in got) == kl
    if not train:
        assert_outputs(got, want, OTHER_TOL)
    assert_outputs(got, want, MODULE_TOL, keys=[
        k for k in ("vote_weights", "alpha") if k in want])
    if kl:
        assert float(got["alpha"].abs().max()) <= 0.05
    if train:
        assert_stats(port, new, convert.convert_proposal, params)


def _jax_draws(rng_key, shape):
    """The three arrays JAX's mask_boxes draws from its key."""
    k1, k2, k3 = jax.random.split(rng_key, 3)
    return (np.array(jax.random.bernoulli(k1, 0.3, shape[:2])[..., None]),
            np.array(jax.random.normal(k2, shape) / 2.0),
            np.array(1.0 + jax.random.normal(k3, shape)))


def test_mask_boxes_with_jax_draws_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    center = rng.normal(size=(3, 40, 3)).astype(np.float32)
    size = rng.uniform(0.2, 2, (3, 40, 3)).astype(np.float32)
    key = jax.random.key(7)
    want = jax.device_get(jax_mask_boxes(key, center, size))
    draws = _jax_draws(key, center.shape)
    assert 0 < draws[0].sum() < draws[0].size
    monkeypatch.setattr(port_proposal_mod, "box_mask_draws",
                        lambda b, k, gen, dev: tuple(
                            torch.from_numpy(d) for d in draws))
    got = mask_boxes(torch.from_numpy(center), torch.from_numpy(size))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mask_boxes_draws_follow_the_distribution():
    """0.3 of the boxes masked, within 4 sigma over 2^14 boxes; masked
    centres N(0, 1/4), sizes N(1, 1); unmasked boxes unchanged; the
    generator decides."""
    b, k = 64, 256
    center = torch.full((b, k, 3), 7.0)
    size = torch.full((b, k, 3), 9.0)
    gen = torch.Generator().manual_seed(0)
    c, s = mask_boxes(center, size, gen)
    masked = (c != 7.0).all(-1)
    assert torch.equal(masked, (s != 9.0).all(-1))
    assert ((c == 7.0).all(-1) | masked).all()
    n = b * k
    sigma = (MASK_RATE * (1 - MASK_RATE) / n) ** 0.5
    assert abs(float(masked.float().mean()) - MASK_RATE) < 4 * sigma
    mc, ms = c[masked], s[masked]
    assert abs(float(mc.mean())) < 0.03 and abs(float(mc.std()) - 0.5) < 0.03
    assert abs(float(ms.mean()) - 1) < 0.05 and abs(float(ms.std()) - 1) < 0.05
    again = mask_boxes(center, size, torch.Generator().manual_seed(0))
    assert torch.equal(again[0], c) and torch.equal(again[1], s)


@pytest.mark.parametrize("train", [False, True])
def test_reference_obj_gather_matches_jax(train):
    """The reference's scrambled multiview read: the rows the object
    embedding reads are JAX's bit for bit, the module's output within
    1e-5. Index ranges that reach past batch row 0's block are in play
    (B = 3, so the offsets are 0, C and 2C)."""
    rng = np.random.default_rng(6)
    b, k, n, c, s = 3, 16, 96, 8, 40
    point_clouds = rng.normal(size=(b, n, 3 + c)).astype(np.float32)
    args = (rng.normal(size=(b, k, 128)).astype(np.float32),
            rng.uniform(0, 3, (b, k, 3)).astype(np.float32),
            rng.uniform(0.2, 1, (b, k, 3)).astype(np.float32),
            rng.uniform(-3, 3, (b, k)).astype(np.float32),
            point_clouds,
            rng.integers(0, n, (b, s)).astype(np.int32),
            rng.integers(0, s, (b, k)).astype(np.int32))
    jmod = JaxRelation(num_proposals=k, multiview_offset=3, multiview_dim=c,
                       reference_obj_gather=True)
    shapes = jax.eval_shape(lambda *a: jmod.init(
        {"params": jax.random.key(0)}, *a), *args)
    params, stats = seeded(shapes, 7)

    def read(v, *a):
        seen = []

        def grab(next_fun, fa, fkw, ctx):
            if ctx.module.name == "obj_embedding_0":
                seen.append(fa[0])
            return next_fun(*fa, **fkw)

        with fnn.intercept_methods(grab):
            if train:
                out, _ = jmod.apply(v, *a, train=True,
                                    mutable=["batch_stats"])
            else:
                out = jmod.apply(v, *a, train=False)
        return out, seen[0]

    with no_jax_dropout():
        want, want_rows = jax.device_get(jax.jit(read)(
            {"params": params, "batch_stats": stats}, *args))
    port = port_module(RelationModule(multiview_offset=3, multiview_dim=c,
                                      reference_obj_gather=True,
                                      device="cpu"),
                       convert.convert_relation, params, stats)
    port.train(train)
    rows = []
    port.obj_embedding[0].register_forward_pre_hook(
        lambda mod, a: rows.append(a[0].clone()) and None)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(rows[0].numpy(), want_rows)
    assert_outputs(got, want, MODULE_TOL)
    # it is not the documented point -> seed -> proposal read
    point_idx = np.take_along_axis(args[5], args[6], axis=1)
    intended = np.take_along_axis(point_clouds[..., 3:], point_idx[..., None],
                                  axis=1)
    assert not np.array_equal(rows[0].numpy(), intended)


def _convert_match(params, stats, prefix, out):
    convert.convert_match(params, prefix, out, stats=stats)


def _match_inputs(seed, b=BATCH, l=4, k=16, t=6, h=128):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, k, h)).astype(np.float32),
            rng.normal(size=(b * l, t, h)).astype(np.float32),
            rng.normal(size=(b * l, h)).astype(np.float32),
            (rng.random((b, k)) < 0.5).astype(np.float32))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("lang_emb,reg_head", [(True, True), (True, False),
                                               (False, True)])
def test_match_options_match_jax(lang_emb, reg_head, train):
    """The lang-emb scorer (its (B*L, K) score added to cluster_ref) and
    the regression head (tanh GELU; offsets in [-0.05, 0.05]); in
    training with copy-paste on (gate 0.3). The converter numbers the
    regression head's modules after the lang-emb branch's, or from
    Dense_3 without it."""
    bbox, lang_fea, lang_emb_in, obj = _match_inputs(8)
    jmod = JaxMatch(num_proposals=16, use_lang_emb=lang_emb,
                    use_reg_head=reg_head)
    kw = dict(lang_num_max=4, random_gate=jnp.float32(0.3))
    shapes = jax.eval_shape(lambda *a: jmod.init(
        {"params": jax.random.key(0)}, *a, **kw), bbox, lang_fea,
        lang_emb_in, obj)
    params, stats = seeded(shapes, 9)
    want, new = jax_apply(jmod, params, stats, bbox, lang_fea, lang_emb_in,
                          obj, train=train, **kw)
    port = port_module(MatchModule(num_proposals=16, use_lang_emb=lang_emb,
                                   use_reg_head=reg_head, device="cpu"),
                       _convert_match, params, stats)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(bbox), torch.from_numpy(lang_fea),
                   torch.from_numpy(obj), lang_num_max=4, random_gate=0.3,
                   lang_emb=torch.from_numpy(lang_emb_in))
    assert set(got) == set(want)
    assert_outputs(got, want, MODULE_TOL)
    if reg_head:
        assert got["pred_center_reg"].shape == (BATCH, 4, 16, 3)
        assert float(got["pred_size_reg"].abs().max()) <= 0.05
    if lang_emb:
        slopes = port.lang_emb_proj[2].weight
        assert len(set(slopes.tolist())) == slopes.numel()  # per channel
    if train:
        assert_stats(port, new, _convert_match, params)


@pytest.mark.parametrize("distil,classifier", [(True, True),
                                               (False, False)])
def test_lang_module_options_match_jax(distil, classifier):
    """DistilBERT (6 layers, no token-type table) and the language module
    without its classifier (no lang_cls, no lang_scores)."""
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 30522, (BATCH, 3, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, :, 5:] = 0
    jcfg = jax_distilbert_config() if distil else None
    pcfg = distilbert_config() if distil else None
    extra = {"bert_config": jcfg} if distil else {}
    jmod = JaxLang(use_lang_classifier=classifier, **extra)
    shapes = jax.eval_shape(lambda a, m: jmod.init(
        {"params": jax.random.key(0)}, a, m), ids, mask)
    params, _ = seeded(shapes, 11)
    want, _ = jax_apply(jmod, params, {}, ids, mask, train=False)
    kw = {"bert_config": pcfg} if distil else {}
    port = LangModule(use_lang_classifier=classifier, device="cpu", **kw)
    port = port_module(port, lambda p, s, pre, out: convert.convert_lang(
        p, pre, out), params, {})
    got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert set(got) == set(want)
    assert ("lang_scores" in got) == classifier
    emb = port.text_encoder.bert.embeddings
    assert (emb.token_type_embeddings is None) == distil
    assert len(port.text_encoder.bert.encoder.layer) == 6
    assert_outputs(got, want, MODULE_TOL)


def _bf16_pair(seed, train):
    cfg = tiny_config(**BASE).model
    kw = dict(npoints=tuple(cfg.sa_npoints), radii=tuple(cfg.sa_radii),
              nsamples=tuple(cfg.sa_nsamples))
    pc = make_batch(tiny_config(**BASE), batch_size=BATCH, num_points=256,
                    seed=seed)["point_clouds"]
    jmod = JaxBackbone(input_feature_dim=cfg.input_feature_dim,
                       dtype=jnp.bfloat16, **kw)
    shapes = jax.eval_shape(lambda p: jmod.init(
        {"params": jax.random.key(0)}, p), pc)
    params, stats = seeded(shapes, seed + 100)
    want, _ = jax_apply(jmod, params, stats, pc, train=train)
    outs = {}
    for dtype in (torch.bfloat16, None):
        port = port_module(PointNet2Backbone(
            cfg.input_feature_dim, dtype=dtype, device="cpu", **kw),
            convert.convert_backbone, params, stats)
        port.train(train)
        with torch.no_grad():
            outs[dtype] = port(torch.from_numpy(pc))
    return want, outs[torch.bfloat16], outs[None]


@pytest.mark.parametrize("train", [False, True])
def test_bf16_backbone_matches_jax_bf16(train):
    """compute_dtype="bfloat16": the SA1-4 and FP1-2 MLPs in bfloat16
    (flax 0.12.3's Dense / BatchNorm arithmetic), every output float32.
    The FPS indices of SA1-4 read only xyz and are equal; each feature's
    largest and mean error are held to BF16_BOUNDS."""
    bound_max, bound_mean = BF16_BOUNDS[train]
    worst, gap = [0.0, 0.0], [0.0, 0.0]
    for seed in (1, 2, 3):
        want, got, f32 = _bf16_pair(seed, train)
        for k in ("sa1_inds", "sa2_inds", "fp2_inds"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        for k in ("sa1_features", "sa2_features", "sa3_features",
                  "sa4_features", "fp2_features"):
            assert got[k].dtype == torch.float32
            scale = float(np.abs(want[k]).max())
            err = np.abs(got[k].numpy() - want[k]) / scale
            off = (f32[k] - got[k]).abs().numpy() / scale
            worst = [max(worst[0], err.max()), max(worst[1], err.mean())]
            gap = [max(gap[0], off.max()), max(gap[1], off.mean())]
            assert err.max() <= bound_max, (seed, k, err.max())
            assert err.mean() <= bound_mean, (seed, k, err.mean())
    print(f"bf16 backbone (train={train}) against JAX bf16, of the largest "
          f"entry: largest {worst[0]}, mean {worst[1]}; against the port's "
          f"float32 forward: largest {gap[0]}, mean {gap[1]}")
    if not train:
        assert gap[1] > bound_mean


# ---------------------------------------------------------- the JointNet


def _train_batch(config, seed=17):
    b = make_batch(config, batch_size=BATCH, num_points=256, seed=seed)
    b["random"] = np.float32(0.3)  # copy-paste and the label mask on
    return b


@contextlib.contextmanager
def injected_box_masks(config, batch_size=BATCH, seed=21):
    """Both packages' box masks from one set of numpy draws (their
    generators cannot agree): JAX's ``mask_boxes`` and the port's
    ``box_mask_draws`` monkeypatched."""
    rng = np.random.default_rng(seed)
    shape = (batch_size, config.model.num_proposal, 3)
    mask = rng.random(shape[:2] + (1,)) < 0.3
    center = (rng.normal(size=shape) / 2).astype(np.float32)
    size = (1 + rng.normal(size=shape)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_proposal_mod, "mask_boxes", lambda key, c, s: (
        jnp.where(mask, center, c), jnp.where(mask, size, s)))
    mp.setattr(port_proposal_mod, "box_mask_draws", lambda b, k, gen, dev: (
        torch.from_numpy(mask), torch.from_numpy(center),
        torch.from_numpy(size)))
    try:
        yield mask
    finally:
        mp.undo()


def jointnet_pair(flags, seed=0):
    """(JAX model, params, stats, the port's JointNet loaded from
    ``jax_to_torch_state_dict``)."""
    jcfg, pcfg = jax_tiny_config(**flags), tiny_config(**flags)
    jmod = JaxJointNet(jcfg)
    b0 = _train_batch(pcfg)
    shapes = jax.eval_shape(lambda b: jmod.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "aug": jax.random.key(2)}, b, train=True), b0)
    params, stats = seeded(shapes, seed)
    port = JointNet(pcfg, device="cpu")
    port.load_state_dict(convert.jax_to_torch_state_dict(params, stats),
                         strict=True)
    return jmod, params, stats, no_port_dropout(port)


def check_jointnet(flags, train):
    """The port's JointNet forward against JAX's on one batch (box masks
    injected). A training forward follows JAX's side of 0 at every ReLU /
    PReLU input (each such unit within FLIP_TOL of 0): a unit on the other
    side would move its BatchNorm channel's batch statistics. Returns the
    port's outputs, the injected mask and {module: units followed}."""
    jmod, params, stats, port = jointnet_pair(flags)
    batch = _train_batch(port.config)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    got, flips = {}, {}
    with injected_box_masks(port.config) as mask:
        if train:
            want, _, kinks = jax_apply(jmod, params, stats, batch,
                                       train=True, kinks=True)
            flips = _follow_jax_kinks(
                port, {"kink_names": _kink_names(params, stats, kinks)},
                lambda: got.update(port(tbatch, train=True)))
        else:
            want, _ = jax_apply(jmod, params, stats, batch, train=False)
            got = port(tbatch)
    for name, (_, near) in flips.items():
        assert near <= FLIP_TOL, (name, near)
    assert set(got) == set(want), set(got) ^ set(want)
    if not train:
        assert_outputs(got, want, MODEL_TOL)
        return got, mask, flips
    for k, w in want.items():
        w, g = np.asarray(w), got[k].detach().numpy()
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        err = np.abs(g - w) / max(float(np.abs(w).max()), 1e-30)
        assert err.max() <= TRAIN_MAX and np.median(err) <= TRAIN_MEDIAN, (
            k, err.max(), np.median(err))
    return got, mask, flips


@pytest.mark.parametrize("train", [False, True])
def test_every_option_at_once_matches_jax(train):
    """Every option on, box masks injected into both packages."""
    got, mask, flips = check_jointnet({**BASE, **OPTIONS}, train=train)
    for k in ("vote_weights", "alpha", "pred_center_reg", "pred_size_reg"):
        assert k in got
    assert "lang_scores" not in got
    if train:  # the masked boxes are what the relation module read
        masked = np.broadcast_to(mask, got["pred_center"].shape)
        assert masked.any()
        print(f"ReLU inputs that followed JAX: {flips}")


@pytest.mark.parametrize("train", [False, True])
def test_no_reference_matches_jax(train):
    got, _, _ = check_jointnet({**BASE, "no_reference": True}, train=train)
    assert "cluster_ref" not in got and "lang_fea" not in got


def test_no_reference_builds_no_grounding_branch():
    model = JointNet(tiny_config(**{**BASE, "no_reference": True,
                                    "use_con": True}), device="cpu")
    names = {k.split(".")[0] for k in model.state_dict()}
    assert not names & {"lang", "match", "constrast"}, names
    with pytest.raises(ValueError, match="no_reference"):
        JointNet(tiny_config(**BASE, no_reference=True, use_answer=True),
                 device="cpu")


def test_compute_dtype_is_checked():
    JointNet(tiny_config(**BASE, compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="'float16'"):
        JointNet(tiny_config(**BASE, compute_dtype="float16"), device="cpu")


# ------------------------------------------------------ the PReLU layouts


def test_prelu_slopes_in_both_layouts():
    """jax_to_torch_state_dict keeps JAX's distinct per-channel slopes
    (and so JAX's outputs, test_every_option_at_once_matches_jax); the
    reference layout that export_jointnet_state_dict writes has one slope
    at the vote-weight predictor and the lang-emb branch, their mean, and
    loads strictly onto every channel. The relation PReLU is per-channel
    in both."""
    flags = {**BASE, "use_vote_weight": True, "use_lang_emb": True}
    _, params, stats, port = jointnet_pair(flags)
    ref = export_jointnet_state_dict(params, stats)
    sites = {"proposal.votes_weight_predictor.2":
             params["proposal"]["PReLU_0"]["alpha"],
             "match.lang_emb_proj.2": params["match"]["prelu0"]["alpha"],
             "match.lang_emb_proj.5": params["match"]["prelu1"]["alpha"]}
    model = JointNet(tiny_config(**flags), device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in ref.items()}, strict=True)
    for name, alpha in sites.items():
        assert ref[name + ".weight"].shape == (1,)
        lossless = port.get_parameter(name + ".weight").detach().numpy()
        np.testing.assert_array_equal(lossless, alpha)
        assert len(set(lossless.tolist())) == lossless.size
        loaded = model.get_parameter(name + ".weight").detach().numpy()
        np.testing.assert_allclose(loaded, np.full(alpha.shape, alpha.mean()),
                                   rtol=1e-6)
    relation = "relation.features_concat.2.weight"
    assert ref[relation].shape == (128,)
    np.testing.assert_array_equal(model.state_dict()[relation].numpy(),
                                  ref[relation])
    # a (1,) slope is the identity on load: it applies to every channel
    prelu = PReLU(4, device="cpu")
    prelu.load_state_dict({"weight": torch.tensor([0.5])}, strict=True)
    x = torch.tensor([-1.0, -2.0, 3.0, -4.0])
    assert torch.equal(prelu(x), torch.tensor([-0.5, -1.0, 3.0, -2.0]))


def test_reference_export_with_every_option_loads_strictly():
    """export_jointnet_state_dict's reference-layout dict of a model with
    every option on loads into the port strictly, and gives JAX's
    evaluation forward where the slopes it collapses are equal per
    channel. DistilBERT is left out: the JAX export cannot write it
    (ROADMAP.md C9)."""
    flags = {**BASE, **OPTIONS, "use_distil": False}
    jmod, params, stats, _ = jointnet_pair(flags, seed=3)
    for tree, name in ((params["proposal"], "PReLU_0"),
                       (params["match"], "prelu0"),
                       (params["match"], "prelu1")):
        tree[name]["alpha"][:] = tree[name]["alpha"].mean()
    model = no_port_dropout(JointNet(tiny_config(**flags), device="cpu"))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           export_jointnet_state_dict(params, stats).items()},
                          strict=True)
    batch = _train_batch(model.config)
    want, _ = jax_apply(jmod, params, stats, batch, train=False)
    got = model({k: torch.from_numpy(np.asarray(v))
                 for k, v in batch.items()})
    assert_outputs(got, want, MODEL_TOL, keys=(
        "aggregated_vote_inds", "vote_weights", "alpha", "cluster_ref",
        "pred_center_reg", "pred_size_reg", "bbox_feature"))


@pytest.mark.parametrize("flags,missing", [
    ({"use_reg_head": True}, "prelu0"),
    ({"use_distil": True}, "token_type_embeddings")])
def test_jax_export_faults_the_port_does_not_copy(flags, missing):
    """ROADMAP.md C9: export_jointnet_state_dict reads the regression
    head as the lang-emb branch when that is absent (flax numbers both
    from Dense_3), and reads a token-type table DistilBERT does not
    have; both raise KeyError. The port's converter carries both trees,
    and its JointNet loads them strictly."""
    flags = {**BASE, **flags}
    _, params, stats, port = jointnet_pair(flags, seed=4)
    with pytest.raises(KeyError, match=missing):
        export_jointnet_state_dict(params, stats)
    assert set(port.state_dict()) == set(
        convert.jax_to_torch_state_dict(params, stats))
