"""The DETR proposal head, the xbert captioner, the BERT fusion layer and
positive match of vlp3d_torch against the JAX package, on the CPU.
Weights are seeded numpy fills in the flax modules' shapes
(``tests/torch_task_steps.py``) carried over by ``vlp3d_torch.convert``
and loaded with ``strict=True``. Stated tolerances:

  * ``idw_attention_mask``: the same NEAR_KTH sources selected (the
    lowest index first among equal distances) and -1e9 elsewhere, bit for
    bit; the inverse-distance weights within 1e-6 (a sum of 5 in another
    order). Held on a tie-heavy case: integer grid positions with
    duplicated rows, so that many distances are equal;
  * the DETR head in float64 on both sides (its attention masks follow
    every refined position, so a float32 run moves a nearest-5 choice on
    a near tie and a whole row of attention with it): the evaluation
    forward's indices equal and floats within 1e-6; the training forward
    and backward of a scalar of its outputs (dropout off) with every
    gradient within 1e-6 of its tensor's largest entry (floored at
    1e-3);
  * the xbert captioner (float32): the train logits within 1e-4, and the
    greedy decode's ids equal to JAX's, and equal to the port's own
    literal decode (the whole sequence through the decoder at every step,
    as JAX runs it);
  * ``BertFusionLayer`` with an encoder mask: within 1e-5;
  * ``positive_match``: labels and good-box masks equal (the lowest index
    on a tie, 0 on a row of zero IoUs), IoUs within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_task_steps import no_dropout, seeded_variables
from vlp3d.models.bert import BertConfig as JaxBertConfig
from vlp3d.models.bert import BertFusionLayer as JaxFusion
from vlp3d.models.caption_xbert import CaptionModuleX as JaxCaptionX
from vlp3d.models.positive_match import positive_match as jax_positive_match
from vlp3d.models.proposal_detr import DETRProposalModule as JaxDETR
from vlp3d.models.proposal_detr import idw_attention_mask as jax_idw
from vlp3d_torch import convert
from vlp3d_torch.models.bert import BertConfig, BertFusionLayer
from vlp3d_torch.models.caption_xbert import CLS_ID, CaptionModuleX
from vlp3d_torch.models.positive_match import positive_match
from vlp3d_torch.models.proposal_detr import (
    NEAR_KTH,
    DETRProposalModule,
    idw_attention_mask,
)

DETR = dict(num_proposal=16, n_layers=2, d_model=32, heads=4, d_ff=64)
XBERT = dict(hidden_size=32, depth=2, vocab_size=160, max_len=6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", ["grid_duplicates", "random"])
def test_idw_mask_matches_jax_on_ties(case):
    rng = np.random.default_rng(0)
    if case == "grid_duplicates":
        pos = rng.integers(0, 3, (2, 24, 3)).astype(np.float32)
        pos[:, 12:] = pos[:, :12]  # every proposal twice
        src = pos
    else:
        pos = rng.uniform(0, 4, (2, 24, 3)).astype(np.float32)
        src = rng.uniform(0, 4, (2, 30, 3)).astype(np.float32)
    want = np.asarray(jax_idw(jnp.asarray(pos), jnp.asarray(src)))
    got = idw_attention_mask(torch.from_numpy(pos),
                             torch.from_numpy(src)).numpy()
    assert got.shape == want.shape
    sel_w, sel_g = want > -1e8, got > -1e8
    np.testing.assert_array_equal(sel_g, sel_w)
    assert (sel_g.sum(-1) == NEAR_KTH).all()
    np.testing.assert_array_equal(got[~sel_g], want[~sel_w])
    np.testing.assert_allclose(got[sel_g], want[sel_w], rtol=1e-6, atol=1e-6)
    if case == "grid_duplicates":  # ties were there to break
        d2 = ((pos[:, :, None] - src[:, None]) ** 2).sum(-1)
        kth = np.sort(d2, -1)[..., NEAR_KTH - 1: NEAR_KTH + 1]
        assert (kth[..., 0] == kth[..., 1]).any()


@pytest.fixture(scope="module")
def detr_side():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(0, 4, (2, 64, 3))
    feats = rng.normal(size=(2, 64, 256))
    mean = rng.uniform(0.5, 1.5, (18, 3))
    mod = JaxDETR(**DETR)
    shapes = jax.eval_shape(lambda: mod.init(
        {"params": jax.random.key(0)}, xyz.astype(np.float32),
        feats.astype(np.float32), mean.astype(np.float32)))
    params, stats = seeded_variables(shapes, seed=2)
    mp = no_dropout()
    try:
        with jax.enable_x64(True):
            params = jax.tree_util.tree_map(_f64, params)
            stats = jax.tree_util.tree_map(_f64, stats)

            def loss(p, x, f):
                out, _ = mod.apply({"params": p, "batch_stats": stats}, x, f,
                                   mean, train=True, mutable=["batch_stats"])
                return _scalar(out, jnp)

            @jax.jit
            def run(x, f):
                ev = mod.apply({"params": params, "batch_stats": stats}, x,
                               f, mean)
                return ev, jax.grad(loss)(params, x, f)

            ev, grads = jax.device_get(run(xyz, feats))
    finally:
        mp.undo()
    return dict(params=params, stats=stats, xyz=xyz, feats=feats, mean=mean,
                eval=ev, grads=grads)


def _scalar(out, xp):
    """A loss that reads every head of the DETR module's outputs."""
    return (xp.mean(out["detr_features"] ** 2)
            + xp.mean(out["pred_center"] ** 2)
            + xp.mean(out["transformer_weighted_xyz_all"] ** 2)
            + xp.mean(out["objectness_scores"] * out["sem_cls_scores"][..., :2])
            + xp.mean(out["size_residuals"] ** 2)
            + xp.mean(out["heading_scores"] ** 2))


def _port_detr(side):
    model = DETRProposalModule(**DETR, device="cpu").double()
    model.load_state_dict(convert.detr_to_torch_state_dict(
        side["params"], side["stats"]), strict=True)
    for m in model.modules():
        if hasattr(m, "p") and isinstance(getattr(m, "p"), float):
            m.p = 0.0
    return model


def test_detr_forward_matches_jax(detr_side):
    model = _port_detr(detr_side)
    args = [torch.from_numpy(detr_side[k]) for k in ("xyz", "feats", "mean")]
    got = model(*args)
    want = detr_side["eval"]
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["aggregated_vote_inds"].numpy(),
                                  np.asarray(want["aggregated_vote_inds"]))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert got["transformer_weighted_xyz_all"].shape == (2, 2, 16, 3)


def test_detr_backward_matches_jax(detr_side):
    model = _port_detr(detr_side)
    args = [torch.from_numpy(detr_side[k]) for k in ("xyz", "feats", "mean")]
    _scalar(model(*args, train=True), torch).backward()
    want = convert.detr_to_torch_state_dict(detr_side["grads"],
                                            detr_side["stats"])
    held = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-6 * max(float(np.abs(w).max()), 1e-3), name
        held += int(np.abs(w).max() > 1e-6)
    assert held >= 0.9 * len(list(model.parameters()))
    # the refinement's gradient flows through the refined positions only:
    # the masks are detached
    assert float(model.layers[0].linear_offset.weight.grad.abs().max()) > 0


def _xbert_inputs(rng, b=2, k=8, l=3, t=9, vocab=160):
    feats = rng.normal(size=(b, k, XBERT["hidden_size"])).astype(np.float32)
    ids = rng.integers(1, vocab, (b, l, t)).astype(np.int32)
    ids[:, :, 0] = CLS_ID
    mask = np.ones((b, l, t), np.float32)
    mask[0, 1, 5:] = 0.0
    ids[0, 1, 5:] = 0
    pos = rng.integers(0, k, (b, l)).astype(np.int32)
    return feats, ids, mask, pos


@pytest.fixture(scope="module")
def xbert_side():
    rng = np.random.default_rng(3)
    feats, ids, mask, pos = _xbert_inputs(rng)
    mod = JaxCaptionX(**XBERT)
    shapes = jax.eval_shape(lambda: mod.init(
        {"params": jax.random.key(0)}, feats, ids, mask, pos))
    params, _ = seeded_variables({"params": shapes["params"],
                                  "batch_stats": {}}, seed=4)
    logits = jax.jit(lambda p: mod.apply({"params": p}, feats, ids, mask,
                                         pos))(params)
    gen = jax.jit(lambda p, f: mod.apply({"params": p}, f,
                                         method=JaxCaptionX.generate))
    return dict(params=params, feats=feats, ids=ids, mask=mask, pos=pos,
                logits=np.asarray(logits), generate=np.asarray(
                    gen(params, feats)))


def _port_xbert(side):
    model = CaptionModuleX(**XBERT, device="cpu")
    model.load_state_dict(convert.caption_xbert_to_torch_state_dict(
        side["params"]), strict=True)
    return model


def test_xbert_train_logits_match_jax(xbert_side):
    model = _port_xbert(xbert_side)
    got = model(*(torch.from_numpy(xbert_side[k]) for k in
                  ("feats", "ids", "mask", "pos")))
    assert got.shape == (2 * 3, 9 - 1, XBERT["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), xbert_side["logits"],
                               rtol=1e-4, atol=1e-4)


def _literal_generate(model, feats):
    """JAX's decode: the whole max_len + 2 sequence through the decoder at
    every step, padding mask arange <= i + 1, logits at step i + 1."""
    b, k, h = feats.shape
    n, tmax = b * k, model.max_len + 1
    ext = feats.repeat_interleave(k, dim=0)
    target = feats.reshape(n, 1, h)
    ids = torch.zeros(n, tmax, dtype=torch.long)
    ids[:, 0] = CLS_ID
    with torch.no_grad():
        for i in range(model.max_len):
            inputs = torch.cat([target, model.embeddings(ids)], dim=1)
            mask = (torch.arange(tmax + 1)[None] <= i + 1).float().repeat(
                n, 1)
            logits, _ = model.decoder(inputs, mask, ext)
            ids[:, i + 1] = torch.argmax(logits[:, i + 1], dim=-1)
    return ids.reshape(b, k, tmax)


def test_xbert_generate_matches_jax_and_the_literal_decode(xbert_side):
    model = _port_xbert(xbert_side)
    feats = torch.from_numpy(xbert_side["feats"])
    got = model.generate(feats).numpy()
    assert got.shape == (2, 8, XBERT["max_len"] + 1)
    assert (got[:, :, 0] == CLS_ID).all()
    np.testing.assert_array_equal(got, xbert_side["generate"])
    np.testing.assert_array_equal(got, _literal_generate(model, feats).numpy())
    assert len(np.unique(got[:, :, 1:])) > 3  # not one repeated token


def test_bert_fusion_layer_with_an_encoder_mask_matches_jax():
    rng = np.random.default_rng(5)
    cfg = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64,
               num_hidden_layers=1, fusion_layer=0, vocab_size=50)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    am = np.ones((3, 7), np.float32)
    am[1, 4:] = 0
    enc = rng.normal(size=(3, 5, 32)).astype(np.float32)
    em = np.ones((3, 5), np.float32)
    em[2, 3:] = 0
    mod = JaxFusion(JaxBertConfig(**cfg), causal=True)
    shapes = jax.eval_shape(lambda: mod.init(
        {"params": jax.random.key(0)}, x, am, enc, em))
    params, _ = seeded_variables({"params": shapes["params"],
                                  "batch_stats": {}}, seed=6)
    want = np.asarray(mod.apply({"params": params}, x, am, enc, em))
    sd = {}
    convert.convert_fusion_layer(params, "", sd)
    port = BertFusionLayer(BertConfig(**cfg), causal=True, device="cpu")
    port.load_state_dict(convert.to_tensors(sd), strict=True)
    port.eval()
    got = port(*(torch.from_numpy(a) for a in (x, am, enc, em)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_positive_match_matches_jax_on_ties_and_empty_rows():
    rng = np.random.default_rng(7)
    pc = rng.uniform(0, 3, (2, 12, 3)).astype(np.float32)
    ps = rng.uniform(0.3, 1.2, (2, 12, 3)).astype(np.float32)
    pc[:, 6:], ps[:, 6:] = pc[:, :6], ps[:, :6]  # duplicates tie
    gc = np.concatenate([pc[:, [1, 3]], np.full((2, 2, 3), 50.0,
                                                np.float32)], axis=1)
    gs = np.concatenate([ps[:, [1, 3]], np.ones((2, 2, 3), np.float32)], 1)
    want = jax_positive_match(*(jnp.asarray(a) for a in (pc, ps, gc, gs)))
    got = positive_match(*(torch.from_numpy(a) for a in (pc, ps, gc, gs)))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["positive_labels"].numpy(),
                                  np.asarray(want["positive_labels"]))
    np.testing.assert_array_equal(got["good_bbox_masks"].numpy(),
                                  np.asarray(want["good_bbox_masks"]))
    for k in ("target_ious", "pred_ious"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    labels = got["positive_labels"].reshape(2, 4).numpy()
    assert (labels[:, :2] == [1, 3]).all()  # the first of each tie
    assert (labels[:, 2:] == 0).all()  # rows of zero IoU
