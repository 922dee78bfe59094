"""The building blocks of the single-task pipelines, the port's against
the JAX package's on the CPU, under weights converted from the flax
trees (``convert_lstm_lang``, ``convert_mcan``, ``convert_attflat``,
``convert_votenet_head``), inputs from numpy seeds:

  * ``LSTMLangModule``, unidirectional and bidirectional, with a language
    classifier, on ragged lengths that include 0, 1 and T: every output
    within 1e-5 (absolute), and the gradients of a weighted sum of the
    outputs with respect to the inputs and every parameter within 1e-5 of
    each tensor's largest entry. A row of length 0 is handled as flax's
    ``nn.RNN(seq_lengths=)`` handles it: its token features are all zero,
    its forward embedding is the output of step 0 and its backward one
    the whole padded row run in reverse;
  * ``MCAN_ED`` (2 layers, 8 heads, hidden 128) with key masks on the
    language padding and on the proposals, one scene with every proposal
    masked (MCAN's -1e9 fill gives that row's queries the uniform softmax
    over its keys, finite, as in JAX): both outputs within 1e-5;
  * the masked ``AttFlat`` (flat_out 1024, a row with every entry
    masked included) within 1e-5, and the unmasked one of JointNet's
    answer head unchanged (its keys);
  * the VoteNet head: the aggregation's sampled indices equal, the size
    class and objectness masks equal, every float output within 1e-5 at
    evaluation; in training (batch statistics) within 1e-4 of each
    tensor's largest entry, test_torch_modules.py's training tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp3d.models.answer import AttFlat as JaxAttFlat
from vlp3d.models.lang_lstm import LSTMLangModule as JaxLSTM
from vlp3d.models.mcan import MCAN_ED as JaxMCAN
from vlp3d.models.votenet_head import VoteNetProposalModule as JaxVoteNet
from vlp3d_torch.convert import (
    convert_attflat,
    convert_lstm_lang,
    convert_mcan,
    convert_votenet_head,
    to_tensors,
)
from vlp3d_torch.models.answer import AnswerModule, AttFlat
from vlp3d_torch.models.lang_lstm import LSTMLangModule, flip_within_length
from vlp3d_torch.models.mcan import MCAN_ED
from vlp3d_torch.models.votenet_head import VoteNetProposalModule

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol,
                               err_msg=what)


def test_flip_within_length_is_flax_flip():
    from flax.linen.recurrent import flip_sequences

    lens = np.array([0, 1, 3, 5], np.int32)
    x = np.arange(4 * 5).reshape(4, 5)
    want = np.asarray(flip_sequences(jnp.asarray(x), jnp.asarray(lens), 1,
                                     False))
    perm = flip_within_length(torch.from_numpy(lens).long(), 5)
    got = torch.gather(torch.from_numpy(x), 1, perm).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bidir", [False, True])
def test_lstm_lang_module_matches_flax(bidir):
    rng = np.random.default_rng(int(bidir))
    n, t, e, h = 6, 7, 11, 9
    x = rng.normal(size=(n, t, e)).astype(np.float32)
    lens = np.array([0, 1, t, 3, 5, 2], np.int32)
    jmod = JaxLSTM(num_object_class=5, use_lang_classifier=True,
                   use_bidir=bidir, hidden_size=h)
    variables = jmod.init(jax.random.key(3), jnp.asarray(x),
                          jnp.asarray(lens))
    params = _np(variables["params"])
    wout = rng.normal(size=(n, t, h * (2 if bidir else 1))).astype(np.float32)
    wemb = rng.normal(size=(n, h * (2 if bidir else 1))).astype(np.float32)

    def jloss(p, x):
        out = jmod.apply({"params": p}, x, jnp.asarray(lens))
        return (jnp.sum(out["lang_fea_lstm"] * wout)
                + jnp.sum(out["lang_emb_lstm"] * wemb)
                + jnp.sum(out["lang_scores"] ** 2)), out

    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(lens))
    gp, gx = jax.grad(lambda p, x: jloss(p, x)[0], argnums=(0, 1))(
        params, jnp.asarray(x))
    sd = {}
    convert_lstm_lang(params, "", sd)
    port = LSTMLangModule(e, h, num_object_class=5, use_bidir=bidir,
                          device="cpu")
    port.load_state_dict(to_tensors(sd), strict=True)
    port.eval()  # the JAX module's train=False: no dropout
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, torch.from_numpy(lens))
    for k in ("lang_fea_lstm", "lang_emb_lstm", "lang_scores"):
        _close(got[k], want[k], what=k)
    assert not got["lang_fea_lstm"][0].any()  # length 0: all padding
    loss = ((got["lang_fea_lstm"] * torch.from_numpy(wout)).sum()
            + (got["lang_emb_lstm"] * torch.from_numpy(wemb)).sum()
            + (got["lang_scores"] ** 2).sum())
    loss.backward()
    gsd = {}
    convert_lstm_lang(_np(gp), "", gsd)
    for name, p in port.named_parameters():
        want_g = gsd[name]
        scale = max(float(np.abs(want_g).max()), 1e-6)
        _close(p.grad / scale, want_g / scale, what=f"grad {name}")
    gx = np.asarray(gx)
    _close(xt.grad / np.abs(gx).max(), gx / np.abs(gx).max(),
           what="input grad")


def _mcan_inputs(rng, b=3, t=6, k=10, hidden=128):
    lang = rng.normal(size=(b, t, hidden)).astype(np.float32)
    objs = rng.normal(size=(b, k, hidden)).astype(np.float32)
    lang_mask = np.arange(t)[None] >= np.array([6, 2, 4])[:, None]
    obj_mask = rng.random((b, k)) < 0.5
    obj_mask[1] = True  # every proposal of scene 1 masked
    obj_mask[2] = False
    return lang, objs, lang_mask, obj_mask


def test_mcan_matches_flax_with_masks():
    rng = np.random.default_rng(5)
    lang, objs, lang_mask, obj_mask = _mcan_inputs(rng)
    jmod = JaxMCAN(128, num_layers=2)
    args = (jnp.asarray(lang), jnp.asarray(objs), jnp.asarray(lang_mask),
            jnp.asarray(obj_mask))
    params = _np(jmod.init(jax.random.key(1), *args)["params"])
    want_l, want_o = jmod.apply({"params": params}, *args)
    sd = {}
    convert_mcan(params, "", sd)
    port = MCAN_ED(128, num_layers=2, device="cpu")
    port.load_state_dict(to_tensors(sd), strict=True)
    port.eval()
    got_l, got_o = port(*(torch.from_numpy(a) for a in (lang, objs,
                                                          lang_mask,
                                                          obj_mask)))
    _close(got_l, want_l, what="lang")
    _close(got_o, want_o, what="objects")
    assert torch.isfinite(got_o).all()
    # a fully masked key row: uniform attention, not NaN; -inf would NaN
    att = port.dec_list[0].mhatt1
    q = torch.from_numpy(objs)
    scores = att(q, q, q, torch.from_numpy(obj_mask))
    assert torch.isfinite(scores).all()


def test_masked_attflat_matches_flax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 12, 128)).astype(np.float32)
    mask = rng.random((4, 12)) < 0.4
    mask[3] = True  # every entry masked: the uniform glimpse
    jmod = JaxAttFlat(128, flat_out_size=1024)
    params = _np(jmod.init(jax.random.key(2), jnp.asarray(x),
                           jnp.asarray(mask))["params"])
    sd = {}
    convert_attflat(params, "", sd)
    port = AttFlat(1024, device="cpu")
    port.load_state_dict(to_tensors(sd), strict=True)
    port.eval()
    for m in (mask, None):
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          None if m is None else jnp.asarray(m))
        got = port(torch.from_numpy(x),
                   None if m is None else torch.from_numpy(m))
        _close(got, want, what=f"mask {m is not None}")
    assert list(AnswerModule(7, device="cpu").state_dict()) == [
        "attflat_visual.mlp.fc.linear.weight",
        "attflat_visual.mlp.fc.linear.bias",
        "attflat_visual.mlp.linear.weight", "attflat_visual.mlp.linear.bias",
        "attflat_visual.linear_merge.weight",
        "attflat_visual.linear_merge.bias", "answer_cls.0.weight",
        "answer_cls.0.bias", "answer_cls.3.weight", "answer_cls.3.bias"]


@pytest.mark.parametrize("train", [False, True])
def test_votenet_head_matches_flax(train):
    rng = np.random.default_rng(11)
    b, v = 2, 96
    xyz = rng.uniform(0, 4, (b, v, 3)).astype(np.float32)
    feats = rng.normal(size=(b, v, 256)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    mean = rng.uniform(0.3, 1.5, (18, 3)).astype(np.float32)
    jmod = JaxVoteNet(num_proposal=16)
    variables = jmod.init(jax.random.key(4), jnp.asarray(xyz),
                          jnp.asarray(feats), jnp.asarray(mean))
    params = _np(variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32),
        _np(variables["batch_stats"]))
    want = jmod.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(xyz), jnp.asarray(feats),
                      jnp.asarray(mean), train=train,
                      mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    sd = {}
    convert_votenet_head(params, stats, "", sd)
    port = VoteNetProposalModule(num_proposal=16, mean_size_arr=mean,
                                 device="cpu")
    port.load_state_dict(to_tensors(sd), strict=True)
    port.train(train)
    got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        if k in ("aggregated_vote_inds", "objectness_masks"):
            assert np.array_equal(got[k].numpy(), w), k
        elif train:
            # batch statistics: E[x^2] - E[x]^2 over 512 rows in float32,
            # summed in another order (test_torch_modules.py's training
            # tolerance, of the tensor's largest entry)
            _close(got[k], w, tol=1e-4 * max(1.0, float(np.abs(w).max())),
                   what=k)
        else:
            _close(got[k], w, what=k)
    size_cls = np.argmax(np.asarray(want["size_scores"]), -1)
    assert np.array_equal(torch.argmax(got["size_scores"], -1).numpy(),
                          size_cls)
