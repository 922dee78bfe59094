"""The captioning slice of vlp3d_torch against the JAX package, on the CPU.

Decoder-level parity at a small size (2 layers, d_model 32, 4 heads, d_ff
64, vocab 97, a few proposals): the JAX CaptionDecoder's parameters
(perturbed from flax's initialisation so that biases and norm scales
matter) go through ``convert_caption`` into the port's CaptionDecoder.
Stated tolerances:

  * RefLayerNorm: atol 1e-6;
  * teacher-forced log-probs under the causal and the padding mask, and
    ``decode_step_kv`` against ``decode_step``: atol 1e-5;
  * greedy (KV-cached and uncached) and beam decodes (widths 1 and 3,
    with ``min_len`` and ``length_penalty`` != 1): tokens equal by the tie
    rule (a row may differ only where the reference side's top-2 logit
    margin at the first differing step is below 1e-4), beam scores within
    1e-5;
  * ``nearest_proposal_token``: exact, ties included;
  * ``compute_cap_loss`` / ``compute_mlm_loss`` and ``cap_acc``: atol
    1e-6, their gradients within 1e-5 of ``jax.vjp``'s;
  * ``mask_caption_tokens``: a seeded generator repeats its draw, PAD and
    CLS are never masked, and over 10^5 tokens the rate is 10% and the
    split 80/10/10 (within 1.5 points).

The slice as a whole: a flax JointNet at ``tiny_config(no_caption=False)``
(and with ``use_mlm``) with random BatchNorm statistics, converted into
the port's JointNet, one training forward + loss + backward on both sides
from the same seeded batch, dropout off on both sides and the token masks
of both injected (``mask_caption_tokens`` patched in each package's
jointnet module to the same numpy draws): every scalar metric within atol
1e-4 / rtol 1e-4 (test_torch_train.py's), the gradients of every
``caption.*`` / ``mlm.*`` parameter within 1e-4 of the tensor's largest
entry. The converter round trip loads strictly, also a dict from
``export_jointnet_state_dict`` with the dead early-guide keys.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlp3d.models.jointnet as jax_jointnet_mod
import vlp3d_torch.models.jointnet as port_jointnet_mod
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.losses.captioning import compute_cap_loss as jax_cap_loss
from vlp3d.losses.captioning import compute_mlm_loss as jax_mlm_loss
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d.models import caption as jcap
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.models.layers import RefLayerNorm as JaxRefLayerNorm
from vlp3d.models.torch_export import export_jointnet_state_dict
from vlp3d.train.optimizer import label_params as jax_label_params
from vlp3d_torch.convert import convert_caption, jax_to_torch_state_dict, \
    to_tensors
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.losses.captioning import compute_cap_loss, compute_mlm_loss
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.models import JointNet
from vlp3d_torch.models import caption as pcap
from vlp3d_torch.models.layers import Dropout, RefLayerNorm
from vlp3d_torch.train.optimizer import label_params
from vlp3d_torch.train.state import batch_to_device

VOCAB, LAYERS, D, HEADS, DFF = 97, 2, 32, 4, 64
N_PROPOSALS, MAX_LEN = 6, 9
START, EOS = 1, 2  # CLS / SEP lie outside a 97-word vocabulary
TIE_MARGIN = 1e-4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ decoder


def _perturb(tree, rng):
    """Random biases and norm parameters: flax initialises them to 0 / 1."""
    def leaf(path, a):
        a = np.array(a)
        name = path[-1].key
        if name == "bias":
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name == "scale":
            return (a + rng.normal(0, 0.2, a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def decoders():
    """(JAX decoder def, its variables, the port's decoder)."""
    dec = jcap.CaptionDecoder(vocab_size=VOCAB, n_layers=LAYERS, d_model=D,
                              d_ff=DFF, heads=HEADS, max_len=MAX_LEN + 2)
    obj = jnp.zeros((2, 1, D))
    toks = jnp.ones((2, MAX_LEN + 1), jnp.int32)
    params = dec.init(jax.random.key(0), obj, toks,
                      jcap.causal_caption_mask(toks))["params"]
    params = _perturb(jax.device_get(params), np.random.default_rng(0))
    sd = {}
    convert_caption(params, "", sd)
    port = pcap.CaptionDecoder(VOCAB, LAYERS, D, DFF, HEADS, device="cpu")
    port.load_state_dict(to_tensors(sd), strict=True)
    port.eval()
    return dec, {"params": params}, port


def _obj_tokens(seed, n=N_PROPOSALS):
    return np.random.default_rng(seed).normal(0, 1, (n, 1, D)).astype(
        np.float32)


def _tokens(seed, n, t, pad_from=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, (n, t)).astype(np.int32)
    for r in range(n):  # ragged sentences: PAD after a random length
        ids[r, rng.integers(2, t + 1):] = 0
    return ids


def test_ref_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, 5, D)).astype(np.float32)
    params = {"scale": rng.normal(1, 0.3, D).astype(np.float32),
              "bias": rng.normal(0, 0.3, D).astype(np.float32)}
    want = JaxRefLayerNorm().apply({"params": params}, x)
    ln = RefLayerNorm(D, device="cpu")
    with torch.no_grad():
        ln.a_2.copy_(torch.from_numpy(params["scale"]))
        ln.b_2.copy_(torch.from_numpy(params["bias"]))
    got = ln(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    # it is not torch.nn.LayerNorm: the std is Bessel-corrected, eps on it
    plain = torch.nn.functional.layer_norm(torch.from_numpy(x), (D,))
    assert not np.allclose(plain.numpy(), (got - params["bias"])
                           / params["scale"], atol=1e-3)


@pytest.mark.parametrize("mask", ["causal", "padding"])
def test_teacher_forced_log_probs_match_jax(decoders, mask):
    dec, variables, port = decoders
    obj = _obj_tokens(2)
    toks = _tokens(3, N_PROPOSALS, MAX_LEN)
    jmask = getattr(jcap, f"{mask}_caption_mask")(jnp.asarray(toks))
    want = dec.apply(variables, obj, toks, jmask)
    t = torch.from_numpy(toks)
    pmask = getattr(pcap, f"{mask}_caption_mask")(t)
    assert tuple(pmask.shape) == tuple(jmask.shape)
    assert np.array_equal(pmask.numpy(), np.asarray(jmask))
    with torch.no_grad():
        got = port(torch.from_numpy(obj), t, pmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_decode_step_kv_equals_decode_step(decoders):
    """Each cached row against the uncached row of the port and of JAX,
    on a fixed token buffer."""
    dec, variables, port = decoders
    obj = torch.from_numpy(_obj_tokens(4))
    ys = torch.from_numpy(_tokens(5, N_PROPOSALS, MAX_LEN + 2)).long()
    ys[:, 0] = START
    n, t = ys.shape
    kc, vc = port.new_caches(n, t, obj)
    cols = torch.arange(t)[None, :]
    with torch.no_grad():
        port.decode_step_kv(obj, 0, (cols == 0).expand(n, t), kc, vc)
        for i in range(t - 1):
            x = port.embed_row(ys[:, i:i + 1], i)
            cached = port.decode_step_kv(x, i + 1, pcap._keep(ys, cols, i),
                                         kc, vc)
            full = port.decode_step(obj, ys, i)
            want = dec.apply(variables, obj.numpy(), ys.numpy(), i,
                             method=jcap.CaptionDecoder.decode_step)
            np.testing.assert_allclose(cached.numpy(), full.numpy(),
                                       atol=1e-5, rtol=0, err_msg=f"row {i}")
            np.testing.assert_allclose(cached.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0, err_msg=f"row {i}")


def assert_tie_rule(ref, got, ref_logits) -> int:
    """Rows of ``got`` equal ``ref``'s, or excused: at the first differing
    step s the reference side's top-2 logit margin (``ref_logits(row, s)``
    -> the logits that chose ref[row, s]) is below TIE_MARGIN. Returns
    the count of excused rows."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    excused = 0
    for r in np.flatnonzero((ref != got).any(axis=1)):
        s = int(np.flatnonzero(ref[r] != got[r])[0])
        top2 = np.sort(np.asarray(ref_logits(r, s)))[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN, (r, s, ref[r], got[r])
        excused += 1
    return excused


def _jax_step_logits(dec, variables, obj, ys):
    def logits(r, s):
        return dec.apply(variables, obj[r:r + 1], ys[r:r + 1], s - 1,
                         method=jcap.CaptionDecoder.decode_step)[0]
    return logits


def _cut_at(ys, eos):
    """Each row up to and including its first ``eos``."""
    out = []
    for row in np.asarray(ys).tolist():
        out.append(row[:row.index(eos) + 1] if eos in row else row)
    return out


def test_greedy_decodes_match_jax(decoders):
    dec, variables, port = decoders
    obj = _obj_tokens(6, n=32)
    want = np.asarray(jcap.greedy_decode(dec, variables, obj, MAX_LEN,
                                         start_id=START))
    want_unc = np.asarray(jcap.greedy_decode_uncached(
        dec, variables, obj, MAX_LEN, start_id=START))
    t = torch.from_numpy(obj)
    got = pcap.greedy_decode(port, t, MAX_LEN, start_id=START).numpy()
    got_unc = pcap.greedy_decode_uncached(port, t, MAX_LEN,
                                          start_id=START).numpy()
    assert got.shape == (32, MAX_LEN + 2) and (got[:, 0] == START).all()
    ref = _jax_step_logits(dec, variables, obj, want)
    assert_tie_rule(want, got, ref)
    assert_tie_rule(want_unc, got_unc,
                    _jax_step_logits(dec, variables, obj, want_unc))
    # the cached decode against the port's own uncached oracle
    assert_tie_rule(got_unc, got, lambda r, s: port.decode_step(
        t[r:r + 1], torch.from_numpy(got_unc[r:r + 1]), s - 1)[0].numpy())


@pytest.mark.parametrize("num_beams,min_len,length_penalty",
                         [(1, 0, 1.0), (3, 0, 1.0), (3, 4, 0.6)])
def test_beam_decode_matches_jax(decoders, num_beams, min_len,
                                 length_penalty):
    dec, variables, port = decoders
    obj = _obj_tokens(7, n=16)
    kw = dict(eos_id=EOS, length_penalty=length_penalty, min_len=min_len,
              start_id=START)
    want, wscore = jax.device_get(jcap.beam_decode(
        dec, variables, obj, MAX_LEN, num_beams, **kw))
    got, score = pcap.beam_decode(port, torch.from_numpy(obj), MAX_LEN,
                                  num_beams, **kw)
    got, score = got.numpy(), score.numpy()
    # a beam's ranking has no single logit row to excuse: equal tokens
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(score, wscore, atol=1e-5, rtol=0)
    if min_len:  # no hypothesis ends before min_len generated tokens
        for row in got.tolist():
            if EOS in row:
                assert row.index(EOS) >= min_len
    if num_beams == 1:  # greedy up to and including the first EOS
        greedy = pcap.greedy_decode(port, torch.from_numpy(obj), MAX_LEN,
                                    start_id=START).numpy()
        assert _cut_at(got, EOS) == _cut_at(greedy, EOS)


def test_decoder_gradients_match_jax(decoders):
    """The caption loss of the teacher-forced decoder, differentiated on
    both sides from the same inputs: every parameter's gradient and the
    object tokens' within 1e-4 of the tensor's largest entry (the key
    projection's bias, zero in exact arithmetic, below 1e-7 on both)."""
    dec, variables, port = decoders
    b, l = 2, 3
    ids = _tokens(10, b * l, MAX_LEN + 1).reshape(b, l, -1)
    ids[..., 0] = START
    seq = ids.reshape(b * l, -1)[:, :-1]
    obj = _obj_tokens(11, n=b * l)
    good = np.array([True, True, False, True, True, True])

    def jloss(p, o):
        logp = dec.apply({"params": p}, o, seq,
                         jcap.causal_caption_mask(jnp.asarray(seq)))
        return jax_cap_loss(logp[:, 1:], ids, good)[0]

    jgrad, jgrad_obj = jax.device_get(jax.grad(jloss, argnums=(0, 1))(
        variables["params"], obj))
    want = {}
    convert_caption(jgrad, "", want)
    o = torch.from_numpy(obj).requires_grad_(True)
    t = torch.from_numpy(seq)
    port.zero_grad()
    loss = compute_cap_loss(port(o, t, pcap.causal_caption_mask(t))[:, 1:],
                            torch.from_numpy(ids), torch.from_numpy(good))[0]
    np.testing.assert_allclose(loss.item(), float(jloss(variables["params"],
                                                        obj)), atol=1e-5)
    loss.backward()
    grads = dict(port.named_parameters())
    grads = {k: v.grad.numpy() for k, v in grads.items()}
    grads["obj"], want["obj"] = o.grad.numpy(), jgrad_obj
    for name, g in grads.items():
        w = want[name]
        scale = float(np.abs(w).max())
        if scale < 1e-7:
            assert float(np.abs(g).max()) < 1e-7, name
            continue
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, name


def test_top_k_first_breaks_ties_by_the_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 5.0]])
    vals, idx = pcap.top_k_first(x, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert idx.tolist() == [[1, 2, 4], [4, 0, 1]]


def test_nearest_proposal_token_matches_jax():
    rng = np.random.default_rng(8)
    b, k, c, l = 3, 7, 5, 4
    feats = rng.normal(size=(b, k, c)).astype(np.float32)
    xyz = rng.integers(0, 3, (b, k, 3)).astype(np.float32)
    xyz[:, 4] = xyz[:, 1]  # two proposals at one centre: a tie
    ref = xyz[:, [1, 4, 2, 0]] + np.float32(0.25)
    ref[:, 3] = rng.normal(size=(b, 3))
    want = jax.device_get(jcap.nearest_proposal_token(feats, xyz, ref, l))
    got = pcap.nearest_proposal_token(*(torch.from_numpy(a)
                                        for a in (feats, xyz, ref)))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert (got[1].reshape(b, l)[:, :2] == 1).all()  # the lowest index


# ------------------------------------------------------------------ losses


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    b, l, t, v = 2, 3, 8, 50
    logits = rng.normal(0, 2, (b * l, t - 1, v)).astype(np.float32)
    lang = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    ids = _tokens(seed, b * l, t).reshape(b, l, t) % v
    ids[..., 0] = 1
    good = rng.uniform(size=b * l) < 0.7
    good[0] = True
    mask_index = rng.uniform(size=(b * l, t - 1)) < 0.4
    return lang, ids, good, mask_index


@pytest.mark.parametrize("seed", [0, 1])
def test_caption_losses_match_jax(seed):
    lang, ids, good, mask_index = _loss_inputs(seed)
    (jcap_l, jacc), jvjp = jax.vjp(
        lambda x: jax_cap_loss(x, ids, good), jnp.asarray(lang))
    jmlm, jvjp_mlm = jax.vjp(
        lambda x: jax_mlm_loss(x, ids, mask_index, good), jnp.asarray(lang))
    x = torch.from_numpy(lang.copy()).requires_grad_(True)
    cap_l, acc = compute_cap_loss(x, torch.from_numpy(ids),
                                  torch.from_numpy(good))
    (g_cap,) = torch.autograd.grad(cap_l, x)
    mlm = compute_mlm_loss(x, torch.from_numpy(ids),
                           torch.from_numpy(mask_index),
                           torch.from_numpy(good))
    (g_mlm,) = torch.autograd.grad(mlm, x)
    for got, want in ((cap_l, jcap_l), (acc, jacc), (mlm, jmlm)):
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6,
                                   rtol=0)
    assert cap_l.item() > 0 and mlm.item() > 0
    np.testing.assert_allclose(g_cap.numpy(), np.asarray(jvjp(
        (jnp.float32(1.0), jnp.float32(0.0)))[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_mlm.numpy(), np.asarray(
        jvjp_mlm(jnp.float32(1.0))[0]), atol=1e-5, rtol=0)


def test_mask_caption_tokens_draws_and_rates():
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(rng.integers(0, 400, (1000, 100)))
    ids[:, 0] = pcap.CLS_ID
    ids[:, 80:] = pcap.PAD_ID
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    out, masked = pcap.mask_caption_tokens(ids, 400, generator=g1)
    out2, masked2 = pcap.mask_caption_tokens(ids, 400, generator=g2)
    assert torch.equal(out, out2) and torch.equal(masked, masked2)
    out3, _ = pcap.mask_caption_tokens(ids, 400, generator=g1)
    assert not torch.equal(out, out3)  # the generator moved on
    assert not masked[:, 0].any() and not masked[:, 80:].any()
    assert torch.equal(out[~masked], ids[~masked])
    eligible = (ids != pcap.PAD_ID) & (ids != pcap.CLS_ID)
    n = int(masked.sum())
    assert abs(n / int(eligible.sum()) - 0.1) < 0.015
    to_mask = (out == pcap.MASK_ID) & masked
    kept = (out == ids) & masked
    randomised = masked & ~to_mask & ~kept
    # a random word may draw its own id: count it with the kept ones
    assert abs(int(to_mask.sum()) / n - 0.8) < 0.015
    assert abs(int(kept.sum()) / n - 0.1) < 0.015
    assert abs(int(randomised.sum()) / n - 0.1) < 0.015
    assert int(out.max()) < 400 and out.dtype == ids.dtype


# ------------------------------------------------------- the slice as a whole


def _draws(shape, vocab):
    """Seeded numpy draws of one mask call, by shape."""
    rng = np.random.default_rng(1000 * shape[0] + shape[1])
    u = rng.uniform(size=(3,) + tuple(shape)).astype(np.float32)
    return u, rng.integers(0, vocab, shape)


def _jax_injected(rng, input_ids, vocab_size, mask_ratio=0.1):
    """JAX's mask_caption_tokens on the test's draws (a 40% rate, so that
    the MLM loss of a small batch is live)."""
    u, words = _draws(input_ids.shape, vocab_size)
    masked = (u[0] < 0.4) & (input_ids != 0) & (input_ids != 101)
    replace = (u[1] < 0.8) & masked
    randomize = (u[2] < 0.5) & masked & ~replace
    out = jnp.where(replace, 103, input_ids)
    return jnp.where(randomize, words.astype(np.int32), out), masked


def _port_injected(input_ids, vocab_size, mask_ratio=0.1, *, generator=None):
    u, words = (torch.from_numpy(a) for a in _draws(input_ids.shape,
                                                     vocab_size))
    masked = (u[0] < 0.4) & (input_ids != 0) & (input_ids != 101)
    replace = (u[1] < 0.8) & masked
    randomize = (u[2] < 0.5) & masked & ~replace
    out = torch.where(replace, 103, input_ids)
    return torch.where(randomize, words.to(input_ids.dtype), out), masked


def _heads(mlm):
    return ("caption", "mlm") if mlm else ("caption",)


def _flags(mlm):
    return dict(use_con=False, no_caption=False, use_mlm=mlm)


def _batch(mlm, seed=17):
    b = make_batch(tiny_config(**_flags(mlm)), batch_size=2, num_points=256,
                   seed=seed)
    b["random"] = np.float32(0.7)
    return b


@pytest.fixture(scope="module")
def jax_init():
    """Perturbed parameters and random BatchNorm statistics of the JAX
    JointNet with both decoders (one init serves both variants: the
    caption-only tree is this one without ``mlm``)."""
    model = JaxJointNet(jax_tiny_config(**_flags(True)))
    v = jax.device_get(jax.jit(lambda b: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "aug": jax.random.key(2)}, b, train=True))(_batch(True)))
    rng = np.random.default_rng(1)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

    params = _perturb(v["params"], np.random.default_rng(2))
    return params, jax.tree_util.tree_map_with_path(stat, v["batch_stats"])


@pytest.fixture(scope="module", params=[False, True], ids=["caption",
                                                           "caption+mlm"])
def jax_step(request, jax_init):
    """(use_mlm, params, batch_stats, JAX metrics, gradients and the
    decoders' ReLU inputs)."""
    mlm = request.param
    params, stats = jax_init
    if not mlm:
        params = {k: v for k, v in params.items() if k != "mlm"}
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)
    mp.setattr(jax_jointnet_mod, "mask_caption_tokens", _jax_injected)
    try:
        config = jax_tiny_config(**_flags(mlm))
        model = JaxJointNet(config)
        batch = _batch(mlm)

        def loss_fn(p):
            out, upd = model.apply(
                {"params": p, "batch_stats": stats}, batch, train=True,
                rngs={"dropout": jax.random.key(0), "aug": jax.random.key(0)},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: mdl.name == "ffn1")
            loss, m = jax_joint_loss(config, out, batch, caption=True)
            # each decoder layer's ReLU input (the FFN's first Dense)
            pre = {head: [upd["intermediates"][head][f"layer_{i}"]["ffn1"][
                "__call__"][0] for i in range(6)] for head in _heads(mlm)}
            return loss, ({k: v for k, v in m.items() if jnp.ndim(v) == 0},
                          pre)

        (_, (metrics, pre)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params))
    finally:
        mp.undo()
    return mlm, params, stats, metrics, grads, pre


def test_caption_train_step_matches_jax(jax_step, monkeypatch):
    """The whole step. A decoder's ReLU that falls on the other side of 0
    in the two packages (the forwards differ by ~1e-4 below the decoder,
    from the backbone's own float32 rounding; see test_torch_train.py)
    moves the gradients of its layer and of everything under it by that
    unit's share (measured up to 5e-2 of a tensor's largest entry, median
    up to 2.4e-3): a tensor there must keep its median error within 5e-3
    of its largest entry and every entry within 1e-1 of it, and each such
    ReLU input must lie within 1e-3 of 0 on both sides.
    test_decoder_gradients_match_jax holds every decoder gradient at 1e-4
    on identical inputs. Every other tensor here: every entry within 1e-4
    of its largest. A tensor whose gradient is zero in
    exact arithmetic (the key projection's bias: softmax ignores a shift
    shared by a query's scores) is rounding noise on both sides: every
    entry below 1e-7."""
    mlm, params, stats, jmetrics, jgrads, jpre = jax_step
    monkeypatch.setattr(port_jointnet_mod, "mask_caption_tokens",
                        _port_injected)
    config = tiny_config(**_flags(mlm))
    model = JointNet(config, device="cpu")
    model.load_state_dict(jax_to_torch_state_dict(params, stats),
                          strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    pre = {head: [None] * 6 for head in _heads(mlm)}
    for head in _heads(mlm):
        for i, layer in enumerate(getattr(model, head).model.decoder.layers):
            layer.feed_forward.w_1.register_forward_hook(
                lambda mod, inp, o, head=head, i=i:
                pre[head].__setitem__(i, o.detach().numpy()))
    batch = batch_to_device(_batch(mlm), "cpu")
    out = model(batch, train=True)
    loss, metrics = compute_joint_loss(config, out, batch, caption=True)
    loss.backward()

    scal = {k: v.detach() for k, v in metrics.items() if v.dim() == 0}
    assert set(scal) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(scal[k].numpy(), want, **TOL,
                                   err_msg=k)
    assert float(scal["cap_loss"]) > 0
    assert (float(scal["mlm_loss"]) > 0) if mlm else "mlm_loss" not in scal

    # the deepest layer of each decoder whose ReLUs decided differently
    flipped = {}
    for head in _heads(mlm):
        for i in range(6):
            a, b = pre[head][i], np.asarray(jpre[head][i])
            flips = (a > 0) != (b > 0)
            if flips.any():
                assert np.abs(a[flips]).max() < 1e-3
                assert np.abs(b[flips]).max() < 1e-3
                flipped[head] = i
    want = jax_to_torch_state_dict(jgrads, stats)
    checked = 0
    for name, p in model.named_parameters():
        head = name.split(".")[0]
        if head not in _heads(mlm):
            continue
        w, g = want[name].numpy(), p.grad.numpy()
        scale = float(np.abs(w).max())
        err = np.abs(g - w)
        checked += 1
        if scale < 1e-7:
            assert float(np.abs(g).max()) < 1e-7, name
            continue
        parts = name.split(".")
        under = head in flipped and (
            parts[2] == "tgt_embed"
            or (parts[3] == "layers" and int(parts[4]) <= flipped[head]))
        if under:
            assert float(np.median(err)) <= 5e-3 * scale, name
            assert float(err.max()) <= 1e-1 * scale, name
        else:
            assert float(err.max()) <= 1e-4 * scale, (name, float(err.max()),
                                                      scale)
    # per decoder: the embedding, 16 tensors a layer, the norm, the proj
    assert checked == len(_heads(mlm)) * (1 + 16 * 6 + 2 + 2)


def test_export_dict_with_dead_keys_loads_strictly(jax_step):
    """``export_jointnet_state_dict`` writes the reference's dead
    early-guide keys (zero src_attn, identity sublayer.1 norms); the
    port's loader drops them, and every other entry lands."""
    mlm, params, stats, _, _, _ = jax_step
    exported = export_jointnet_state_dict(params, stats)
    dead = [k for k in exported if ".src_attn." in k or ".sublayer.1." in k]
    assert len(dead) == (2 if mlm else 1) * 6 * 10
    model = JointNet(tiny_config(**_flags(mlm)), device="cpu")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in exported.items()}
    model.load_state_dict(sd, strict=True)
    assert set(sd) - set(model.state_dict()) == set(dead)
    converted = jax_to_torch_state_dict(params, stats)
    for k, v in model.state_dict().items():
        if k.startswith(("caption.", "mlm.")):
            np.testing.assert_array_equal(v.numpy(), converted[k].numpy(),
                                          err_msg=k)


def test_caption_head_at_module_lr_and_mlm_at_base_lr(jax_init):
    """The optimizer's groups: the caption decoder trains at module_lr
    with lang / relation / match, the MLM decoder at the base LR, in both
    packages."""
    params, _ = jax_init
    jlabels = jax_label_params(params)
    for head, want in (("caption", "module"), ("mlm", "base")):
        assert set(jax.tree_util.tree_leaves(jlabels[head])) == {want}
    labels = label_params(JointNet(tiny_config(**_flags(True)),
                                   device="cpu"))
    for head, want in (("caption", "module"), ("mlm", "base")):
        got = {v for k, v in labels.items() if k.startswith(head + ".")}
        assert got == {want}, head
