"""The legacy pretraining pieces of vlp3d_torch against the JAX package, on
the CPU: the InfoNCE loss, ``gather_negatives`` and the sharded
contrastive step over 2 and 4 gloo ranks (against JAX's shard_map step
on as many virtual CPU devices), and the cross-modal MLM head with its
loss. Stated tolerances:

  * ``compute_contrastive_loss``: the loss and its gradients with
    respect to both similarity matrices within 1e-6 (relative and
    absolute), with invalid sentences among the rows;
  * the negatives: the gathered rows bit-equal to the global batch; the
    loss (the same on every rank) and the gradients of each rank's rows
    of a and b within 1e-6 of ``jax.value_and_grad`` of the JAX step on
    the global arrays;
  * ``LangCrossMLM`` (seeded weights in the flax shapes, a 2-layer
    BERT text encoder) fed JAX's draws (the sampled sentence of each
    scene and the 80/10/10 mask, injected through the port's
    ``sample_sentences`` and ``mask_caption_tokens``): the drawn ids and
    the mask equal, the logits within 1e-4; ``cross_mlm_loss`` and its
    gradient with respect to the logits within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks
from torch_task_steps import seeded_variables
from vlp3d.losses.pretrain import compute_contrastive_loss as jax_infonce
from vlp3d.models.bert import BertConfig as JaxBertConfig
from vlp3d.models.bert import LangCrossMLM as JaxCrossMLM
from vlp3d.models.bert import cross_mlm_loss as jax_cross_mlm_loss
from vlp3d.models.caption import mask_caption_tokens as jax_mask_tokens
from vlp3d.parallel.collectives import (
    make_sharded_contrastive_step as jax_sharded_step,
)
from vlp3d.parallel.mesh import DATA_AXIS, make_mesh
from vlp3d_torch import convert
from vlp3d_torch.losses.pretrain import compute_contrastive_loss
from vlp3d_torch.models import bert as port_bert
from vlp3d_torch.models.bert import BertConfig, LangCrossMLM, cross_mlm_loss
from vlp3d_torch.parallel.collectives import (
    gather_negatives,
    make_sharded_contrastive_step,
)
from vlp3d_torch.parallel.reduce import LOCAL

TAU = 0.5  # tests/torch_parallel_jobs.py's info_nce
BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, fusion_layer=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_infonce_matches_jax_with_invalid_sentences():
    rng = np.random.default_rng(0)
    b, lmax, k = 3, 4, 10
    l = b * lmax
    sim_l2p = rng.normal(size=(l, k)).astype(np.float32)
    sim_p2l = rng.normal(size=(k, l)).astype(np.float32)
    labels = rng.integers(0, k, l).astype(np.int32)
    labels[:3] = labels[3]  # sentences sharing their positive
    mask = (rng.uniform(size=(b, lmax)) > 0.3).astype(np.float32)
    mask[0] = 0.0  # a scene without a valid sentence
    want, (gw1, gw2) = jax.value_and_grad(jax_infonce, argnums=(0, 1))(
        sim_l2p, sim_p2l, labels, mask)
    s1 = torch.from_numpy(sim_l2p).requires_grad_()
    s2 = torch.from_numpy(sim_p2l).requires_grad_()
    got = compute_contrastive_loss(s1, s2, torch.from_numpy(labels),
                                   torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s1.grad.numpy(), np.asarray(gw1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(s2.grad.numpy(), np.asarray(gw2), rtol=1e-6,
                               atol=1e-6)


def test_gather_and_step_of_one_process_are_the_identity_and_the_loss():
    a = torch.randn(4, 8, requires_grad=True)
    b = torch.randn(4, 8)
    assert gather_negatives(b, LOCAL) is b
    loss = make_sharded_contrastive_step(
        lambda x, y: (x @ y.T).logsumexp(-1).mean(), LOCAL)(a, b)
    torch.testing.assert_close(loss, (a @ b.T).logsumexp(-1).mean())


@pytest.mark.parametrize("world", [2, 4])
def test_negatives_over_ranks_match_jax(world, tmp_path):
    rng = np.random.default_rng(world)
    a = rng.normal(size=(8, 16)).astype(np.float32)
    b = rng.normal(size=(8, 16)).astype(np.float32)
    np.savez(tmp_path / "ab.npz", a=a, b=b)
    res = run_ranks("negatives", {"npz": str(tmp_path / "ab.npz")}, tmp_path,
                    world=world)

    def info_nce(x, y_all):
        n = x.shape[0]
        offset = jax.lax.axis_index(DATA_AXIS) * n
        logp = jax.nn.log_softmax(x @ y_all.T / TAU, axis=-1)
        return -jnp.mean(logp[jnp.arange(n), offset + jnp.arange(n)])

    step = jax_sharded_step(make_mesh(world), info_nce)
    loss, (ga, gb) = jax.jit(jax.value_and_grad(step, argnums=(0, 1)))(a, b)
    n = 8 // world
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["gathered"], b)
        np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-6,
                                   atol=1e-6)
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(out["grad_a"], np.asarray(ga)[rows],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["grad_b"], np.asarray(gb)[rows],
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mlm_side():
    rng = np.random.default_rng(5)
    b, l, t, k = 3, 4, 10, 12
    ids = rng.integers(5, BERT["vocab_size"], (b, l, t)).astype(np.int32)
    ids[:, :, 0] = 101  # CLS, never masked
    am = np.ones((b, l, t), np.int32)
    for i, j, n in ((0, 1, 6), (1, 3, 3), (2, 0, 8)):
        ids[i, j, n:] = 0
        am[i, j, n:] = 0
    feats = rng.normal(size=(b, k, 32)).astype(np.float32)
    labels = rng.integers(0, k, (b, l)).astype(np.int32)
    mod = JaxCrossMLM(hidden_size=32, bert_config=JaxBertConfig(**BERT))
    key = jax.random.key(5)  # a draw that masks 7 tokens
    shapes = jax.eval_shape(lambda *x: mod.init(
        {"params": jax.random.key(0)}, key, *x), ids, am, feats, labels)
    params, _ = seeded_variables({"params": shapes["params"],
                                  "batch_stats": {}}, seed=6)
    logits, tokens, masked = jax.device_get(jax.jit(
        lambda p, *x: mod.apply({"params": p}, key, *x))(
            params, ids, am, feats, labels))
    # JAX's draws, as LangCrossMLM makes them
    r_sample, r_mask = jax.random.split(key)
    sample = np.asarray(jax.random.randint(r_sample, (b,), 0, b * l))
    mlm_ids, mask = jax_mask_tokens(r_mask, jnp.asarray(tokens),
                                    BERT["vocab_size"], 0.15)
    return dict(params=params, ids=ids, am=am, feats=feats, labels=labels,
                logits=np.asarray(logits), tokens=np.asarray(tokens),
                masked=np.asarray(masked), sample=sample,
                mlm_ids=np.asarray(mlm_ids), mask=np.asarray(mask))


def test_lang_cross_mlm_under_jax_draws_matches_jax(mlm_side, monkeypatch):
    s = mlm_side
    np.testing.assert_array_equal(s["mask"], s["masked"])
    assert s["masked"].any()
    model = LangCrossMLM(hidden_size=32, bert_config=BertConfig(**BERT),
                         device="cpu")
    model.load_state_dict(convert.lang_cross_mlm_to_torch_state_dict(
        s["params"]), strict=True)
    seen = {}

    def sample_sentences(b, n, generator, device):
        seen["draw"] = (b, n)
        return torch.from_numpy(s["sample"]).long()

    def mask_tokens(tokens, vocab, ratio, *, generator=None):
        seen["mask"] = (tokens.clone(), vocab, ratio)
        return (torch.from_numpy(s["mlm_ids"]).long(),
                torch.from_numpy(s["mask"]))

    monkeypatch.setattr(port_bert, "sample_sentences", sample_sentences)
    monkeypatch.setattr(port_bert, "mask_caption_tokens", mask_tokens)
    logits, tokens, masked = model(*(torch.from_numpy(s[k]) for k in (
        "ids", "am", "feats", "labels")))
    assert seen["draw"] == (3, 12)
    np.testing.assert_array_equal(seen["mask"][0].numpy(), s["tokens"])
    assert seen["mask"][1:] == (BERT["vocab_size"], 0.15)
    np.testing.assert_array_equal(tokens.numpy(), s["tokens"])
    np.testing.assert_array_equal(masked.numpy(), s["masked"])
    np.testing.assert_allclose(logits.detach().numpy(), s["logits"],
                               rtol=1e-4, atol=1e-4)

    want, wgrad = jax.value_and_grad(jax_cross_mlm_loss)(
        s["logits"], s["tokens"], s["masked"])
    lg = torch.from_numpy(s["logits"]).requires_grad_()
    got = cross_mlm_loss(lg, torch.from_numpy(s["tokens"]),
                         torch.from_numpy(s["masked"]))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(wgrad), rtol=1e-6,
                               atol=1e-6)


def test_lang_cross_mlm_draws_from_its_generator(mlm_side):
    s = mlm_side
    model = LangCrossMLM(hidden_size=32, bert_config=BertConfig(**BERT),
                         device="cpu")
    args = [torch.from_numpy(s[k]) for k in ("ids", "am", "feats", "labels")]
    runs = [model(*args, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    ids = args[0].reshape(-1, args[0].shape[-1])
    assert any(bool((ids == row).all(-1).any()) for row in runs[0][1])
    other = model(*args, generator=torch.Generator().manual_seed(4))
    assert not all(torch.equal(x, y) for x, y in zip(runs[0], other))
    assert bool(((runs[0][1] == 0) | (runs[0][1] == 101))[runs[0][2]].sum()
                == 0)  # pad and CLS are never masked
