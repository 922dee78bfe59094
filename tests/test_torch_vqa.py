"""The ScanQA modules of vlp3d_torch against the JAX package, on the CPU:
the answer head, the answer loss and EM, the answer normalization, the
ScanQA data path, the converted weights and ``AnswerPredictor``.

Stated tolerances:

  * ``AttFlat`` (16 and run.sh's 256 proposals) and ``AnswerModule``
    under flax weights through ``vlp3d_torch.convert``: within 1e-5;
  * the answer loss, both branches (BCE on soft labels, cross-entropy on
    indices): within 1e-6 relative, its gradient within 1e-6 of the
    largest entry;
  * the means of ``answer_hits`` against JAX ``answer_accuracy`` on
    integer-valued logits full of ties, and each row's top-k against
    ``lax.top_k``: equal;
  * the answer normalization, ``build_answer_vocab``, ``synthetic_qa``,
    the ScanQA stand-in writer and every ``ScanQADataset`` batch of a
    ``BatchIterator`` (synthetic and stand-in questions, padded question
    slots, with and without ``use_unanswerable``): equal, bit for bit;
  * ``JointNet(use_answer=True)`` at ``is_eval``: ``answer_scores``
    within 1e-4 (the grounding forward's tolerance); ``AnswerPredictor``:
    top-10 ids equal and their logits within 1e-5, through ``__call__``
    and ``run_padded``;
  * a reference-layout ``export_jointnet_state_dict`` dict with the
    answer head loads with ``strict=True``, its answer entries equal to
    ``jax_to_torch_state_dict``'s;
  * ``python -m vlp3d_torch.cli.train_qa --synthetic --smoke --device
    cpu --pretrain`` from a grounding snapshot, in process: every entry
    restored but the answer head's 10 (the rest of the CLI is
    tests/test_torch_train_qa.py's).

``HashTokenizer``'s ids come from Python's salted ``hash``, so batches are
compared within this process only. Dropout is the identity at
evaluation on both sides.
"""

import collections
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlp3d.data.answer_norm as jax_norm
import vlp3d.data.dataset as jax_dataset
import vlp3d.data.standins as jax_standins
import vlp3d.data.synthetic as jax_synthetic
from vlp3d.cli.train_scanqa import _synthetic_qa as jax_synthetic_qa
from vlp3d.data.tokenizer import HashTokenizer as JaxHashTokenizer
from vlp3d.data.vqa_dataset import ScanQADataset as JaxScanQADataset
from vlp3d.data.vqa_dataset import build_answer_vocab as jax_build_vocab
from vlp3d.eval.vqa import answer_accuracy as jax_answer_accuracy
from vlp3d.losses.answering import (
    compute_answer_classification_loss as jax_answer_loss,
)
from vlp3d.models.answer import AnswerModule as JaxAnswerModule
from vlp3d.models.answer import AttFlat as JaxAttFlat
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.models.torch_export import export_jointnet_state_dict
from vlp3d.serving import AnswerPredictor as JaxAnswerPredictor
import vlp3d_torch.data.answer_norm as port_norm
import vlp3d_torch.data.dataset as port_dataset
import vlp3d_torch.data.standins as port_standins
import vlp3d_torch.data.synthetic as port_synthetic
from vlp3d_torch.cli import train_qa
from vlp3d_torch.convert import (
    convert_answer,
    convert_attflat,
    jax_to_torch_state_dict,
    to_tensors,
)
from vlp3d_torch.data.tokenizer import HashTokenizer
from vlp3d_torch.data.vqa_dataset import ScanQADataset, build_answer_vocab
from vlp3d_torch.eval.vqa import answer_hits
from vlp3d_torch.losses.answering import compute_answer_classification_loss
from vlp3d_torch.models import JointNet
from vlp3d_torch.models.answer import AnswerModule, AttFlat
from vlp3d_torch.models.caption import top_k_first
from vlp3d_torch.serving import STREAM_KEYS, AnswerPredictor
from vlp3d_torch.train import checkpoint as ckpt

NUM_ANSWERS = 37
BATCH = 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the head


def _init(module, x):
    return jax.device_get(module.init(jax.random.key(3), x)["params"])


@pytest.mark.parametrize("rows,proposals", [(6, 16), (2, 256)])
def test_attflat_matches_jax(rows, proposals):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(rows, proposals, 128)).astype(np.float32)
    jmod = JaxAttFlat(128)
    params = _init(jmod, x)
    want = np.asarray(jmod.apply({"params": params}, x))
    sd = {}
    convert_attflat(params, "", sd)
    port = AttFlat(device="cpu")
    port.eval()  # flax's default: no dropout
    port.load_state_dict(to_tensors(sd), strict=True)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_answer_module_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 16, 128)).astype(np.float32)
    jmod = JaxAnswerModule(num_answers=NUM_ANSWERS)
    params = _init(jmod, x)
    want = np.asarray(jmod.apply({"params": params}, x))
    sd = {}
    convert_answer(params, "", sd)
    port = AnswerModule(NUM_ANSWERS, device="cpu")
    port.eval()
    port.load_state_dict(to_tensors(sd), strict=True)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (8, NUM_ANSWERS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the tanh-approximated GELU: exact GELU would move the logits
    exact = port.answer_cls[3](torch.nn.functional.gelu(
        port.answer_cls[0](port.attflat_visual(torch.from_numpy(x)))))
    assert np.abs(exact.detach().numpy() - want).max() > 1e-5


@pytest.mark.parametrize("branch", ["bce", "ce"])
def test_answer_loss_matches_jax(branch):
    rng = np.random.default_rng(2)
    n, a = 24, NUM_ANSWERS
    x = (3 * rng.normal(size=(n, a))).astype(np.float32)
    cats = (rng.random((n, a)) < 0.1).astype(np.float32)
    soft = (cats * rng.choice([0.3, 0.6, 0.9, 1.0], (n, a))).astype(
        np.float32)
    idx = rng.integers(0, a, n).astype(np.int32)
    if branch == "bce":
        def jfn(v):
            return jax_answer_loss(v, answer_cat_scores=jnp.asarray(soft))

        def pfn(v):
            return compute_answer_classification_loss(
                v, answer_cat_scores=torch.from_numpy(soft))
    else:
        def jfn(v):
            return jax_answer_loss(v, answer_cat=jnp.asarray(idx))

        def pfn(v):
            return compute_answer_classification_loss(
                v, answer_cat=torch.from_numpy(idx))
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pfn(xt)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    g, wg = xt.grad.numpy(), np.asarray(want_g)
    assert np.abs(g - wg).max() <= 1e-6 * np.abs(wg).max()


def test_answer_accuracy_matches_jax_on_ties():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 4, size=(40, 23)).astype(np.float32)
    cats = (rng.random((40, 23)) < 0.15).astype(np.float32)
    for k in (1, 5, 10):
        _, want_idx = jax.lax.top_k(jnp.asarray(scores), k)
        _, idx = top_k_first(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        acc1, acck = jax_answer_accuracy(jnp.asarray(scores),
                                         jnp.asarray(cats), topk=k)
        hit1, hitk = answer_hits(torch.from_numpy(scores),
                                 torch.from_numpy(cats), topk=k)
        got1, gotk = hit1.float().mean(), hitk.float().mean()
        # the hits equal; the two means round their sums' last bit apart
        for got, want in ((got1, acc1), (gotk, acck)):
            assert round(float(got) * 40) == round(float(want) * 40)
            assert float(got) == pytest.approx(float(want), rel=1e-6)
    hit1, hit10 = answer_hits(torch.from_numpy(scores),
                              torch.from_numpy(cats))
    assert hit1.dtype == torch.bool and hit1.shape == (40,)
    assert bool((hit10 | ~hit1).all())  # a top-1 hit is a top-10 hit


# ------------------------------------------------- answers and vocabulary

RAW_ANSWERS = [
    "Two", "two.", "the brown chair", "A chair, next to the table",
    "10,000", "it's black", "isnt it", "3.5 feet", "ten", "none",
    "(white)", "left-side", "yes!", "", "an", "dont know", "1,2,3",
    "the end.", "o'clock", "whats up; she's here", "a/b", "Im here",
]


def test_answer_norm_matches_jax():
    for a in RAW_ANSWERS:
        assert port_norm.prep_ans(a) == jax_norm.prep_ans(a), a
    counter = collections.Counter(RAW_ANSWERS * 2 + RAW_ANSWERS[:5])
    assert (port_norm.normalize_answer_counter(counter)
            == jax_norm.normalize_answer_counter(counter))
    records = [{"answers": RAW_ANSWERS[i:i + 3]} for i in range(0, 22, 3)]
    records.append({"answers": ["", "the", "a"]})  # all normalize away
    want = jax_norm.normalize_answers_in_qa_data(
        [dict(r) for r in records])
    got = port_norm.normalize_answers_in_qa_data(
        [dict(r) for r in records])
    assert got == want and len(got) == len(records) - 1


@pytest.mark.parametrize("min_count,max_size", [(1, -1), (2, -1), (1, 3),
                                                (2, 4)])
def test_build_answer_vocab_matches_jax(min_count, max_size):
    rng = np.random.default_rng(4)
    words = ["red", "blue", "two", "wood", "left", "chair", "3"]
    qa = [{"answers": list(rng.choice(words, rng.integers(0, 3)))}
          for _ in range(30)]
    got = build_answer_vocab(qa, min_count=min_count, max_size=max_size)
    assert got == jax_build_vocab(qa, min_count=min_count, max_size=max_size)
    vocab, kept = got
    assert list(vocab) == sorted(kept) and list(vocab.values()) == list(
        range(len(vocab)))


# ------------------------------------------------------------ the data


def test_synthetic_qa_matches_jax():
    jqa, jsource, _ = jax_synthetic_qa(jax_synthetic.tiny_config())
    qa, source = port_synthetic.synthetic_qa(port_synthetic.tiny_config())
    assert qa == jqa
    assert set(source.scenes) == set(jsource.scenes)
    for sid, scene in jsource.scenes.items():
        for k, v in scene.items():
            np.testing.assert_array_equal(source.scenes[sid][k], v)


def test_port_writes_the_same_scanqa_standin(tmp_path):
    want = jax_standins.write_standin_assets(str(tmp_path / "jax"))
    got = port_standins.write_standin_assets(str(tmp_path / "port"))
    name = "ScanQA_v1.0_val.json"
    with open(os.path.join(got["scanqa_dir"], name)) as f, \
            open(os.path.join(want["scanqa_dir"], name)) as g:
        assert json.load(f) == json.load(g)


def _synthetic(module, tokenizer, **kw):
    synth = {jax_dataset: jax_synthetic, port_dataset: port_synthetic}[module]
    config = synth.tiny_config()
    if module is jax_dataset:
        qa, source, _ = jax_synthetic_qa(config)
    else:
        qa, source = port_synthetic.synthetic_qa(config)
    return qa, source, dict(num_points=config.dataset.num_points,
                            bert_max_len=config.model.bert_seq_len,
                            mean_size_arr=config.dataset.mean_size_arr())


def _standin(module, tokenizer, root):
    source = module.DirectorySceneSource(root["scannet_data"])
    with open(os.path.join(root["scanqa_dir"], "ScanQA_v1.0_val.json")) as f:
        qa = json.load(f)
    return qa, source, dict(num_points=1000, bert_max_len=12)


@pytest.fixture(scope="module")
def standin_root(tmp_path_factory):
    return jax_standins.write_standin_assets(
        str(tmp_path_factory.mktemp("vqa_standins")))


# source -> (lang_num_max without and with use_unanswerable, vocabulary
# cut; the stand-ins hold a val split only): the cut to 2 answers leaves
# 2 of a synthetic scene's 4 questions and 2 of the stand-in's 3
# answerable; the chunk sizes leave padded slots either way
CASES = {"synthetic": ((3, 3), 2), "standin": ((3, 2), 2)}


@pytest.mark.parametrize("use_unanswerable", [False, True])
@pytest.mark.parametrize("where,split", [("synthetic", "train"),
                                         ("synthetic", "val"),
                                         ("standin", "val")])
def test_scanqa_batches_equal_bit_for_bit(where, split, use_unanswerable,
                                          standin_root):
    sizes, max_size = CASES[where]
    lang_num_max = sizes[use_unanswerable]
    batches = {}
    for module, ds_cls, tok_cls, build in (
            (jax_dataset, JaxScanQADataset, JaxHashTokenizer,
             jax_build_vocab),
            (port_dataset, ScanQADataset, HashTokenizer,
             build_answer_vocab)):
        tok = tok_cls()
        if where == "synthetic":
            qa, source, kw = _synthetic(module, tok)
        else:
            qa, source, kw = _standin(module, tok, standin_root)
        vocab, counter = build(qa, max_size=max_size)
        random.seed(5)  # split_scene_new's shuffle
        ds = ds_cls(qa, source, tok, split=split, answer_vocab=vocab,
                    answer_counter=counter, lang_num_max=lang_num_max,
                    use_unanswerable=use_unanswerable, seed=3,
                    augment=split == "train", shuffle=split == "train",
                    **kw)
        assert ds.all_data_size == len(qa)
        batches[module] = (ds.answerable_data_size, list(
            module.BatchIterator(ds, 2, drop_last=False,
                                 rng=np.random.default_rng(1))))
    (jn, want), (pn, got) = batches[jax_dataset], batches[port_dataset]
    assert pn == jn and (pn < len(qa)) != use_unanswerable
    assert len(got) == len(want) > 0
    padded = 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert set(g) == set(w), i
        for k, wv in w.items():
            if isinstance(wv, list):
                assert g[k] == wv, (i, k)
            else:
                wv, gv = np.asarray(wv), np.asarray(g[k])
                assert gv.dtype == wv.dtype and np.array_equal(gv, wv), (i, k)
        padded += int((lang_num_max - np.asarray(g["lang_num"])).sum())
        assert g["answer_cats"].shape[-1] == len(vocab)
    assert padded > 0


# ------------------------------------------- the model and the predictor


@pytest.fixture(scope="module")
def pair():
    """(the JAX config and variables, the port's state dict): a seeded
    fill of the JAX model's shapes (``jax.eval_shape`` of its init) with
    random BatchNorm statistics."""
    import dataclasses

    config = jax_synthetic.tiny_config(use_con=False, no_caption=True,
                                       use_answer=True)
    config = dataclasses.replace(config, model=dataclasses.replace(
        config.model, num_answers=NUM_ANSWERS))
    model = JaxJointNet(config)
    b0 = jax_synthetic.make_batch(config, batch_size=BATCH, num_points=256,
                                  istrain=0)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, train=False), b0)
    rng = np.random.default_rng(7)

    def param(path, a):
        name = path[-1].key
        if name in ("scale", "negative_slope"):
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

    v = {"params": jax.tree_util.tree_map_with_path(param, shapes["params"]),
         "batch_stats": jax.tree_util.tree_map_with_path(
             stat, shapes["batch_stats"])}
    return config, v, jax_to_torch_state_dict(v["params"], v["batch_stats"])


def _port_config():
    import dataclasses

    config = port_synthetic.tiny_config(use_con=False, no_caption=True,
                                        use_answer=True)
    return dataclasses.replace(config, model=dataclasses.replace(
        config.model, num_answers=NUM_ANSWERS))


def _scenes(seed, batch_size=BATCH):
    b = port_synthetic.make_batch(_port_config(), batch_size=batch_size,
                                  num_points=256, seed=seed, istrain=0)
    return {k: b[k] for k in STREAM_KEYS}


def test_answer_predictor_matches_jax(pair):
    config, v, sd = pair
    jax_pred = JaxAnswerPredictor(config, v, batch_size=BATCH)
    port = AnswerPredictor(_port_config(), sd, batch_size=BATCH,
                           device="cpu")
    l = config.model.lang_num_max
    batches = [_scenes(6), _scenes(7)]
    got = port(batches)
    full = batches[0]
    pairs = [(g, jax_pred([b])[0]) for g, b in zip(got, batches)]
    for k_occ in (1, 3):
        part = {k: a[:k_occ] for k, a in full.items()}
        g = port.run_padded(part)
        pairs.append((g, jax_pred.run_padded(part)))
        # padding repeats row 0
        assert (g["answer_top_ids"][k_occ:] == g["answer_top_ids"][0]).all()
    for g, want in pairs:
        assert g["answer_top_ids"].shape == (BATCH, l, 10)
        assert g["answer_scores"].shape == (BATCH, l, NUM_ANSWERS)
        np.testing.assert_allclose(
            g["answer_scores"].reshape(BATCH * l, -1),
            np.asarray(want["answer_scores"]), **TOL)
        np.testing.assert_array_equal(
            g["answer_top_ids"].reshape(BATCH * l, -1),
            np.asarray(want["answer_top_ids"]))
        np.testing.assert_allclose(
            g["answer_top_scores"].reshape(BATCH * l, -1),
            np.asarray(want["answer_top_scores"]), rtol=0, atol=1e-5)
        top = g["answer_top_scores"]
        assert (np.diff(top, axis=-1) <= 0).all()  # best first


def test_export_dict_with_the_answer_head_loads_strictly(pair):
    _, v, sd = pair
    exported = export_jointnet_state_dict(v["params"], v["batch_stats"])
    assert sum(k.startswith("answer.") for k in exported) == 10
    model = JointNet(_port_config(), device="cpu")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
        strict=True)
    for k, a in model.state_dict().items():
        if k.startswith("answer."):
            np.testing.assert_array_equal(a.numpy(), sd[k].numpy(),
                                          err_msg=k)


# ---------------------------------------------------------------- the CLI


def test_train_qa_cli_pretrain_from_a_grounding_snapshot(tmp_path, capsys):
    """--pretrain from a grounding model's save_params snapshot restores
    every entry but the answer head's 10, which start fresh."""
    ground = JointNet(port_synthetic.tiny_config(no_caption=True,
                                                 use_con=False),
                      device="cpu")
    ckpt.save_params(str(tmp_path), "ground", ground.state_dict())
    path = os.path.join(str(tmp_path), "ground.pth")
    random.seed(0)
    best = train_qa.main(["--synthetic", "--smoke", "--device", "cpu",
                          "--workdir", str(tmp_path / "qa"), "--pretrain",
                          path])
    out = capsys.readouterr().out
    n = len(ground.state_dict())
    assert f"{n} entries restored, 10 fresh" in out, out[-500:]
    assert np.isfinite(best["answer_acc_at1"])


def test_answer_predictor_caps_top_k_at_the_vocabulary():
    """A vocabulary smaller than top k (a smoke run's 4 answers) gives
    every answer once, best first, rather than filler ids."""
    import dataclasses

    config = port_synthetic.tiny_config(use_con=False, no_caption=True,
                                        use_answer=True)
    config = dataclasses.replace(config, model=dataclasses.replace(
        config.model, num_answers=4))
    port = AnswerPredictor(config, batch_size=2, device="cpu")
    b = port_synthetic.make_batch(config, batch_size=2, num_points=256,
                                  istrain=0)
    got = port([{k: b[k] for k in STREAM_KEYS}])[0]
    ids = got["answer_top_ids"]
    assert ids.shape == (2, config.model.lang_num_max, 4)
    assert (np.sort(ids, axis=-1) == np.arange(4)).all()
    assert (np.diff(got["answer_top_scores"], axis=-1) <= 0).all()
