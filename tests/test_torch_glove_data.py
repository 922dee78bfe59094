"""The GloVe-era data of the single-task pipelines, the port's against the
JAX package's, on the CPU. Every comparison is exact (bit for bit):

  * ``synthetic_glove`` and the synthetic trainers' dictionaries (the
    ScanQA trainer's, the RefNet trainer's and the CapNet trainer's with
    "sos" / "eos");
  * ``transform_description`` / ``transform_descriptions`` (the pad /
    unk split of ``embeddings`` and ``main_embeddings``, the main clause's
    length, the two-word ``first_obj`` rule, descriptions longer than
    ``max_des_len``), ``transform_description_caption``,
    ``glove_batch_fields`` and ``caption_batch_fields``;
  * ``build_caption_vocabulary`` (the ids, not only the words: equal
    counts keep the Counter's insertion order), its ``known_words``
    filter and json cache, and ``build_caption_frequency``;
  * every batch of a ``BatchIterator`` over ``ScanReferJointDataset(glove=,
    caption_vocab=)`` and ``ScanQADataset(glove=)``, on synthetic scenes
    and on the stand-in assets, with 1 and 3 loader threads, within one
    process (``HashTokenizer``'s ids follow the process's hash seed);
    ``glove=`` with ``lang_num_aug`` raises in both;
  * the tensor ``get_3d_box_batch`` and ``box3d_iou_corners`` against the
    JAX functions (corners and IoU within 1e-6, float32 rounding of the
    rotation).

No JAX model is built here.
"""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlp3d.cli.train_scanqa as jax_train_scanqa
import vlp3d.data.dataset as jax_dataset
import vlp3d.data.glove as jax_glove
import vlp3d.data.standins as jax_standins
import vlp3d.data.synthetic as jax_synthetic
import vlp3d.data.vocab as jax_vocab
import vlp3d.data.vqa_dataset as jax_vqa
from vlp3d.data.tokenizer import HashTokenizer as JaxHashTokenizer
from vlp3d.geometry.boxes import box3d_iou_corners as jax_iou_corners
from vlp3d.geometry.boxes import get_3d_box_batch as jax_get_3d_box_batch
import vlp3d_torch.data.dataset as port_dataset
import vlp3d_torch.data.glove as port_glove
import vlp3d_torch.data.synthetic as port_synthetic
import vlp3d_torch.data.vocab as port_vocab
import vlp3d_torch.data.vqa_dataset as port_vqa
from vlp3d_torch.data.tokenizer import HashTokenizer
from vlp3d_torch.geometry.boxes import box3d_iou_corners, get_3d_box_batch

from test_torch_data import TSV_ROWS, assert_batches_equal

RAW2LABEL = {"chair": 2, "table": 4, "shower curtain": 13, "wall": 17,
             "bed": 1}
DESCRIPTIONS = [
    ["the", "chair", "is", "next", "to", "the", "table", ".", "it", "is",
     "brown"],
    ["a", "shower", "curtain", "near", "the", "chair"],
    ["this", "shower", "curtain", "."],
    ["the", "zebra", "stands", "by", "the", "bed"],
    ["word"] * 40,
    ["."],
    [],
]


def _glove(words, dim=300):
    return jax_glove.synthetic_glove(words, dim=dim, seed=3)


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and np.array_equal(got, want), where
    else:
        assert type(got) is type(want) and got == want, where


def test_synthetic_glove_dictionaries_equal():
    words = ["the", "chair", "pad"]
    for dim, seed in ((300, 0), (7, 5)):
        _assert_tree_equal(port_glove.synthetic_glove(words, dim, seed),
                           jax_glove.synthetic_glove(words, dim, seed))
    # the trainers' dictionaries (train_scanqa.py:58-76, train_3djcg_g.py,
    # train_3djcg_c.py)
    _, _, want = jax_train_scanqa._synthetic_qa(jax_synthetic.tiny_config())
    _assert_tree_equal(
        port_synthetic.synthetic_glove_for(port_synthetic.QA_WORDS), want)
    ref = ["the", "chair", "table", "bed", "sofa", "near", "wall"]
    assert port_synthetic.REF_WORDS == ref
    _assert_tree_equal(port_synthetic.synthetic_glove_for(ref),
                       jax_glove.synthetic_glove(ref + ["unk", "pad"]))
    _assert_tree_equal(
        port_synthetic.synthetic_glove_for(ref, ("unk", "pad", "sos", "eos")),
        jax_glove.synthetic_glove(ref + ["unk", "pad", "sos", "eos"]))


@pytest.mark.parametrize("max_des_len", [30, 5])
def test_transform_description_equal(max_des_len):
    glove = _glove(["the", "chair", "is", "next", "to", "table", ".",
                    "shower", "curtain", "bed", "word", "pad"])
    for tokens in DESCRIPTIONS:
        for name in ("chair", "shower_curtain", "bed", "unknown"):
            want = jax_glove.transform_description(
                tokens, name, glove, RAW2LABEL, max_des_len)
            got = port_glove.transform_description(
                tokens, name, glove, RAW2LABEL, max_des_len)
            _assert_tree_equal(got, want, f"{tokens} {name}")
    # the two-word rule and the main clause are live on these inputs
    two = port_glove.transform_description(
        DESCRIPTIONS[2], "shower curtain", glove, RAW2LABEL)
    assert two["first_obj"] == 2 and two["main_len"] == 4


def test_transform_descriptions_and_batch_fields_equal():
    glove = _glove(["the", "chair", "table", "sos", "eos", "pad"])
    anns = [{"scene_id": f"s{i % 2}", "object_id": str(i % 3),
             "object_name": "chair", "ann_id": str(i),
             "token": DESCRIPTIONS[i % len(DESCRIPTIONS)]}
            for i in range(9)]
    want = jax_glove.transform_descriptions(anns, glove, RAW2LABEL, 12)
    got = port_glove.transform_descriptions(anns, glove, RAW2LABEL, 12)
    _assert_tree_equal(got, want)
    chunk = anns[:3]
    _assert_tree_equal(port_glove.glove_batch_fields(chunk, got, 4, 12),
                       jax_glove.glove_batch_fields(chunk, want, 4, 12))
    vocab = jax_vocab.build_caption_vocabulary(anns, max_des_len=12)
    cap_w, cap_g = {}, {}
    for d in anns:
        for mod, cap in ((jax_glove, cap_w), (port_glove, cap_g)):
            cap.setdefault(d["scene_id"], {}).setdefault(
                d["object_id"], {})[d["ann_id"]] = (
                mod.transform_description_caption(d["token"], glove, vocab,
                                                  12))
    _assert_tree_equal(cap_g, cap_w)
    _assert_tree_equal(port_glove.caption_batch_fields(chunk, cap_g, 4, 12),
                       jax_glove.caption_batch_fields(chunk, cap_w, 4, 12))


def test_caption_vocabulary_ids_equal(tmp_path):
    """Equal counts keep the Counter's insertion order under the stable
    descending sort, so the ids depend on the annotations' order: the
    same order must give the same ids, a reversed one the same too."""
    anns = [{"token": t} for t in DESCRIPTIONS]
    anns += [{"token": ["zebra", "apple", "apple", "mango"]},
             {"token": ["mango", "zebra"]}]
    for order in (anns, anns[::-1]):
        for kw in ({}, {"max_des_len": 3},
                   {"known_words": {"the", "chair", "zebra", "mango"}}):
            want = jax_vocab.build_caption_vocabulary(order, **kw)
            got = port_vocab.build_caption_vocabulary(order, **kw)
            assert got == want
            assert list(got["word2idx"].items()) == list(
                want["word2idx"].items())
    path = str(tmp_path / "vocab.json")
    built = port_vocab.build_caption_vocabulary(anns, vocab_path=path)
    assert port_vocab.build_caption_vocabulary([], vocab_path=path) == json.load(
        open(path)) == json.loads(json.dumps(built))
    for mod in (port_vocab, jax_vocab):
        w = mod.build_caption_frequency(
            built, weights_path=str(tmp_path / f"{mod.__name__}.json"))
        assert np.array_equal(w, np.ones(len(built["word2idx"])))


def _run(module, make, workers):
    random.seed(3)  # split_scene_new's shuffle draws from `random`
    ds = make(module)
    out = []
    for epoch in range(2):
        if epoch:
            ds.shuffle_data()
        out += list(module.BatchIterator(
            ds, 2, epoch=epoch, drop_last=False, num_workers=workers,
            rng=np.random.default_rng(epoch)))
    return out


def _compare(make, workers, keys):
    want = _run(jax_dataset, make, workers)
    got = _run(port_dataset, make, workers)
    assert len(got) == len(want) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert set(keys) <= set(w)
        assert_batches_equal(w, g, f"batch {i}")


GLOVE_KEYS = ("lang_feat", "lang_len", "main_lang_feat", "main_lang_len",
              "first_obj")
CAPTION_KEYS = ("cap_lang_feat", "lang_ids", "cap_len")


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("captions", [False, True])
def test_synthetic_glove_batches_equal(captions, workers):
    ref = port_synthetic.REF_WORDS
    glove = port_synthetic.synthetic_glove_for(
        ref, ("unk", "pad", "sos", "eos"))
    probe = jax_synthetic.make_synthetic_dataset(
        jax_synthetic.tiny_config(), n_scenes=1).scanrefer
    vocab = (jax_vocab.build_caption_vocabulary(probe, max_des_len=10)
             if captions else None)

    def make(module):
        kw = dict(n_scenes=3, n_points=600, anns_per_scene=5, augment=True,
                  shuffle=True, seed=4, glove=glove, caption_vocab=vocab,
                  max_des_len=10)
        if module is jax_dataset:
            return jax_synthetic.make_synthetic_dataset(
                jax_synthetic.tiny_config(), **kw)
        return port_synthetic.make_synthetic_dataset(
            port_synthetic.tiny_config(), **kw)

    _compare(make, workers, GLOVE_KEYS + (CAPTION_KEYS if captions else ()))


@pytest.fixture(scope="module")
def standin_dir(tmp_path_factory):
    paths = jax_standins.write_standin_assets(
        str(tmp_path_factory.mktemp("standins")))
    with open(os.path.join(paths["scanrefer_dir"], "labels.tsv"), "w") as f:
        f.write("\n".join(TSV_ROWS) + "\n")
    return paths


@pytest.mark.parametrize("workers", [1, 3])
def test_standin_glove_batches_equal(standin_dir, workers):
    anns = json.load(open(os.path.join(standin_dir["scanrefer_dir"],
                                       "ScanRefer_filtered_val.json")))
    tsv = os.path.join(standin_dir["scanrefer_dir"], "labels.tsv")
    words = sorted({t for a in anns for t in a["token"]})
    glove = _glove(words[::2] + ["pad", "sos", "eos"])
    vocab = jax_vocab.build_caption_vocabulary(
        anns, known_words=set(glove))

    def make(module):
        return module.ScanReferJointDataset(
            anns, module.DirectorySceneSource(standin_dir["scannet_data"]),
            (JaxHashTokenizer if module is jax_dataset else HashTokenizer)(),
            split="val", num_points=3000, lang_num_max=2, augment=True,
            shuffle=True, raw2label=module.load_raw2label(tsv),
            bert_max_len=16, seed=9, glove=glove, caption_vocab=vocab,
            max_des_len=6)

    _compare(make, workers, GLOVE_KEYS + CAPTION_KEYS)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("source", ["synthetic", "standin"])
def test_scanqa_glove_batches_equal(standin_dir, source, workers):
    glove = port_synthetic.synthetic_glove_for(port_synthetic.QA_WORDS)
    if source == "synthetic":
        qa, src = port_synthetic.synthetic_qa(port_synthetic.tiny_config())
        scenes = src.scenes
        points = 512
    else:
        qa = json.load(open(os.path.join(standin_dir["scanqa_dir"],
                                         "ScanQA_v1.0_val.json")))
        points = 3000

    def make(module):
        vqa = jax_vqa if module is jax_dataset else port_vqa
        scene_source = (module.InMemorySceneSource(scenes)
                        if source == "synthetic" else
                        module.DirectorySceneSource(
                            standin_dir["scannet_data"]))
        return vqa.ScanQADataset(
            qa, scene_source,
            (JaxHashTokenizer if module is jax_dataset else HashTokenizer)(),
            split="train" if source == "synthetic" else "val",
            num_points=points, lang_num_max=1, bert_max_len=12,
            glove=glove, raw2label={}, augment=True, shuffle=True, seed=2)

    _compare(make, workers, GLOVE_KEYS + ("answer_cats",))


def test_glove_with_lang_num_aug_raises():
    glove = port_synthetic.synthetic_glove_for(port_synthetic.REF_WORDS)
    for synth in (jax_synthetic, port_synthetic):
        with pytest.raises(AssertionError, match="lang_num_aug"):
            synth.make_synthetic_dataset(
                synth.tiny_config(), augment=True, lang_num_aug=2,
                glove=glove)


@pytest.mark.parametrize("shape", [(5,), (2, 7)])
def test_tensor_box_corners_and_corner_iou_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    size = rng.uniform(0.1, 3.0, shape + (3,)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    center = rng.normal(size=shape + (3,)).astype(np.float32)
    want = np.array(jax_get_3d_box_batch(
        jnp.asarray(size), jnp.asarray(heading), jnp.asarray(center)))
    got = get_3d_box_batch(torch.from_numpy(size), torch.from_numpy(heading),
                           torch.from_numpy(center))
    assert torch.is_tensor(got) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    other = want[::-1].copy() + rng.normal(0, 0.3, want.shape).astype(
        np.float32)
    w_iou = np.asarray(jax_iou_corners(jnp.asarray(want),
                                       jnp.asarray(other)))
    g_iou = box3d_iou_corners(torch.from_numpy(want),
                              torch.from_numpy(other)).numpy()
    assert (w_iou > 0).any()
    np.testing.assert_allclose(g_iou, w_iou, rtol=0, atol=1e-6)
    # numpy in, numpy out, as before
    assert isinstance(get_3d_box_batch(size, heading, center), np.ndarray)
