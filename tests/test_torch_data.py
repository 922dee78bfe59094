"""The port's data path against the JAX package's, on the CPU.

``vlp3d_torch.data`` is the port's own copy of ``vlp3d.data`` (dataset,
augmentation, prompts, tokenizer, native loader, stand-in writers) and
of the numpy ``get_3d_box_batch``. The same annotations, scenes, seeds
and tokenizer go through both: every batch of a ``BatchIterator`` must
be equal key for key and bit for bit, on ``make_synthetic_dataset`` and
on a stand-in directory written by ``vlp3d.data.standins``, with
augmentation on and off, ``lang_num_aug`` 0 and 2, 1 and 3 loader
threads, on the fused native path and on the numpy path.
``HashTokenizer``'s ids come from Python's salted ``hash``, so they are
compared within this process only. Nothing here imports the JAX models.
"""

import json
import os
import random

import numpy as np
import pytest

import vlp3d.data.dataset as jax_dataset
import vlp3d.data.standins as jax_standins
import vlp3d.data.synthetic as jax_synthetic
import vlp3d.data.tokenizer as jax_tokenizer
import vlp3d.native as jax_native
from vlp3d.data.scannet import check_preprocess_layout as jax_check_layout
from vlp3d.geometry.boxes import get_3d_box_batch as jax_get_3d_box_batch
import vlp3d_torch.data.dataset as port_dataset
import vlp3d_torch.data.standins as port_standins
import vlp3d_torch.data.synthetic as port_synthetic
import vlp3d_torch.data.tokenizer as port_tokenizer
import vlp3d_torch.native as port_native
from vlp3d_torch.data.scannet import (
    check_preprocess_layout as port_check_layout,
)
from vlp3d_torch.geometry.boxes import get_3d_box_batch

TSV_ROWS = [
    "id\traw_category\tcategory\tcount\tnyu40id\teigen13id\tnyuClass"
    "\tnyu40class",
    "2\tchair\tchair\t10\t5\t6\tchair\tchair",
    "3\ttable\ttable\t10\t7\t10\ttable\ttable",
    "4\tbed\tbed\t10\t4\t1\tbed\tbed",
    "5\tlamp\tlamp\t10\t35\t1\tlamp\tlamp",
]


def assert_batches_equal(want, got, where=""):
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert g == w, f"{where} {k}"
        else:
            w, g = np.asarray(w), np.asarray(g)
            assert g.dtype == w.dtype and g.shape == w.shape, f"{where} {k}"
            assert np.array_equal(g, w), f"{where} {k}"


def _run(module, make, workers, native_on, monkeypatch, epochs=1):
    """Every batch of ``epochs`` epochs of the dataset ``make(module)``
    builds, native path on or off."""
    native = {jax_dataset: jax_native, port_dataset: port_native}[module]
    if not native_on:
        monkeypatch.setattr(native, "native_available", lambda: False)
    random.seed(3)  # split_scene_new's shuffle draws from `random`
    ds = make(module)
    out = []
    for epoch in range(epochs):
        if epoch:
            ds.shuffle_data()
        loader = module.BatchIterator(
            ds, 2, epoch=epoch, drop_last=False, num_workers=workers,
            rng=np.random.default_rng(epoch))
        out += list(loader)
    monkeypatch.undo()
    return out


def _compare(make, workers, native_on, monkeypatch, epochs=1):
    want = _run(jax_dataset, make, workers, native_on, monkeypatch, epochs)
    got = _run(port_dataset, make, workers, native_on, monkeypatch, epochs)
    assert len(got) == len(want) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert_batches_equal(w, g, f"batch {i}")


def test_native_library_builds_here():
    assert port_native.native_available()
    assert port_native.lib_path().exists()
    assert jax_native.native_available()


AUG = [(False, 0), (True, 0), (True, 2)]


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("augment,lang_num_aug", AUG)
def test_synthetic_batches_equal_bit_for_bit(augment, lang_num_aug, workers,
                                             native_on, monkeypatch):
    jax_cfg = jax_synthetic.tiny_config()
    port_cfg = port_synthetic.tiny_config()

    def make(module):
        if module is jax_dataset:
            return jax_synthetic.make_synthetic_dataset(
                jax_cfg, n_scenes=3, n_points=700, anns_per_scene=5,
                augment=augment, lang_num_aug=lang_num_aug, seed=4)
        return port_synthetic.make_synthetic_dataset(
            port_cfg, n_scenes=3, n_points=700, anns_per_scene=5,
            augment=augment, lang_num_aug=lang_num_aug, seed=4)

    _compare(make, workers, native_on, monkeypatch)


@pytest.fixture(scope="module")
def standin_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("standins")
    return jax_standins.write_standin_assets(str(root))


def _standin_dataset(module, paths, augment, lang_num_aug, tokenizer):
    anns = json.load(open(os.path.join(paths["scanrefer_dir"],
                                       "ScanRefer_filtered_val.json")))
    tsv = os.path.join(paths["scanrefer_dir"], "labels.tsv")
    return module.ScanReferJointDataset(
        sorted(anns, key=lambda d: (d["scene_id"], int(d["object_id"]))),
        module.DirectorySceneSource(paths["scannet_data"]), tokenizer,
        split="val", num_points=3000, lang_num_max=4,
        lang_num_aug=lang_num_aug, augment=augment, shuffle=True,
        raw2label=module.load_raw2label(tsv),
        nyu40id2class=module.build_nyu40id2class(tsv), bert_max_len=16,
        seed=9)


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("augment,lang_num_aug", AUG)
def test_standin_batches_equal_bit_for_bit(standin_dir, augment, lang_num_aug,
                                           workers, native_on, monkeypatch):
    with open(os.path.join(standin_dir["scanrefer_dir"], "labels.tsv"),
              "w") as f:
        f.write("\n".join(TSV_ROWS) + "\n")
    vocab = os.path.join(standin_dir["bert_dir"], "vocab.txt")

    def make(module):
        tok = (jax_tokenizer if module is jax_dataset
               else port_tokenizer).load_tokenizer(vocab)
        return _standin_dataset(module, standin_dir, augment, lang_num_aug,
                                tok)

    _compare(make, workers, native_on, monkeypatch, epochs=2)


def test_port_writes_the_same_standins(standin_dir, tmp_path):
    paths = port_standins.write_standin_assets(str(tmp_path))
    for key in ("scannet_data", "scanrefer_dir"):
        for name in sorted(os.listdir(standin_dir[key])):
            if name == "labels.tsv":
                continue
            want = os.path.join(standin_dir[key], name)
            got = os.path.join(paths[key], name)
            if name.endswith(".npy"):
                w, g = np.load(want), np.load(got)
                assert g.dtype == w.dtype and np.array_equal(g, w), name
            else:
                assert json.load(open(got)) == json.load(open(want)), name
    assert (open(os.path.join(paths["bert_dir"], "vocab.txt")).read()
            == open(os.path.join(standin_dir["bert_dir"], "vocab.txt")).read())


def test_stale_layout_check_agrees(tmp_path):
    rng = np.random.default_rng(0)
    good = port_standins.write_scene_assets(str(tmp_path), rng)
    pc = np.concatenate([good["xyz"], good["normals"], good["mv"]], axis=1)
    stale = np.concatenate([good["xyz"], good["mv"], good["normals"]], axis=1)
    for check in (jax_check_layout, port_check_layout):
        check(pc)
        check(pc[:, :100])  # other widths are not checked
        with pytest.raises(ValueError, match="stale preprocess cache"):
            check(stale)


SENTENCES = [
    "The brown wooden chair, next to the table.",
    "a Café chair standing against the wall; it's unusual!",
    "2nd chairs with an unusualword on this table",
    "",
    "zebra " * 40,
]


def test_tokenizers_give_the_same_ids(standin_dir):
    vocab = os.path.join(standin_dir["bert_dir"], "vocab.txt")
    for text in SENTENCES:
        assert (port_tokenizer.basic_tokenize(text)
                == jax_tokenizer.basic_tokenize(text))
    for path in (vocab, None):
        want = jax_tokenizer.load_tokenizer(path)
        got = port_tokenizer.load_tokenizer(path)
        assert type(got).__name__ == type(want).__name__
        w, g = want(SENTENCES, max_length=20), got(SENTENCES, max_length=20)
        for k in ("input_ids", "attention_mask"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
        assert g["input_ids"][1].any() and g["input_ids"][4, -1] != 0
        for row in w["input_ids"]:
            assert got.decode(row) == want.decode(row)
        assert got.tokenize_ids(SENTENCES[1]) == want.tokenize_ids(
            SENTENCES[1])


def test_label_maps_and_unique_multiple_agree(tmp_path):
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("\n".join(TSV_ROWS) + "\n")
    assert (port_dataset.load_raw2label(str(tsv))
            == jax_dataset.load_raw2label(str(tsv)))
    assert (port_dataset.build_nyu40id2class(str(tsv))
            == jax_dataset.build_nyu40id2class(str(tsv)))
    anns = [{"scene_id": f"scene000{s}_00", "object_id": str(o),
             "object_name": n, "ann_id": str(a)}
            for s in range(2) for a, (o, n) in enumerate(
                [(0, "chair"), (1, "chair"), (2, "table"), (3, "bed_frame"),
                 (2, "table")])]
    raw2label = jax_dataset.load_raw2label(str(tsv))
    want = jax_dataset.unique_multiple_lookup(anns, raw2label)
    assert port_dataset.unique_multiple_lookup(anns, raw2label) == want


@pytest.mark.parametrize("shape", [(5,), (2, 4), ()])
def test_get_3d_box_batch_equal(shape):
    rng = np.random.default_rng(len(shape))
    size = rng.uniform(0.1, 3.0, shape + (3,))  # float64 on purpose
    heading = rng.uniform(-np.pi, np.pi, shape)
    center = rng.normal(size=shape + (3,)).astype(np.float32)
    want = jax_get_3d_box_batch(size, heading, center)
    got = get_3d_box_batch(size, heading, center)
    assert isinstance(want, np.ndarray)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
