"""The port's hdf5 reader against h5py, and the ``--multiview_hdf5``
loader against the JAX package's, on the CPU.

``vlp3d_torch.data.hdf5.read_datasets`` reads the files h5py writes,
without h5py: its default layout (superblock 0, a symbol-table root
group whose B-tree grows levels) and ``libver="latest"`` (superblock 3,
``OHDR`` headers, links compact up to 8 and in a fractal heap past 8),
at 0, 1, 8, 9, 300 and 2000 datasets, bit for bit; object headers
continued in other blocks; refusals that name the dataset. The committed
fixtures (``tests/torch_write_hdf5_fixtures.py``) are what h5py reads.
The port's ``DirectorySceneSource`` with ``multiview_hdf5`` gives the
batches ``vlp3d.data``'s gives (h5py) on the same stand-in file, and the
baked-npy batches; the port's stand-in writers write JAX's files.
"""

import json
import os
import random

import h5py
import numpy as np
import pytest
import torch

import vlp3d.data.dataset as jax_dataset
import vlp3d.data.standins as jax_standins
import vlp3d.data.tokenizer as jax_tokenizer
import vlp3d_torch.data.dataset as port_dataset
import vlp3d_torch.data.standins as port_standins
import vlp3d_torch.data.tokenizer as port_tokenizer
from torch_write_hdf5_fixtures import (
    COUNT,
    FIXTURES,
    LAYOUTS,
    fixture_name,
    fixture_value,
)
from vlp3d_torch.data.hdf5 import read_datasets

LIBVERS = {"default": None, "latest": "latest"}


def h5py_datasets(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def assert_read_equals_h5py(path):
    want = h5py_datasets(path)
    got = read_datasets(str(path))
    assert list(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
        if g.size:
            assert isinstance(g, np.memmap) and not g.flags.writeable, k


@pytest.mark.parametrize("count", [0, 1, 8, 9, 300, 2000])
@pytest.mark.parametrize("libver", list(LIBVERS))
def test_reads_what_h5py_writes(tmp_path, libver, count):
    rng = np.random.default_rng(count)
    path = tmp_path / f"{libver}_{count}.hdf5"
    with h5py.File(path, "w", libver=LIBVERS[libver]) as f:
        for i in range(count):
            rows = int(rng.integers(0, 40)) if count < 300 else 1 + i % 3
            f.create_dataset(f"scene{i:04d}_00", data=rng.normal(
                size=(rows, 128 if count < 300 else 4)).astype(np.float32))
    layout = open(path, "rb").read()
    assert layout[8] == (0 if libver == "default" else 3)
    if libver == "latest" and count > 8:  # dense link storage
        assert b"FRHP" in layout and b"BTHD" in layout
    if libver == "default" and count >= 300:  # a group B-tree of levels
        assert layout.count(b"TREE") > 1
    assert_read_equals_h5py(path)


@pytest.mark.parametrize("libver", list(LIBVERS))
def test_reads_headers_continued_elsewhere(tmp_path, libver):
    """Attributes added after the datasets were written push a header's
    messages into continuation blocks (``OCHK`` under "latest")."""
    path = tmp_path / "grown.hdf5"
    with h5py.File(path, "w", libver=LIBVERS[libver]) as f:
        f.create_dataset("a", data=np.arange(12, dtype=np.float32)
                         .reshape(3, 4))
        f.create_dataset("scalar", data=np.float32(2.5))
    for k in range(6):
        with h5py.File(path, "a", libver=LIBVERS[libver]) as f:
            f["a"].attrs[f"x{k}"] = np.arange(40)
            f.create_dataset(f"b{k}", data=np.full((k, 2), k, np.float32))
    if libver == "latest":
        assert b"OCHK" in open(path, "rb").read()
    assert_read_equals_h5py(path)


@pytest.mark.parametrize("libver", list(LIBVERS))
@pytest.mark.parametrize("kwargs,found", [
    (dict(chunks=(2, 4)), "chunked layout"),
    (dict(compression="gzip"), "chunked layout, compressed"),
    (dict(dtype="f8"), "8-byte float"),
    (dict(dtype=">f4"), "big-endian"),
    (dict(dtype="i4"), "4-byte integer"),
], ids=["chunked", "gzip", "float64", "big-endian", "int32"])
def test_refuses_other_layouts_naming_the_dataset(tmp_path, libver, kwargs,
                                                   found):
    path = tmp_path / "other.hdf5"
    with h5py.File(path, "w", libver=LIBVERS[libver]) as f:
        f.create_dataset("good", data=np.ones((3, 4), np.float32))
        f.create_dataset("scene0007_00", data=np.ones((4, 4), np.float32),
                         **kwargs)
    with pytest.raises(ValueError, match=f"scene0007_00: .*{found}"):
        read_datasets(str(path))


@pytest.mark.parametrize("libver", list(LIBVERS))
def test_refuses_groups_and_soft_links(tmp_path, libver):
    for make, found in ((lambda f: f.create_group("sub"), "sub is not"),
                        (lambda f: f.__setitem__("soft", h5py.SoftLink(
                            "/good")), "soft: a .*link")):
        path = tmp_path / "links.hdf5"
        with h5py.File(path, "w", libver=LIBVERS[libver]) as f:
            f.create_dataset("good", data=np.ones((3, 4), np.float32))
            make(f)
        with pytest.raises(ValueError, match=found):
            read_datasets(str(path))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_committed_fixtures_are_what_h5py_reads(name):
    path = os.path.join(FIXTURES, name)
    assert os.path.getsize(path) <= 128 * 1024
    assert_read_equals_h5py(path)
    got = read_datasets(path)
    assert list(got) == [fixture_name(i) for i in range(COUNT)]
    for i in range(COUNT):
        assert np.array_equal(got[fixture_name(i)], fixture_value(i))


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    root = tmp_path_factory.mktemp("mv_standins")
    paths = jax_standins.write_standin_assets(str(root / "jax"))
    with open(os.path.join(paths["scanrefer_dir"], "labels.tsv"), "w") as f:
        f.write("\n".join([
            "id\traw_category\tcategory\tcount\tnyu40id\teigen13id"
            "\tnyuClass\tnyu40class",
            "2\tchair\tchair\t10\t5\t6\tchair\tchair",
            "3\ttable\ttable\t10\t7\t10\ttable\ttable",
        ]) + "\n")
    return paths


def _batches(module, paths, scene_dir, multiview_hdf5, workers):
    anns = json.load(open(os.path.join(paths["scanrefer_dir"],
                                       "ScanRefer_filtered_val.json")))
    tsv = os.path.join(paths["scanrefer_dir"], "labels.tsv")
    tok = (jax_tokenizer if module is jax_dataset else port_tokenizer
           ).load_tokenizer(os.path.join(paths["bert_dir"], "vocab.txt"))
    random.seed(3)
    ds = module.ScanReferJointDataset(
        sorted(anns, key=lambda d: (d["scene_id"], int(d["object_id"]))),
        module.DirectorySceneSource(scene_dir, multiview_hdf5=multiview_hdf5),
        tok, split="val", num_points=1500, lang_num_max=4, augment=True,
        shuffle=True, raw2label=module.load_raw2label(tsv),
        nyu40id2class=module.build_nyu40id2class(tsv), bert_max_len=16,
        seed=9)
    return list(module.BatchIterator(ds, 2, epoch=0, drop_last=False,
                                     num_workers=workers,
                                     rng=np.random.default_rng(0)))


def _assert_batches_equal(want, got):
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, list):
                assert g[k] == v, k
            else:
                v, gk = np.asarray(v), np.asarray(g[k])
                assert gk.dtype == v.dtype and np.array_equal(gk, v), k


@pytest.mark.parametrize("workers", [1, 3])
def test_multiview_hdf5_batches_equal_jax_and_baked(standins, workers):
    nomv = standins["multiview_nomv_data"]
    hdf5 = os.path.join(nomv, "enet_feats_maxpool.hdf5")
    want = _batches(jax_dataset, standins, nomv, hdf5, workers)
    got = _batches(port_dataset, standins, nomv, hdf5, workers)
    _assert_batches_equal(want, got)
    baked = _batches(port_dataset, standins, standins["scannet_data"], None,
                     workers)
    _assert_batches_equal(baked, got)


def test_multiview_hdf5_missing_scene_names_it(tmp_path, standins):
    from vlp3d_torch.data.hdf5 import DatasetWriter

    path = str(tmp_path / "empty.hdf5")
    with DatasetWriter(path) as w:
        w.add("scene0999_00", np.zeros((2, 128), np.float32))
    source = port_dataset.DirectorySceneSource(
        standins["multiview_nomv_data"], multiview_hdf5=path)
    with pytest.raises(KeyError, match="scene0000_00"):
        source("scene0000_00", "val")


def test_port_standins_write_the_jax_files(tmp_path):
    want = jax_standins.write_standin_assets(str(tmp_path / "jax"))
    got = port_standins.write_standin_assets(str(tmp_path / "port"))
    assert set(got) == set(want)
    nomv = "multiview_nomv_data"
    assert sorted(os.listdir(got[nomv])) == sorted(os.listdir(want[nomv]))
    for name in os.listdir(want[nomv]):
        w, g = (os.path.join(d[nomv], name) for d in (want, got))
        if name.endswith(".npy"):
            a, b = np.load(w), np.load(g)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert h5py_datasets(w).keys() == h5py_datasets(g).keys()
            for k, v in h5py_datasets(w).items():
                assert h5py_datasets(g)[k].tobytes() == v.tobytes()
            assert read_datasets(g)["scene0000_00"].tobytes() == \
                h5py_datasets(w)["scene0000_00"].tobytes()
    assert (open(os.path.join(got["bert_dir"], "vocab.txt")).read()
            == open(os.path.join(want["bert_dir"], "vocab.txt")).read())
    sw = torch.load(os.path.join(want["bert_dir"], "pytorch_model.bin"))
    sg = torch.load(os.path.join(got["bert_dir"], "pytorch_model.bin"))
    assert list(sg) == list(sw)
    for k, v in sw.items():
        assert sg[k].dtype == v.dtype and torch.equal(sg[k], v), k
