"""The port's data preparation against the JAX package's, on the CPU, on
the fixtures of ``tests/test_{scannet_export,aligned_mesh,referit3d,
scan2cad}.py``: the ScanNet export and preprocess caches (the ``.npy``
files equal, dtype and bits), the PLY reader and writers, the
axis-aligned mesh and vertex dumps (equal bytes), the ReferIt3D and
Scan2CAD conversions and ``preprocess_annotations``'s three commands
(equal jsons).
"""

import filecmp
import json
import os

import numpy as np
import pytest

import vlp3d.data.scannet as jax_scannet
import vlp3d_torch.data.scannet as port_scannet
from test_aligned_mesh import _write_binary_mesh
from test_referit3d import ROWS, _write_csv
from test_scannet_export import make_scan
from vlp3d.cli.export_aligned_mesh import main as jax_mesh_main
from vlp3d.cli.preprocess_annotations import main as jax_annotations
from vlp3d.cli.scannet_export import main as jax_export_main
from vlp3d.data.referit3d import convert_referit3d as jax_referit3d
from vlp3d.data.scan2cad import parse_scan2cad_rotations as jax_scan2cad
from vlp3d_torch.cli.export_aligned_mesh import main as port_mesh_main
from vlp3d_torch.cli.preprocess_annotations import main as port_annotations
from vlp3d_torch.cli.scannet_export import main as port_export_main
from vlp3d_torch.data.referit3d import convert_referit3d as port_referit3d
from vlp3d_torch.data.scan2cad import parse_scan2cad_rotations as port_s2c
from vlp3d_torch.data.scan2cad import quaternion_to_matrix

LABELS = "id\traw_category\tcategory\tcount\tnyu40id\n" \
         "1\tchair\tchair\t100\t5\n2\ttable\ttable\t50\t7\n3\tfloor\tf\t9\t2\n"


def assert_same_tree(a, b):
    """Every file under ``a`` and ``b``: the same names; .npy arrays
    equal in dtype and bits, other files equal in bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            assert_same_tree(pa, pb)
        elif n.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and x.shape == y.shape, n
            assert np.array_equal(x, y, equal_nan=True), n
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


def faced_scan(root, scan):
    """A scan whose mesh has faces (so its normals are not zero), two
    objects and a wall, and an axis-align matrix with a rotation."""
    d = root / scan
    d.mkdir(parents=True)
    _write_binary_mesh(d / f"{scan}_vh_clean_2.ply")
    (d / f"{scan}_vh_clean_2.0.010000.segs.json").write_text(json.dumps(
        {"segIndices": [0, 0, 1, 2]}))
    (d / f"{scan}.aggregation.json").write_text(json.dumps({"segGroups": [
        {"objectId": 0, "label": "chair", "segments": [0]},
        {"objectId": 1, "label": "table", "segments": [1]},
        {"objectId": 2, "label": "floor", "segments": [2]}]}))
    mat = np.array([[0, -1, 0, 1], [1, 0, 0, 2], [0, 0, 1, 3], [0, 0, 0, 1]],
                   np.float64)
    (d / f"{scan}.txt").write_text(
        "axisAlignment = " + " ".join(str(x) for x in mat.flatten()) + "\n")


@pytest.fixture
def scans(tmp_path):
    root = tmp_path / "scans"
    make_scan(root, "scene0001_00")
    faced_scan(root, "scene0002_00")
    (tmp_path / "labels.tsv").write_text(LABELS)
    meta = tmp_path / "meta"
    meta.mkdir()
    (meta / "scannetv2_train.txt").write_text("scene0001_00\n")
    (meta / "scannetv2_val.txt").write_text("scene0001_00\nscene0002_00\n")
    return tmp_path


@pytest.mark.parametrize("max_points", [None, 150])
def test_export_one_scan_is_jax_s(scans, tmp_path, monkeypatch, max_points):
    if max_points:  # the 50k subsample, at the fixture's size
        monkeypatch.setattr(jax_scannet, "MAX_NUM_POINT", max_points)
        monkeypatch.setattr(port_scannet, "MAX_NUM_POINT", max_points)
    label_map = jax_scannet.read_label_map(str(scans / "labels.tsv"))
    assert port_scannet.read_label_map(str(scans / "labels.tsv")) == label_map
    for mod, name in ((jax_scannet, "jax"), (port_scannet, "port")):
        out = tmp_path / name
        out.mkdir()
        for scan in ("scene0001_00", "scene0002_00"):
            mod.export_one_scan(str(scans / "scans"), scan, label_map,
                                str(out / scan),
                                rng=np.random.default_rng(3))
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    vert = np.load(tmp_path / "port" / "scene0002_00_vert.npy")
    assert np.abs(vert[:, 6:9]).sum() > 0  # face normals
    if max_points:
        assert len(np.load(tmp_path / "port" / "scene0001_00_vert.npy")) \
            == max_points


@pytest.mark.parametrize("color,normal,multiview", [
    (False, True, False), (True, True, True), (True, False, False)])
def test_build_preprocess_is_jax_s(scans, tmp_path, color, normal,
                                   multiview):
    """The multiview features come from an hdf5 h5py wrote; the port reads
    it without h5py."""
    import h5py

    label_map = port_scannet.read_label_map(str(scans / "labels.tsv"))
    mv = None
    if multiview:
        mv = str(tmp_path / "enet_feats_maxpool.hdf5")
        with h5py.File(mv, "w") as f:
            f.create_dataset("scene0002_00", data=np.random.default_rng(
                4).normal(size=(4, 128)).astype(np.float32))
    for mod, name in ((jax_scannet, "jax"), (port_scannet, "port")):
        out = tmp_path / name
        out.mkdir()
        mod.export_one_scan(str(scans / "scans"), "scene0002_00", label_map,
                            str(out / "scene0002_00"))
        got = mod.build_preprocess(str(out), "scene0002_00", "val",
                                   use_color=color, use_normal=normal,
                                   multiview_path=mv)
        assert got.shape[1] == 3 + 3 * color + 3 * normal + 128 * multiview
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_legacy_six_column_normals_are_jax_s(tmp_path):
    """A 6-column export falls back to kNN-PCA normals; a cloud of fewer
    than k + 1 points gets +z."""
    rng = np.random.default_rng(5)
    for n in (40, 6):
        vert = rng.uniform(0, 3, (n, 6)).astype(np.float32)
        for mod, name in ((jax_scannet, "jax"), (port_scannet, "port")):
            out = tmp_path / f"{name}{n}"
            out.mkdir()
            np.save(out / "s_aligned_vert.npy", vert)
            mod.build_preprocess(str(out), "s", "train", use_normal=True)
        assert_same_tree(str(tmp_path / f"jax{n}"), str(tmp_path / f"port{n}"))


def test_ply_readers_and_writer_are_jax_s(tmp_path):
    rng = np.random.default_rng(6)
    verts = np.concatenate([rng.uniform(-2, 2, (9, 3)),
                            rng.integers(0, 256, (9, 3))], 1)
    faces = rng.integers(0, 9, (5, 3))
    written = []
    for mod, name in ((jax_scannet, "jax"), (port_scannet, "port")):
        path = str(tmp_path / f"{name}.ply")
        mod.write_ply_mesh(path, verts, faces)
        written.append(path)
    assert filecmp.cmp(*written, shallow=False)
    bin_path = str(tmp_path / "bin.ply")
    _write_binary_mesh(bin_path)
    for path in (written[0], bin_path):  # ascii and binary little-endian
        jv, jf = jax_scannet.read_ply_mesh_arrays(path)
        pv, pf = port_scannet.read_ply_mesh_arrays(path)
        assert jv.keys() == pv.keys() and np.array_equal(jf, pf)
        for k in jv:
            assert np.array_equal(jv[k], pv[k]), k
        assert np.array_equal(jax_scannet.read_mesh_vertices_rgb(path),
                              port_scannet.read_mesh_vertices_rgb(path))


def test_scannet_export_cli_is_jax_s(scans, tmp_path):
    """Export, then the preprocess caches of each split by the meta
    lists, with colour."""
    for main, name in ((jax_export_main, "jax"), (port_export_main, "port")):
        main(["--scans_dir", str(scans / "scans"), "--labels_tsv",
              str(scans / "labels.tsv"), "--output_dir", str(tmp_path / name),
              "--meta_dir", str(scans / "meta"), "--preprocess",
              "--use_color", "--seed", "2"])
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert os.path.exists(tmp_path / "port" / "scene0002_00_preprocess_val.npy")
    assert not os.path.exists(
        tmp_path / "port" / "scene0002_00_preprocess_train.npy")


def test_export_aligned_mesh_cli_is_jax_s(scans, tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    label_map = port_scannet.read_label_map(str(scans / "labels.tsv"))
    port_scannet.export_one_scan(str(scans / "scans"), "scene0002_00",
                                 label_map, str(data / "scene0002_00"))
    for main, name in ((jax_mesh_main, "jax"), (port_mesh_main, "port")):
        main(["mesh", "--scans_dir", str(scans / "scans"), "--out_dir",
              str(tmp_path / name)])
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    dumps = []
    for main, name in ((jax_mesh_main, "jax"), (port_mesh_main, "port")):
        main(["verts", "--scannet_data", str(data), "--scene_id",
              "scene0002_00"])
        d = tmp_path / f"verts_{name}"
        d.mkdir()
        for f in os.listdir(data):
            if f.endswith(".obj"):
                os.replace(data / f, d / f)
        dumps.append(str(d))
    assert_same_tree(*dumps)
    assert len(os.listdir(dumps[1])) == 2


@pytest.mark.parametrize("name,split", [("nr3d", "lists"),
                                        ("sr3d", "lists"),
                                        ("nr3d", "scanrefer")])
def test_referit3d_conversion_is_jax_s(tmp_path, name, split):
    csv_path = tmp_path / f"{name}.csv"
    _write_csv(csv_path, ROWS)
    (tmp_path / "train.txt").write_text("scene0000_00\n")
    (tmp_path / "val.txt").write_text("scene0500_00\n")
    sr = tmp_path / "scanrefer"
    sr.mkdir()
    (sr / "ScanRefer_filtered_train.json").write_text(json.dumps(
        [{"scene_id": "scene0000_00"}]))
    (sr / "ScanRefer_filtered_val.json").write_text(json.dumps(
        [{"scene_id": "scene0500_00"}]))
    kw = (dict(train_list=str(tmp_path / "train.txt"),
               val_list=str(tmp_path / "val.txt")) if split == "lists"
          else dict(scanrefer_dir=str(sr)))
    want = jax_referit3d(str(csv_path), str(tmp_path / "jax"), **kw)
    got = port_referit3d(str(csv_path), str(tmp_path / "port"), **kw)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    with pytest.raises(ValueError, match="train_list"):
        port_referit3d(str(csv_path), str(tmp_path / "x"))


def _scan2cad_inputs():
    c = np.cos(np.pi / 4)
    annotations = [
        {"id_scan": "scene0000_00", "aligned_models": [
            {"trs": {"rotation": [1, 0, 0, 0]}},
            {"trs": {"rotation": [c, 0, 0, c]}},
            {"trs": {"rotation": [0.3, -0.2, 0.9, 0.1]}}]},
        {"id_scan": "scene0001_00", "aligned_models": [
            {"trs": {"rotation": [0, 0, 0, 0]}}]},
        {"id_scan": "scene0002_00"},
    ]
    cad2inst = {"scene0000_00": {"0": 4, "2": 9}, "scene0001_00": {"0": 1}}
    return annotations, cad2inst


def test_scan2cad_is_jax_s():
    from vlp3d.data.scan2cad import quaternion_to_matrix as jax_q2m

    annotations, cad2inst = _scan2cad_inputs()
    assert port_s2c(annotations, cad2inst) == jax_scan2cad(annotations,
                                                           cad2inst)
    for q in ([1, 0, 0, 0], [0, 0, 0, 0], [0.3, -0.2, 0.9, 0.1]):
        assert np.array_equal(quaternion_to_matrix(q), jax_q2m(q))


@pytest.mark.parametrize("cmd", ["organize", "scan2cad", "referit3d"])
def test_preprocess_annotations_cli_is_jax_s(tmp_path, cmd):
    if cmd == "organize":
        anns = [{"scene_id": f"scene000{i % 2}_00", "object_id": str(i % 3),
                 "ann_id": str(i), "description": f"thing {i}"}
                for i in range(7)]
        (tmp_path / "sr.json").write_text(json.dumps(anns))
        argv = lambda d: ["organize", "--scanrefer", str(tmp_path / "sr.json"),
                          "--out", str(d / "organized.json")]
    elif cmd == "scan2cad":
        annotations, cad2inst = _scan2cad_inputs()
        (tmp_path / "full.json").write_text(json.dumps(annotations))
        (tmp_path / "c2i.json").write_text(json.dumps(cad2inst))
        argv = lambda d: ["scan2cad", "--annotations",
                          str(tmp_path / "full.json"), "--cad2inst",
                          str(tmp_path / "c2i.json"), "--out",
                          str(d / "rot.json")]
    else:
        _write_csv(tmp_path / "sr3d.csv", ROWS)
        (tmp_path / "train.txt").write_text("scene0000_00\n")
        (tmp_path / "val.txt").write_text("scene0500_00\nscene0999_00\n")
        argv = lambda d: ["referit3d", "--csv", str(tmp_path / "sr3d.csv"),
                          "--out_dir", str(d), "--train_list",
                          str(tmp_path / "train.txt"), "--val_list",
                          str(tmp_path / "val.txt")]
    for main, name in ((jax_annotations, "jax"), (port_annotations, "port")):
        d = tmp_path / name
        d.mkdir()
        main(argv(d))
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
