"""ENet, the multiview projection and the compute_multiview CLI of
vlp3d_torch against the JAX package, on the CPU. Weights: a seeded fill
of the flax ENet's shapes (distinct PReLU slopes, random BatchNorm
statistics), carried over by ``convert.enet_to_torch_state_dict``, and a
state dict in the reference's ``create_enet`` layout (its tensors in
execution order under positional names, as the torch7 dump registers
them) read by ``load_enet_reference_state_dict`` here and by JAX's
``convert_enet_state_dict``. Stated tolerances:

  * ENet's feature maps and classifier logits: every entry within 1e-4
    of the map's largest entry (22 bottlenecks of float32 convolutions
    summed in another order), at 64 x 64 and at 68 x 52 (not a multiple
    of 8: the floor-mode pools drop a row);
  * the multiview numpy (projection, max-pool, label vote): equal;
  * the port's hdf5 writer (no h5py): h5py and the port's reader read
    back every dataset bit for bit; the reader refuses h5py's own layout;
  * the CLI on the same frames and weights, the JAX CLI's flax
    checkpoint against the port's ``.pth`` (this port's layout and the
    reference's): every scene's (N, 128) rows within 1e-4 of the
    largest entry, the unseen points' rows zero in both; ``--labels``:
    the label files and PLYs equal.
"""

import jax
import numpy as np
import pytest
import torch

from vlp3d.data import multiview as jax_mv
from vlp3d.models.enet import ENetEncoder as JaxENet
from vlp3d.models.enet import convert_enet_state_dict
from vlp3d_torch import convert
from vlp3d_torch.data import multiview as port_mv
from vlp3d_torch.models.enet import (
    ENetEncoder,
    load_enet_reference_state_dict,
)

MAP_TOL = 1e-4  # of the map's largest entry


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seeded(num_classes=None, seed=0):
    mod = JaxENet(num_classes=num_classes)
    shapes = jax.eval_shape(lambda x: mod.init(
        {"params": jax.random.key(0)}, x), np.zeros((1, 64, 64, 3),
                                                    np.float32))
    rng = np.random.default_rng(seed)

    def param(path, a):
        name = path[-1].key
        if name == "alpha":
            return (0.25 + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name == "scale":
            return (1 + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, a.shape).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return rng.normal(0, fan_in ** -0.5, a.shape).astype(np.float32)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(param, shapes["params"]),
            jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"]))


def _close(got, want):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= MAP_TOL * scale, (
        float(np.abs(got - want).max()), scale)


def _reference_layout(sd: dict, tracked: bool = True) -> dict:
    """A port ENet state dict in the reference dump's form: the tensors in
    execution order under positional names (with or without the
    BatchNorms' num_batches_tracked)."""
    out = {}
    for i, (k, v) in enumerate(sd.items()):
        leaf = k.rpartition(".")[2]
        if leaf == "num_batches_tracked" and not tracked:
            continue
        out[f"{i}.{leaf}"] = v.clone()
    return out


@pytest.mark.parametrize("hw", [(64, 64), (68, 52)])
def test_enet_matches_jax_through_the_flax_converter(hw):
    params, stats = _seeded(seed=1)
    img = np.random.default_rng(2).uniform(0, 1, (2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(JaxENet().apply(
        {"params": params, "batch_stats": stats}, img))
    model = ENetEncoder(device="cpu")
    model.load_state_dict(convert.enet_to_torch_state_dict(params, stats),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == (2, hw[0] // 8, hw[1] // 8, 128)
    _close(got, want)


@pytest.mark.parametrize("num_classes,tracked,hw", [
    (None, True, (64, 64)), (None, False, (68, 52)), (41, True, (48, 48))])
def test_enet_matches_jax_through_the_reference_layout(num_classes, tracked,
                                                       hw):
    params, stats = _seeded(num_classes, seed=3)
    port = ENetEncoder(num_classes, device="cpu")
    port.load_state_dict(convert.enet_to_torch_state_dict(params, stats))
    ref = _reference_layout(port.state_dict(), tracked)
    variables = convert_enet_state_dict(ref, num_classes=num_classes)
    img = np.random.default_rng(4).uniform(0, 1, (1, *hw, 3)).astype(
        np.float32)
    want = np.asarray(JaxENet(num_classes=num_classes).apply(variables, img))
    model = ENetEncoder(num_classes, device="cpu")
    model.load_state_dict(load_enet_reference_state_dict(
        ref, num_classes=num_classes), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    _close(got, want)


def test_ref_dropout_scales_at_evaluation():
    model = ENetEncoder(device="cpu")
    block = model.blocks[0]
    x = torch.ones(1, 64, 4, 4)
    assert torch.equal(block.drop(x), x * (1 - 0.01))
    block.drop.train()
    block.drop.drop.p = 0.0
    assert torch.equal(block.drop(x), x * (1 - 0.01))


def test_multiview_numpy_is_jax_s():
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(-1, 1, (200, 2)),
                          rng.uniform(1.5, 2.5, (200, 1))], axis=1)
    frames, label_frames = [], []
    for i in range(3):
        pose = np.eye(4)
        pose[:3, 3] = rng.normal(0, 0.1, 3)
        depth = rng.uniform(1.5, 2.5, (8, 10)).astype(np.float32)
        frames.append((rng.normal(size=(8, 10, 16)).astype(np.float32),
                       depth, pose))
        label_frames.append((rng.integers(0, 41, (8, 10)), depth, pose))
    proj = dict(intrinsics=np.array([[5.0, 0, 5], [0, 5, 4], [0, 0, 1]]),
                image_dims=(10, 8), occ_threshold=0.5)
    np.testing.assert_array_equal(
        port_mv.maxpool_multiview_features(
            pts, frames, port_mv.ProjectionHelper(**proj)),
        jax_mv.maxpool_multiview_features(
            pts, frames, jax_mv.ProjectionHelper(**proj)))
    got = port_mv.vote_multiview_labels(pts, label_frames,
                                        projector=port_mv.ProjectionHelper(
                                            **proj))
    np.testing.assert_array_equal(got, jax_mv.vote_multiview_labels(
        pts, label_frames, projector=jax_mv.ProjectionHelper(**proj)))
    assert (got > 0).any() and (got == 0).any()


def _frames(root):
    """2 scenes of 48 x 64 pixel frames: uint8 RGB in one, one frame more
    than an ENet launch takes (so the CLI splits it into two launches),
    and 3 float frames in the other; depth 2 m, poses near the identity;
    300 points a scene on the z = 2 plane, 20 of them outside every
    frustum."""
    from vlp3d_torch.cli.compute_multiview import FRAMES_PER_LAUNCH

    rng = np.random.default_rng(6)
    frames = root / "frames"
    data = root / "scannet"
    data.mkdir(parents=True)
    for s, scene in enumerate(("scene0000_00", "scene0001_00")):
        sdir = frames / scene
        for sub in ("color", "depth", "pose", "label"):
            (sdir / sub).mkdir(parents=True)
        for f in range(FRAMES_PER_LAUNCH + 1 if s == 0 else 3):
            rgb = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
            if s == 0:
                rgb = (rgb * 255).astype(np.uint8)
            np.save(sdir / "color" / f"{f:03d}.npy", rgb)
            np.save(sdir / "depth" / f"{f:03d}.npy",
                    np.full((48, 64), 2.0, np.float32))
            np.save(sdir / "label" / f"{f:03d}.npy",
                    rng.integers(0, 41, (6, 8)))
            pose = np.eye(4)
            pose[:2, 3] = rng.normal(0, 0.05, 2)
            np.savetxt(sdir / "pose" / f"{f:03d}.txt", pose)
        pts = np.concatenate([rng.uniform(-0.9, 0.9, (300, 2)),
                              np.full((300, 1), 2.0)], axis=1)
        pts[:20, 0] = 40.0
        verts = np.concatenate([pts, np.zeros((300, 3))], axis=1)
        np.save(data / f"{scene}_aligned_vert.npy", verts.astype(np.float32))
    return str(frames), str(data)


CAMERA = ["--fx", "60", "--fy", "60", "--cx", "32", "--cy", "24"]


def test_cli_hdf5_matches_jax_cli(tmp_path):
    import h5py
    from vlp3d.cli.compute_multiview import main as jax_main
    from vlp3d.train import checkpoint as jax_ckpt
    from vlp3d_torch.cli.compute_multiview import main as port_main
    from vlp3d_torch.data.hdf5 import read_datasets

    frames, data = _frames(tmp_path)
    params, stats = _seeded(seed=7)
    jax_ckpt.save_params(str(tmp_path / "ckpt"), "enet", params, stats)
    jax_ckpt.wait_until_finished()
    jax_main(["--frames_dir", frames, "--scannet_data", data, "--out",
              str(tmp_path / "jax.hdf5"), "--enet_checkpoint",
              str(tmp_path / "ckpt" / "enet"), *CAMERA])
    sd = convert.enet_to_torch_state_dict(params, stats)
    torch.save(sd, tmp_path / "enet.pth")
    model = ENetEncoder(device="cpu")
    model.load_state_dict(sd)
    torch.save(_reference_layout(model.state_dict()), tmp_path / "ref.pth")
    outs = {}
    for name in ("enet", "ref"):
        out = str(tmp_path / f"{name}.hdf5")
        assert port_main(["--frames_dir", frames, "--scannet_data", data,
                          "--out", out, "--enet_checkpoint",
                          str(tmp_path / f"{name}.pth"), "--device", "cpu",
                          *CAMERA]) == out
        outs[name] = out
    with h5py.File(tmp_path / "jax.hdf5") as f:
        want = {k: np.asarray(f[k]) for k in f}
    assert sorted(want) == ["scene0000_00", "scene0001_00"]
    for out in outs.values():
        mine = read_datasets(out)  # the port's reader
        with h5py.File(out) as f:
            assert sorted(f) == sorted(mine) == sorted(want)
            for scene, w in want.items():
                got = np.asarray(f[scene])
                np.testing.assert_array_equal(mine[scene], got)
                assert got.shape == (300, 128) and got.dtype == np.float32
                _close(got, w)
                seen = np.abs(w).sum(1) > 0
                np.testing.assert_array_equal(np.abs(got).sum(1) > 0, seen)
                assert not seen[:20].any() and seen[20:].mean() > 0.8


def test_cli_without_a_checkpoint_seeds_its_weights(tmp_path):
    import h5py
    from vlp3d_torch.cli.compute_multiview import main as port_main

    frames, data = _frames(tmp_path)
    got = []
    for i in range(2):
        out = str(tmp_path / f"seeded{i}.hdf5")
        port_main(["--frames_dir", frames, "--scannet_data", data, "--out",
                   out, "--device", "cpu", "--max_frames", "2", *CAMERA])
        with h5py.File(out) as f:
            got.append({k: np.asarray(f[k]) for k in f})
    for scene in got[0]:
        np.testing.assert_array_equal(got[0][scene], got[1][scene])
        assert np.isfinite(got[0][scene]).all()


def test_cli_labels_equal_jax_cli(tmp_path):
    from vlp3d.cli.compute_multiview import main as jax_main
    from vlp3d_torch.cli.compute_multiview import main as port_main

    frames, data = _frames(tmp_path)
    args = ["--frames_dir", frames, "--scannet_data", data, "--labels",
            *CAMERA]
    jax_main(args + ["--out", str(tmp_path / "jax" / "labels.hdf5")])
    written = port_main(args + ["--out", str(tmp_path / "port" /
                                                "labels.hdf5")])
    assert len(written) == 2
    for scene in ("scene0000_00", "scene0001_00"):
        for ext in ("npy", "ply"):
            name = f"{scene}_multiview_labels.{ext}"
            want = (tmp_path / "jax" / name).read_bytes()
            assert (tmp_path / "port" / name).read_bytes() == want, name
        labels = np.load(tmp_path / "port" / f"{scene}_multiview_labels.npy")
        assert (labels[:20] == 0).all() and (labels[20:] > 0).any()


def test_hdf5_writer_is_what_h5py_reads(tmp_path):
    """vlp3d_torch.data.hdf5 writes the file without h5py: h5py reads
    every dataset back bit for bit (datasets added in any order, 1600 of
    them in one symbol-table node, none), and so does the port's reader,
    as read-only memory maps; the reader refuses a file of another
    layout (h5py's own, whose group B-tree has several levels)."""
    import h5py

    from vlp3d_torch.data.hdf5 import DatasetWriter, read_datasets

    def write_datasets(path, datasets):
        with DatasetWriter(path) as w:
            for k, v in datasets.items():
                w.add(k, v)

    rng = np.random.default_rng(8)
    data = {f"scene{i:04d}_00": rng.normal(size=(50 + i, 128)).astype(
        np.float32) for i in range(11)}
    path = tmp_path / "port.hdf5"
    with DatasetWriter(str(path)) as w:
        for k in reversed(sorted(data)):
            w.add(k, data[k])
    for libver in (None, "latest"):  # the dataset loader opens "latest"
        with h5py.File(path, "r", libver=libver) as f:
            assert sorted(f) == sorted(data)
            for k, v in data.items():
                assert f[k].dtype == np.float32
                np.testing.assert_array_equal(np.asarray(f[k]), v)
    many = {f"s{i:04d}": np.full((3, 2), i, np.float32) for i in range(1600)}
    write_datasets(str(tmp_path / "many.hdf5"), many)
    with h5py.File(tmp_path / "many.hdf5", "r") as f:
        assert len(f) == 1600 and float(f["s1599"][2, 1]) == 1599.0
    got = read_datasets(str(tmp_path / "many.hdf5"))
    assert list(got) == sorted(many)
    assert all(float(got[f"s{i:04d}"][1, 0]) == i for i in range(1600))
    write_datasets(str(tmp_path / "none.hdf5"), {})
    with h5py.File(tmp_path / "none.hdf5", "r") as f:
        assert len(f) == 0
    assert read_datasets(str(tmp_path / "none.hdf5")) == {}
    theirs = tmp_path / "h5py.hdf5"
    with h5py.File(theirs, "w") as f:
        for i in range(700):
            f.create_dataset(f"s{i:04d}", data=np.full((2, 3), i, np.float32))
    with pytest.raises(ValueError, match="not the one leaf"):
        read_datasets(str(theirs))
    mine = read_datasets(str(path))
    assert sorted(mine) == sorted(data)
    for k, v in mine.items():
        assert isinstance(v, np.memmap) and not v.flags.writeable
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, data[k])
    with pytest.raises(ValueError, match="name"):
        write_datasets(str(tmp_path / "bad.hdf5"), {"a/b": data["scene0000_00"]})
