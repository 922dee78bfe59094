"""The grounding and heatmap visualizer CLIs of the port against the JAX
package's, on the CPU.

``vlp3d.cli.{ground,heatmap}_visualize.main(["--synthetic", "--smoke",
...])`` runs the JAX model from its seeded train state; that state,
recorded where the JAX CLI builds it, goes through
``convert.jax_to_torch_state_dict`` into a ``save_params`` snapshot, and
the port's CLI runs over the same synthetic val split with
``--model_dir`` on the CPU. Both write the same set of files; each
``pred_*`` name has the same object, name and annotation and a score and
IoU within 1e-4; every PLY / OBJ vertex is within 1e-4 and every
colour (a heatmap's int(255 x min(1, 5 x attention)) too) equal.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import vlp3d.train.state as jax_state
from vlp3d.cli.ground_visualize import main as jax_ground
from vlp3d.cli.heatmap_visualize import main as jax_heatmap
from vlp3d_torch.cli.ground_visualize import main as port_ground
from vlp3d_torch.cli.heatmap_visualize import main as port_heatmap
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.train.checkpoint import save_params

ARGS = ["--synthetic", "--smoke", "--num_workers", "2"]
VERTEX_TOL = 1e-4
NAME_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test writes snapshots of ~130-450 MB (BERT's 30522-word
    embedding); remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def run_jax_cli(main, argv, model_dir, monkeypatch):
    """The JAX CLI's run, its seeded state recorded where it builds it and
    saved, converted, as the port's snapshot under ``model_dir``."""
    states, create = [], jax_state.create_state

    def recording(*a, **k):
        states.append(create(*a, **k))
        return states[-1]

    monkeypatch.setattr(jax_state, "create_state", recording)
    n = main(argv)
    monkeypatch.setattr(jax_state, "create_state", create)
    state = jax.device_get(states[-1])
    save_params(model_dir, "model",
                jax_to_torch_state_dict(state.params, state.batch_stats))
    return n


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def read_rows(path):
    """(vertex rows (V, k) float, the rest of the lines) of a PLY or
    OBJ."""
    text = open(path).read().splitlines()
    if path.endswith(".obj"):
        rows = [list(map(float, ln.split()[1:])) for ln in text
                if ln.startswith("v ")]
        return np.asarray(rows), [ln for ln in text if not ln.startswith("v ")]
    end = text.index("end_header")
    n = int(next(ln.split()[2] for ln in text if ln.startswith(
        "element vertex")))
    rows = [list(map(float, ln.split())) for ln in text[end + 1:end + 1 + n]]
    return np.asarray(rows), text[:end + 1] + text[end + 1 + n:]


def assert_same_dumps(want_dir, got_dir):
    """Every file of both trees: the header and edges equal, xyz within
    VERTEX_TOL, colours equal."""
    checked = 0
    for rel in files(want_dir):
        want, want_rest = read_rows(os.path.join(want_dir, rel))
        got, got_rest = read_rows(os.path.join(got_dir, rel))
        assert got_rest == want_rest, rel
        assert got.shape == want.shape, rel
        assert np.isfinite(got).all(), rel
        assert np.abs(got[:, :3] - want[:, :3]).max() <= VERTEX_TOL, rel
        assert np.array_equal(got[:, 3:], want[:, 3:]), rel
        checked += 1
    return checked


def pred_fields(name):
    """pred_{oid}_{name}_{ann}_{score}_{iou}.ply -> ((oid, name, ann),
    score, iou)."""
    parts = name[len("pred_"):-len(".ply")].split("_")
    return tuple(parts[:-2]), float(parts[-2]), float(parts[-1])


def test_ground_visualize_matches_the_jax_cli(tmp_path, monkeypatch):
    model_dir = str(tmp_path / "run")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    n_jax = run_jax_cli(jax_ground, ARGS + ["--out_dir", jax_dir,
                                            "--max_scenes", "2"],
                        model_dir, monkeypatch)
    n_port = port_ground(ARGS + ["--out_dir", port_dir, "--max_scenes", "2",
                                 "--model_dir", model_dir, "--device",
                                 "cpu"])
    assert n_port == n_jax == 2
    want, got = files(jax_dir), files(port_dir)
    want_pred = [f for f in want if os.path.basename(f).startswith("pred_")]
    got_pred = [f for f in got if os.path.basename(f).startswith("pred_")]
    assert len(got_pred) == len(want_pred) > 0
    assert [f for f in got if f not in got_pred] == [
        f for f in want if f not in want_pred]
    by_key = {}
    for rel in want_pred:
        key, score, iou = pred_fields(os.path.basename(rel))
        by_key[(os.path.dirname(rel), key)] = (rel, score, iou)
    for rel in got_pred:
        key, score, iou = pred_fields(os.path.basename(rel))
        want_rel, want_score, want_iou = by_key.pop((os.path.dirname(rel),
                                                     key))
        assert abs(score - want_score) <= NAME_TOL, (rel, want_rel)
        assert abs(iou - want_iou) <= NAME_TOL, (rel, want_rel)
        w, _ = read_rows(os.path.join(jax_dir, want_rel))
        g, _ = read_rows(os.path.join(port_dir, rel))
        assert np.abs(g - w).max() <= VERTEX_TOL, rel
        os.rename(os.path.join(port_dir, rel),
                  os.path.join(port_dir, want_rel))
    assert not by_key
    assert assert_same_dumps(jax_dir, port_dir) == len(want)


def test_heatmap_visualize_matches_the_jax_cli(tmp_path, monkeypatch):
    model_dir = str(tmp_path / "run")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    n_jax = run_jax_cli(jax_heatmap, ARGS + ["--out_dir", jax_dir,
                                             "--max_scenes", "1"],
                        model_dir, monkeypatch)
    n_port = port_heatmap(ARGS + ["--out_dir", port_dir, "--max_scenes",
                                  "1", "--model_dir", model_dir, "--device",
                                  "cpu"])
    assert n_port == n_jax == 1
    assert files(port_dir) == files(jax_dir)
    heatmaps = [f for f in files(jax_dir) if f.endswith(".ply")
                and not f.endswith("scene_scene.ply")]
    assert heatmaps and any(f.endswith("scene_pred.obj")
                            for f in files(jax_dir))
    assert assert_same_dumps(jax_dir, port_dir) == len(files(jax_dir))
