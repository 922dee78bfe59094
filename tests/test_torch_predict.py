"""The pred.json CLI and the grounding evaluation CLI of the port against
the JAX package's, on the CPU.

``vlp3d.cli.predict.main(["--synthetic", "--smoke", ...])`` runs the JAX
model from its seeded train state. That state, rebuilt as the JAX CLI
builds it, goes through ``convert.jax_to_torch_state_dict`` into the
port's ``save_params`` snapshot, and ``vlp3d_torch.cli.predict.main``
runs over the same synthetic val split with ``--model_dir`` on the CPU.
The records must be equal (scene, object, annotation, unique/multiple,
others), the chosen proposals equal, and the boxes within 1e-4. The
port's ``ground_eval`` on the same weights must give the JAX CLI's
numbers within 1e-6. HashTokenizer ids agree only within one process,
so both CLIs run here.
"""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

import vlp3d_torch.cli.predict as port_predict
from vlp3d.cli.common import add_common_args, build_datasets, resolve_config
from vlp3d.cli.ground_eval import main as jax_ground_eval
from vlp3d.cli.predict import main as jax_predict
from vlp3d.data.dataset import BatchIterator
from vlp3d.models.jointnet import JointNet
from vlp3d.train.optimizer import make_optimizer
from vlp3d.train.state import create_state
from vlp3d_torch.cli.ground_eval import main as port_ground_eval
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.train.checkpoint import save_params

ARGS = ["--synthetic", "--smoke", "--no_caption", "--num_workers", "2"]
BOX_TOL = 1e-4
EVAL_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_state(argv):
    """The JAX predict CLI's seeded state, built as vlp3d/cli/predict.py
    builds it (:35-43)."""
    p = argparse.ArgumentParser()
    add_common_args(p)
    args = p.parse_args(argv)
    config = resolve_config(args)
    _, val_ds = build_datasets(args, config)
    sample = next(iter(BatchIterator(val_ds, config.train.batch_size,
                                     drop_last=False)))
    sample = {k: v for k, v in sample.items() if not isinstance(v, list)}
    return create_state(JointNet(config), make_optimizer(), sample,
                        config.train.seed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX records, JAX chosen proposals a batch, port records, port
    chosen proposals a batch, model dir)."""
    tmp = tmp_path_factory.mktemp("predict")
    jax_out, port_out = str(tmp / "jax.json"), str(tmp / "port.json")
    model_dir = str(tmp / "run")

    # the JAX CLI's outputs a batch, read where it copies them to the host
    jax_chosen, get = [], jax.device_get

    def recording(x):
        x = get(x)
        if isinstance(x, dict) and "cluster_ref" in x:
            b, k = x["pred_center"].shape[:2]
            conf = x["cluster_ref"].reshape(b, -1, k)
            masks = np.argmax(x["objectness_scores"], -1)
            jax_chosen.append(np.argmax(conf * masks[:, None, :], axis=-1))
        return x

    jax.device_get = recording
    try:
        jax_records = jax_predict(ARGS + ["--out", jax_out])
    finally:
        jax.device_get = get

    state = jax.device_get(_jax_state(ARGS))
    save_params(model_dir, "model",
                jax_to_torch_state_dict(state.params, state.batch_stats))

    port_chosen, predict_batch = [], port_predict.predict_batch

    def recording_batch(model, batch, device):
        got = predict_batch(model, batch, device)
        port_chosen.append(got["chosen"])
        return got

    port_predict.predict_batch = recording_batch
    try:
        port_records = port_predict.main(
            ARGS + ["--model_dir", model_dir, "--device", "cpu",
                    "--out", port_out])
    finally:
        port_predict.predict_batch = predict_batch
    assert json.load(open(jax_out)) == jax_records
    assert json.load(open(port_out)) == port_records
    return jax_records, jax_chosen, port_records, port_chosen, model_dir


def test_pred_json_equals_the_jax_cli(runs):
    jax_records, jax_chosen, port_records, port_chosen, _ = runs
    assert len(port_records) == len(jax_records) > 0
    worst = 0.0
    for want, got in zip(jax_records, port_records):
        assert set(got) == set(want)
        for k in ("scene_id", "object_id", "ann_id", "unique_multiple",
                  "others"):
            assert got[k] == want[k], k
        bbox = np.asarray(got["bbox"])
        assert bbox.shape == (8, 3)
        err = np.abs(bbox - np.asarray(want["bbox"])).max()
        worst = max(worst, float(err))
    assert worst <= BOX_TOL, worst
    assert len(port_chosen) == len(jax_chosen) > 0
    for want, got in zip(jax_chosen, port_chosen):
        np.testing.assert_array_equal(got, want)


def test_ground_eval_equals_the_jax_cli(runs):
    model_dir = runs[-1]
    want = jax_ground_eval(ARGS)  # the same seeded state as predict's
    got = port_ground_eval(ARGS + ["--model_dir", model_dir, "--device",
                                   "cpu"])
    assert set(got) == set(want)
    assert want["overall_count"] > 0
    for k, w in want.items():
        assert abs(got[k] - w) <= EVAL_TOL, (k, got[k], w)


def test_ground_eval_detection_map_names_its_roadmap_item(runs):
    """--detection_map raised naming A16 until A16 ported
    vlp3d/eval/detection.py; it now gives the JAX CLI's mAP@0.25 / 0.5
    (within 1e-6, as the rest of ground_eval's numbers) on the same
    weights."""
    model_dir = runs[-1]
    want = jax_ground_eval(ARGS + ["--detection_map"])
    got = port_ground_eval(ARGS + ["--model_dir", model_dir, "--device",
                                   "cpu", "--detection_map"])
    assert set(got) == set(want)
    for k in ("mAP@0.25", "mAP@0.5"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= EVAL_TOL, k


def test_predict_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_predict.main(ARGS + ["--out", os.devnull])


# --tp and --zero1 raised here until the slice that ported them (the
# test keeps its name). As in the JAX package, only the training CLIs
# read them (tests/test_torch_tensor_parallel.py and test_torch_zero.py
# train with them); the evaluation CLIs share the parser, accept them and
# do nothing: the run is the one without them.
@pytest.mark.parametrize("flag", [
    [port_predict.main, "--tp", "2"], [port_predict.main, "--zero1"],
    [port_ground_eval, "--tp", "4"], [port_ground_eval, "--zero1"],
    [port_predict.main, "--tp", "2", "--zero1"],
    [port_ground_eval, "--zero1", "--grad_accum", "2"]])
def test_unported_run_flags_raise_with_their_roadmap_item(flag, tmp_path):
    main, argv = flag[0], flag[1:]
    if main is port_predict.main:
        a, b = tmp_path / "a.json", tmp_path / "b.json"
        main(ARGS + ["--device", "cpu", "--out", str(a)])
        main(ARGS + argv + ["--device", "cpu", "--out", str(b)])
        assert a.read_text() == b.read_text()
        return
    want = main(ARGS + ["--device", "cpu"])
    got = main(ARGS + argv + ["--device", "cpu"])
    assert set(got) == set(want) and all(
        np.array_equal(got[k], want[k], equal_nan=True) for k in want)
