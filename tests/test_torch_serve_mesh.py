"""Serving over a mesh of devices on the CPU: vlp3d_torch.parallel.mesh,
the predictors' ``devices``, the inference service and the serve CLI's
``--data_devices``, against the same predictors on one device.

The CPU gives one device, so the mesh here is ``["cpu", "cpu"]``: two
replicas of the weights, each batch's rows split between them, the
outputs concatenated back in row order. A replica's forward over half
the rows is the one-device forward's rows up to the matmuls' blocking:
indices, ids and chosen proposals equal, floats within 1e-5 (absolute,
on values of order 1-10).
"""

import numpy as np
import pytest
import torch

from vlp3d_torch.cli import serve as serve_cli
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.parallel.mesh import (
    local_devices,
    make_mesh,
    make_mesh_for_batch,
    shard_batch,
)
from vlp3d_torch.serve import InferenceService
from vlp3d_torch.serving import (
    STREAM_KEYS,
    AnswerPredictor,
    CaptionPredictor,
    GroundingPredictor,
)

BATCH = 4
MESH = ["cpu", "cpu"]
FLOAT_TOL = 1e-5
CONFIG = tiny_config(use_con=False, no_caption=True)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(seed):
    b = make_batch(CONFIG, batch_size=BATCH, num_points=256, seed=seed,
                   istrain=0)
    return {k: b[k] for k in STREAM_KEYS}


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k], w, atol=FLOAT_TOL, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_cpu_mesh_helpers():
    assert make_mesh(0, "cpu") == [torch.device("cpu")]
    assert make_mesh(None, "cpu") == local_devices("cpu")
    assert make_mesh_for_batch(BATCH, "cpu") == [torch.device("cpu")]
    batch = {"point_clouds": np.arange(24.0).reshape(4, 3, 2),
             "lang_num": np.array([1, 2, 3, 4]), "epoch": np.int32(5),
             "scene_id": ["a", "b", "c", "d"]}
    parts = shard_batch(MESH, batch)
    assert len(parts) == 2 and set(parts[0]) == {"point_clouds", "lang_num",
                                                 "epoch"}
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(p["point_clouds"].numpy(),
                                      batch["point_clouds"][2 * i:2 * i + 2])
        assert int(p["epoch"]) == 5
    with pytest.raises(ValueError, match="not divisible by the 3-device"):
        shard_batch(["cpu"] * 3, batch)


def test_cuda_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(0)


@pytest.mark.parametrize("cls", [GroundingPredictor, CaptionPredictor,
                                 AnswerPredictor])
def test_predictor_over_two_devices_equals_one(cls):
    """A list of batches and every occupancy of run_padded (the padding
    repeats row 0, also on the device whose block holds no real row)."""
    one = cls(CONFIG, batch_size=BATCH, device="cpu")
    two = cls(CONFIG, one.model.state_dict() if cls is GroundingPredictor
              else None, batch_size=BATCH, devices=MESH)
    assert len(two.models) == 2 and two.device == torch.device("cpu")
    batches = [_scenes(3), _scenes(4)]
    for got, want in zip(two(batches), one(batches)):
        _same(got, want)
    for k in range(1, BATCH + 1):
        occ = {key: v[:k] for key, v in batches[0].items()}
        _same(two.run_padded(occ), one.run_padded(occ))


def test_mesh_batch_size_must_divide():
    """JAX's check and message (vlp3d/serving.py:_StreamingPredictor)."""
    from vlp3d.config import Config as JaxConfig
    from vlp3d.parallel.mesh import make_mesh as jax_make_mesh
    from vlp3d.serving import GroundingPredictor as JaxGroundingPredictor

    with pytest.raises(ValueError) as want:
        JaxGroundingPredictor(JaxConfig(), None, batch_size=3,
                              mesh=jax_make_mesh(2))
    with pytest.raises(ValueError) as got:
        GroundingPredictor(CONFIG, batch_size=3, devices=MESH)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="device or devices"):
        GroundingPredictor(CONFIG, batch_size=4, device="cpu", devices=MESH)


def test_service_over_two_devices_answers_as_one():
    """The micro-batcher's device batches through a two-device predictor:
    each request's answer equals the one-device service's."""
    reqs = [{"point_cloud": np.random.default_rng(i).uniform(
        0, 4, (300, 3)).round(3).tolist(),
             "queries": ["the brown chair", "a table by the door"][:1 + i % 2]}
            for i in range(3)]
    answers = []
    for place in ({"device": "cpu"}, {"devices": MESH}):
        svc = InferenceService(CONFIG, batch_size=BATCH, **place)
        try:
            answers.append([svc.handle(r) for r in reqs])
        finally:
            svc.close()
    for got, want in zip(*answers):
        assert [b["proposal"] for b in got["boxes"]] == [
            b["proposal"] for b in want["boxes"]]
        for gb, wb in zip(got["boxes"], want["boxes"]):
            np.testing.assert_allclose(gb["center"], wb["center"],
                                       atol=FLOAT_TOL)


def test_serve_cli_data_devices_zero_serves_on_the_cpu():
    """--data_devices 0 takes every local device: on the CPU the one CPU,
    as JAX's one-device mesh on a one-card host; the server answers."""
    args, tasks = serve_cli.parse_args(
        ["--smoke", "--device", "cpu", "--port", "0", "--data_devices", "0",
         "--serve_batch_size", "2", "--no_warmup"])
    server, services = serve_cli.build_server(args, tasks)
    try:
        pred = services["ground"]._pred
        assert pred.devices == [torch.device("cpu")]
        out = services["ground"].handle({
            "point_cloud": np.zeros((64, 3)).tolist(),
            "queries": ["the chair"]})
        assert len(out["boxes"]) == 1
    finally:
        server.server_close()
        for s in services.values():
            s.close()


@pytest.mark.parametrize("n", [3, -2])
def test_serve_cli_data_devices_beyond_the_host_exits(n):
    args, tasks = serve_cli.parse_args(
        ["--smoke", "--device", "cpu", "--port", "0", "--data_devices",
         str(n)])
    with pytest.raises(SystemExit, match=f"--data_devices {n} invalid: "
                                         "this host exposes 1 device"):
        serve_cli.build_server(args, tasks)
