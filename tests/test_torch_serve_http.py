"""The port's HTTP grounding server (vlp3d_torch/serve.py, cli/serve.py)
on the CPU: wire format, micro-batching and consistency with the direct
predictor, the ground-task counterpart of tests/test_serve_http.py.

A real ThreadingHTTPServer on an ephemeral port serves the tiny
synthetic config (seeded weights) and urllib drives it. The request
parsing (nested list or b64 clouds, xyz-only clouds with the derived
height channel, the seeded choice-with-replacement resampling) must give
arrays equal to the JAX package's ``vlp3d.serve._parse_point_cloud`` on
the same request, and reject the same bad ones.
"""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from vlp3d.serve import BadRequest as JaxBadRequest
from vlp3d.serve import _parse_point_cloud as jax_parse_point_cloud
from vlp3d_torch.cli import serve as serve_cli
from vlp3d_torch.data.synthetic import tiny_config
from vlp3d_torch.serve import (
    BadRequest,
    InferenceService,
    MicroBatcher,
    _parse_point_cloud,
    make_server,
)
from vlp3d_torch.serving import STREAM_KEYS

BATCH = 2
NPTS = 256
BOX_TOL = 1e-6  # the same CPU arithmetic on the same rows


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    config = tiny_config(no_caption=True, use_con=False)
    return dataclasses.replace(
        config, dataset=dataclasses.replace(config.dataset, num_points=NPTS))


@pytest.fixture(scope="module")
def ground_service():
    config = _config()
    service = InferenceService(config, batch_size=BATCH,
                               max_wait_ms=30.0, device="cpu")
    server = make_server(service)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield service, server.server_address[1], config
    server.shutdown()
    server.server_close()
    service.close()
    t.join(timeout=10)


def _post(port, route, payload, timeout=120):
    body = payload if isinstance(payload, bytes) else json.dumps(
        payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=body,
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, route):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=30) as r:
        return json.loads(r.read())


def _scene(seed, n=NPTS, channels=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 4, size=(n, channels)).astype(np.float32)


def _b64(pc):
    return {"b64": base64.b64encode(pc.astype("<f4").tobytes()).decode(),
            "shape": list(pc.shape)}


def test_health(ground_service):
    _, port, config = ground_service
    h = _get(port, "/healthz")
    assert h == {"status": "ok", "task": "ground", "num_points": NPTS,
                 "point_channels": 3 + config.model.input_feature_dim,
                 "lang_num_max": config.model.lang_num_max,
                 "batch_size": BATCH}


@pytest.mark.parametrize("queries", [["the red chair"],
                                     ["a table", "the bed by the door",
                                      "chair"]])
def test_ground_roundtrip_matches_direct_predictor(ground_service, queries):
    service, port, config = ground_service
    pc = _scene(0, channels=3 + config.model.input_feature_dim)
    resp = _post(port, "/v1/ground",
                 {"point_cloud": pc.tolist(), "queries": queries})
    assert len(resp["boxes"]) == len(queries)

    # the same cloud and queries through the predictor, outside the server
    item, n = service._make_item({"point_cloud": pc.tolist(),
                                  "queries": queries})
    ref = service._pred.run_padded(
        {k: np.asarray(item[k])[None] for k in STREAM_KEYS})
    for q, box in enumerate(resp["boxes"]):
        p = int(ref["pred_ref"][0, q])
        assert box["proposal"] == p
        np.testing.assert_allclose(box["center"], ref["pred_center"][0, p],
                                   atol=BOX_TOL)
        np.testing.assert_allclose(box["size"], ref["pred_size"][0, p],
                                   atol=BOX_TOL)
        assert abs(box["heading"] - ref["pred_heading"][0, p]) <= BOX_TOL


# (points, channels, wire): full-width and xyz-only clouds, as nested
# lists and as b64, at the model's N, below it (resampled with
# replacement) and above it (without)
PARSE_CASES = [(NPTS, "full", "list"), (NPTS, "full", "b64"),
               (NPTS, "xyz", "list"), (NPTS, "xyz", "b64"),
               (NPTS - 57, "full", "b64"), (NPTS + 37, "xyz", "b64"),
               (NPTS + 300, "full", "list"), (5, "xyz", "list")]


@pytest.mark.parametrize("n,channels,wire", PARSE_CASES)
def test_parse_point_cloud_equals_jax(n, channels, wire):
    in_dim = _config().model.input_feature_dim
    pc = _scene(n, n=n, channels=3 if channels == "xyz" else 3 + in_dim)
    req = {"point_cloud": _b64(pc) if wire == "b64" else pc.tolist()}
    got = _parse_point_cloud(req, NPTS, in_dim)
    want = jax_parse_point_cloud(req, NPTS, in_dim)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if channels == "xyz":  # the derived height channel, other features 0
        floor = np.percentile(pc[:, 2], 0.99)
        np.testing.assert_allclose(got[:, -1], got[:, 2] - floor, atol=1e-6)
        assert not got[:, 3:-1].any()


BAD_CLOUDS = [
    {},
    {"point_cloud": [[0.0, 1.0]]},
    {"point_cloud": [[0.0, 0.0, 0.0], [0.0, 0.0]]},
    {"point_cloud": []},
    {"point_cloud": {"b64": "AAAA", "shape": [3, 3]}},
    {"point_cloud": {"shape": [1, 3]}},
]


@pytest.mark.parametrize("req", BAD_CLOUDS)
def test_parse_point_cloud_rejects_what_jax_rejects(req):
    in_dim = _config().model.input_feature_dim
    with pytest.raises(JaxBadRequest):
        jax_parse_point_cloud(req, NPTS, in_dim)
    with pytest.raises(BadRequest):
        _parse_point_cloud(req, NPTS, in_dim)


def test_b64_and_xyz_only_requests_round_trip(ground_service):
    service, port, _ = ground_service
    pc = _scene(1, n=NPTS + 37, channels=3)
    payload = {"point_cloud": _b64(pc), "queries": ["the table by the window"]}
    resp = _post(port, "/v1/ground", payload)
    assert resp == service.handle(payload)


def test_concurrent_requests_coalesce(ground_service):
    service, port, _ = ground_service
    before = service.stats()
    results = [None] * 4
    go = threading.Barrier(4)

    def call(i):
        go.wait(timeout=30)
        results[i] = _post(port, "/v1/ground", {
            "point_cloud": _scene(10 + i).tolist(),
            "queries": [f"object {i}"]})

    ts = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert all(r is not None and len(r["boxes"]) == 1 for r in results)
    after = service.stats()
    assert after["requests"] - before["requests"] == 4
    # four requests, two a batch: at least two device batches, and within
    # the 30 ms window usually exactly two
    assert 2 <= after["device_batches"] - before["device_batches"] <= 4
    lat, bt = after["latency_ms"], after["batch_ms"]
    assert lat["p50"] is not None and lat["p50"] <= lat["p99"]
    assert bt["p50"] is not None and bt["p50"] <= bt["p99"]
    assert after["mean_occupancy"] >= 1.0


BAD_REQUESTS = [
    {},  # no point cloud
    {"point_cloud": [[0.0, 1.0]], "queries": ["x"]},  # bad width
    {"point_cloud": _scene(3).tolist()},  # ground needs queries
    {"point_cloud": _scene(4).tolist(), "queries": ["a"] * 5},  # > lang_num_max
    {"point_cloud": [[0.0, 0.0, 0.0], [0.0, 0.0]], "queries": ["x"]},
    {"point_cloud": [], "queries": ["x"]},
    {"point_cloud": _scene(4).tolist(), "queries": "not a list"},
]


@pytest.mark.parametrize("payload", BAD_REQUESTS)
def test_bad_requests_400(ground_service, payload):
    _, port, _ = ground_service
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/v1/ground", payload)
    assert ei.value.code == 400
    assert "error" in json.loads(ei.value.read())


@pytest.mark.parametrize("body", [b"not json", b"[1, 2, 3]", b'"a string"'])
def test_malformed_bodies_400(ground_service, body):
    _, port, _ = ground_service
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/v1/ground", body)
    assert ei.value.code == 400


@pytest.mark.parametrize("route", ["/v1/caption", "/v1/answer", "/v2/ground"])
def test_unknown_route_404(ground_service, route):
    _, port, _ = ground_service
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, route, {"point_cloud": _scene(5).tolist()})
    assert ei.value.code == 404


def test_submit_after_close_raises():
    b = MicroBatcher(lambda items: [{} for _ in items], 2, 5.0)
    assert b.submit({"x": 1}) == {}
    b.close()
    with pytest.raises(RuntimeError):
        b.submit({"x": 2})


def test_microbatcher_occupancy_and_propagates_errors():
    calls = []

    def run(items):
        calls.append(len(items))
        if items[0].get("boom"):
            raise RuntimeError("kaput")
        return [{"i": it["i"]} for it in items]

    mb = MicroBatcher(run, batch_size=4, max_wait_ms=1.0)
    try:
        assert mb.submit({"i": 42})["i"] == 42
        assert calls[-1] == 1  # only the occupied items reach run_batch
        with pytest.raises(RuntimeError, match="kaput"):
            mb.submit({"boom": True, "i": 0})
        assert mb.submit({"i": 7})["i"] == 7  # survives a failed batch
    finally:
        mb.close()


def test_service_warmup_runs_one_batch(ground_service):
    service, _, _ = ground_service
    before = service.stats()["device_batches"]
    service.warmup()
    assert service.stats()["device_batches"] == before + 1


@pytest.mark.parametrize("task,item", [("caption", "A16"), ("answer", "A17")])
def test_service_for_other_tasks_names_its_roadmap_item(ground_service, task,
                                                        item):
    """The JAX server's other task routes answer 404, naming the ROADMAP
    item they wait for."""
    _, port, _ = ground_service
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, f"/v1/{task}", {"queries": ["the chair"]})
    assert ei.value.code == 404
    assert item in json.loads(ei.value.read())["error"]


def test_serve_cli_build_and_roundtrip(tmp_path):
    """parse_args + build_server on the tiny --smoke config with a
    save_params snapshot as --model_dir, one HTTP round trip, clean
    shutdown."""
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.train.checkpoint import save_params

    config = tiny_config(no_caption=True, use_con=False)
    model = JointNet(config, device="cpu")
    with torch.no_grad():  # weights that differ from the seeded ones
        model.match.match[0].weight.mul_(-1.0)
    save_params(str(tmp_path), "model", model.state_dict())
    args, tasks = serve_cli.parse_args(
        ["--smoke", "--no_caption", "--port", "0", "--serve_batch_size",
         str(BATCH), "--model_dir", str(tmp_path), "--device", "cpu",
         "--compile_cache_dir", str(tmp_path / "unused")])
    assert tasks == ("ground",)
    server, services = serve_cli.build_server(args, tasks)
    assert torch.equal(services["ground"]._pred.model.match.match[0].weight,
                       model.match.match[0].weight)
    assert services["ground"].stats()["device_batches"] == 1  # warm-up
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]
        h = _get(port, "/healthz")
        assert h["status"] == "ok" and h["task"] == "ground"
        payload = {"point_cloud": _scene(11, n=h["num_points"]).tolist(),
                   "queries": ["the desk"]}
        resp = _post(port, "/v1/ground", payload)
        assert resp == services["ground"].handle(payload)
    finally:
        server.shutdown()
        server.server_close()
        for s in services.values():
            s.close()
        t.join(timeout=10)


@pytest.mark.parametrize("argv,err,match", [
    (["--task", "caption"], NotImplementedError, "A16"),
    (["--task", "answer"], NotImplementedError, "A17"),
    (["--task", "all"], NotImplementedError, "A16"),
    (["--data_devices", "2"], NotImplementedError, "A18"),
])
def test_serve_cli_rejects_unported_tasks_and_devices(argv, err, match):
    args, tasks = serve_cli.parse_args(
        ["--smoke", "--device", "cpu", "--port", "0"] + argv)
    with pytest.raises(err, match=match):
        serve_cli.build_server(args, tasks)


def test_serve_cli_rejects_an_unknown_task():
    with pytest.raises(SystemExit):
        serve_cli.parse_args(["--task", "detect"])
