"""The port's HTTP server (vlp3d_torch/serve.py, cli/serve.py) on the
CPU: wire format, micro-batching and consistency with the direct
predictor for the ground, caption and answer tasks, the counterpart of
tests/test_serve_http.py.

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
    """A task route the server does not serve answers 404, naming the
    routes this ground-only server does serve. Both tasks are ported
    (captioning by A16, question answering by A17), so the error names
    no ROADMAP item any more; a server with the task answers it
    (test_caption_roundtrip_..., test_answer_roundtrip_...)."""
    _, port, _ = ground_service
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, f"/v1/{task}", {"queries": ["the chair"]})
    assert ei.value.code == 404
    error = json.loads(ei.value.read())["error"]
    assert "serving /v1/ground" in error
    assert item not in error and "ROADMAP" not in error


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


# Every task is served now (--task answer and all raised until the
# question-answering slice: test_serve_cli_builds_the_answer_task); what
# still raises is serving over more than one device and the parallel
# run-time flags.
@pytest.mark.parametrize("argv,err,match", [
    (["--data_devices", "2"], NotImplementedError, "A18"),
    (["--task", "answer", "--data_devices", "0"], NotImplementedError,
     "A18"),
    (["--task", "all", "--tp", "2"], NotImplementedError, "A19"),
    (["--zero1"], NotImplementedError, "A19"),
])
def test_serve_cli_rejects_unported_tasks_and_devices(argv, err, match):
    args, tasks = serve_cli.parse_args(
        ["--smoke", "--device", "cpu", "--port", "0"] + argv)
    with pytest.raises(err, match=match):
        serve_cli.build_server(args, tasks)


@pytest.mark.parametrize("task,routes", [
    ("answer", ("answer",)), ("caption,answer", ("caption", "answer")),
    ("all", ("ground", "caption", "answer"))])
def test_serve_cli_builds_the_answer_task(task, routes):
    """--task answer, a subset with it and all build their services
    (warm-up skipped); the model carries the answer head and the caption
    decoder only where those tasks are served."""
    args, tasks = serve_cli.parse_args(
        ["--smoke", "--device", "cpu", "--port", "0", "--task", task,
         "--no_warmup"])
    assert tasks == routes
    server, services = serve_cli.build_server(args, tasks)
    try:
        assert tuple(services) == routes
        for service in services.values():
            sd = service._pred.model.state_dict()
            assert any(k.startswith("answer.") for k in sd)
            assert any(k.startswith("caption.") for k in sd) == (
                "caption" in routes)
    finally:
        server.server_close()
        for s in services.values():
            s.close()


def test_serve_cli_rejects_an_unknown_task():
    with pytest.raises(SystemExit):
        serve_cli.parse_args(["--task", "detect"])


# ---------------------------------------------------------------- captioning


def _caption_config():
    config = tiny_config(no_caption=False, use_con=False)
    return dataclasses.replace(
        config, dataset=dataclasses.replace(config.dataset, num_points=NPTS))


@pytest.fixture(scope="module")
def two_tasks():
    """One server routing /v1/ground and /v1/caption over one model's
    weights, each task with its own micro-batching queue."""
    config = _caption_config()
    from vlp3d_torch.models import JointNet

    state = JointNet(config, device="cpu").state_dict()
    services = {task: InferenceService(config, state, task=task,
                                       batch_size=BATCH, max_wait_ms=30.0,
                                       device="cpu")
                for task in ("ground", "caption")}
    server = make_server(services)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield services, server.server_address[1], config
    server.shutdown()
    server.server_close()
    for s in services.values():
        s.close()
    t.join(timeout=10)


def _caption_reference(service, payload):
    """The caption predictor's answer on that cloud alone."""
    item, _ = service._make_item(payload)
    ref = service._pred.run_padded(
        {k: np.asarray(item[k])[None] for k in STREAM_KEYS})
    return {k: v[0] for k, v in ref.items()}


@pytest.mark.parametrize("queries", [None, ["the chair by the window"]])
def test_caption_roundtrip_matches_direct_predictor(two_tasks, queries):
    services, port, config = two_tasks
    service = services["caption"]
    pc = _scene(20, channels=3 + config.model.input_feature_dim)
    payload = {"point_cloud": _b64(pc)}
    if queries:
        payload["queries"] = queries
    resp = _post(port, "/v1/caption", payload)
    ref = _caption_reference(service, payload)
    props = resp["proposals"]
    assert len(props) == config.model.num_proposal
    assert ref["caption_ids"].shape == (config.model.num_proposal,
                                        config.model.max_des_len + 2)
    for k, p in enumerate(props):
        assert set(p) == {"center", "size", "heading", "objectness",
                          "sem_class", "caption"}
        assert p["caption"] == service.tokenizer.decode(
            ref["caption_ids"][k])
        np.testing.assert_allclose(p["center"], ref["pred_center"][k],
                                   atol=BOX_TOL)
        np.testing.assert_allclose(p["size"], ref["pred_size"][k],
                                   atol=BOX_TOL)
        assert p["objectness"] == int(np.argmax(ref["objectness_scores"][k]))
        assert p["sem_class"] == int(np.argmax(ref["sem_cls_scores"][k]))


def test_two_tasks_share_one_server(two_tasks):
    services, port, config = two_tasks
    h = _get(port, "/healthz")
    assert h["status"] == "ok" and set(h["tasks"]) == {"ground", "caption"}
    assert h["tasks"]["caption"]["task"] == "caption"
    pc = _scene(21, channels=3 + config.model.input_feature_dim).tolist()
    ground = _post(port, "/v1/ground", {"point_cloud": pc,
                                        "queries": ["the desk"]})
    assert len(ground["boxes"]) == 1
    before = _get(port, "/stats")
    results = [None] * 3
    go = threading.Barrier(3)

    def call(i):
        go.wait(timeout=30)
        results[i] = _post(port, "/v1/caption",
                           {"point_cloud": _scene(30 + i).tolist()})

    ts = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert all(r is not None and len(r["proposals"]) ==
               config.model.num_proposal for r in results)
    after = _get(port, "/stats")
    assert after["caption"]["requests"] - before["caption"]["requests"] == 3
    assert after["ground"]["requests"] == before["ground"]["requests"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/v1/answer", {"point_cloud": pc})
    assert ei.value.code == 404  # this server does not serve the task
    error = json.loads(ei.value.read())["error"]
    assert "serving /v1/caption, /v1/ground" in error and "A17" not in error


def test_caption_bad_requests_400(two_tasks):
    _, port, _ = two_tasks
    for payload in ({}, {"point_cloud": [[0.0, 1.0]]},
                    {"point_cloud": _scene(4).tolist(), "queries": "x"}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/caption", payload)
        assert ei.value.code == 400


def test_serve_cli_serves_ground_and_caption(tmp_path):
    """--task ground,caption over one save_params snapshot, beam decode
    flags accepted: both routes answer, the caption one equal to its
    predictor alone."""
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.train.checkpoint import save_params

    model = JointNet(tiny_config(no_caption=False, use_con=False),
                     device="cpu")
    save_params(str(tmp_path), "model", model.state_dict())
    args, tasks = serve_cli.parse_args(
        ["--smoke", "--task", "ground,caption", "--port", "0",
         "--serve_batch_size", str(BATCH), "--model_dir", str(tmp_path),
         "--device", "cpu", "--num_beams", "2", "--length_penalty", "0.8"])
    assert tasks == ("ground", "caption")
    server, services = serve_cli.build_server(args, tasks)
    assert services["caption"]._pred.num_beams == 2
    assert services["caption"]._pred.length_penalty == 0.8
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]
        n = _get(port, "/healthz")["tasks"]["caption"]["num_points"]
        payload = {"point_cloud": _scene(12, n=n).tolist()}
        resp = _post(port, "/v1/caption", payload)
        assert resp == services["caption"].handle(payload)
        assert len(_post(port, "/v1/ground", {**payload, "queries": [
            "the desk"]})["boxes"]) == 1
    finally:
        server.shutdown()
        server.server_close()
        for s in services.values():
            s.close()
        t.join(timeout=10)


# ------------------------------------------------------------ answering


@pytest.fixture(scope="module")
def answer_server():
    """One server routing /v1/ground and /v1/answer over one model's
    weights, with an answer vocabulary."""
    config = dataclasses.replace(_config(), model=dataclasses.replace(
        _config().model, use_answer=True))
    from vlp3d_torch.models import JointNet

    state = JointNet(config, device="cpu").state_dict()
    vocab = [f"answer {i}" for i in range(config.model.num_answers - 2)]
    services = {task: InferenceService(config, state, task=task,
                                       batch_size=BATCH, max_wait_ms=30.0,
                                       device="cpu", answer_vocab=vocab)
                for task in ("ground", "answer")}
    server = make_server(services)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield services, server.server_address[1], config, vocab
    server.shutdown()
    server.server_close()
    for s in services.values():
        s.close()
    t.join(timeout=10)


def test_answer_roundtrip_matches_direct_predictor(answer_server):
    """Three concurrent /v1/answer requests (1-3 questions, so device
    batches of more than one request) and a /v1/ground: each answer is
    the AnswerPredictor's on that cloud alone, every question its own
    top 10, best first, named from the vocabulary where it has the id."""
    services, port, config, vocab = answer_server
    service = services["answer"]
    c = 3 + config.model.input_feature_dim
    questions = [["what color is the chair"],
                 ["where is the table", "how many beds"],
                 ["is the door open", "what is on the desk", "which sofa"]]
    payloads = [{"point_cloud": _b64(_scene(30 + i, channels=c)),
                 "queries": q} for i, q in enumerate(questions)]
    results = [None] * len(payloads)

    def call(i):
        results[i] = _post(port, "/v1/answer", payloads[i])

    before = service.stats()["requests"]
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    ground = _post(port, "/v1/ground", {**payloads[0], "queries": ["chair"]})
    for t in threads:
        t.join(timeout=120)
    assert len(ground["boxes"]) == 1
    assert service.stats()["requests"] - before == len(payloads)
    for payload, resp in zip(payloads, results):
        item, n = service._make_item(payload)
        ref = service._pred.run_padded(
            {k: np.asarray(item[k])[None] for k in STREAM_KEYS})
        assert len(resp["answers"]) == n == len(payload["queries"])
        for q, answers in enumerate(resp["answers"]):
            assert [a["answer_id"] for a in answers] == \
                ref["answer_top_ids"][0, q].tolist()
            np.testing.assert_allclose([a["score"] for a in answers],
                                       ref["answer_top_scores"][0, q],
                                       atol=BOX_TOL)
            for a in answers:
                assert ("answer" in a) == (a["answer_id"] < len(vocab))
                if "answer" in a:
                    assert a["answer"] == vocab[a["answer_id"]]


def test_answer_requests_need_questions(answer_server):
    _, port, config, _ = answer_server
    pc = _scene(4, channels=3 + config.model.input_feature_dim).tolist()
    for payload in ({"point_cloud": pc}, {"point_cloud": pc, "queries": []},
                    {"point_cloud": pc, "queries": ["a"] * 9}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/answer", payload)
        assert ei.value.code == 400
