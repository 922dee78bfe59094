"""Network serving: a JSON-over-HTTP API around the grounding,
captioning and question-answering predictors.

The port's counterpart of ``vlp3d/serve.py`` for the ground, caption
and answer tasks on one device: a stdlib ThreadingHTTPServer front end
and, for each task, a micro-batching queue that coalesces concurrent
requests into device batches of at most ``batch_size`` rows, in front
of the predictor's ``run_padded`` (which copies only the occupied rows
and pads on the device). Zero dependencies beyond the stdlib and the
port.

Endpoints (all JSON):

- ``POST /v1/ground``  — ``{"point_cloud": ..., "queries": [str, ...]}``
  → per-query referred box (center/size/heading + proposal index).
- ``POST /v1/caption`` — ``{"point_cloud": ...}`` → per-proposal box,
  objectness, semantic class and caption.
- ``POST /v1/answer``  — ``{"point_cloud": ..., "queries": [str, ...]}``
  → per-question top-k answers (id, logit and, given an
  ``answer_vocab``, text).
- ``GET /healthz``     — model/task/shape info.
- ``GET /stats``       — request count, device batches, mean occupancy,
  p50/p90/p99 request latency and device-batch time (ms, sliding
  window of the last 1024), the device's memory.

A server routes each task it serves at ``/v1/<task>``; any other route
answers 404, naming the routes it serves. Serving over a device mesh
waits for ROADMAP.md queue A item A18.

``point_cloud`` is either a nested list ``(N, C)`` or
``{"b64": <base64 of little-endian float32>, "shape": [N, C]}``. ``C``
must be 3 (xyz only; feature channels are zero-filled except the height
channel — last column by the training convention — which is computed
from the geometry as ``z - percentile(z, 0.99)``) or
``3 + input_feature_dim``. Clouds are resampled to the model's
``num_points`` with a seeded choice-with-replacement (the dataset's
convention, lib/joint/dataset.py random choice) when N differs.
"""

from __future__ import annotations

import base64
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from vlp3d_torch.config import Config
from vlp3d_torch.data.tokenizer import load_tokenizer
from vlp3d_torch.serving import (
    STREAM_KEYS,
    AnswerPredictor,
    CaptionPredictor,
    GroundingPredictor,
)
from vlp3d_torch.utils.memory import device_memory_mb

TASKS = ("ground", "caption", "answer")


class MicroBatcher:
    """Coalesce concurrent requests into device batches.

    The worker thread takes the first waiting request, then drains
    whatever else arrives within ``max_wait_ms`` (up to ``batch_size``),
    runs ``run_batch`` ONCE on the occupied items, and fans the per-item
    results back to the blocked callers. All device work happens on this
    single thread. Padding to the batch size happens on the device in the
    predictor (``run_padded``), so a low-occupancy batch copies only its
    real rows.
    """

    def __init__(self, run_batch, batch_size: int, max_wait_ms: float = 5.0):
        self._run = run_batch
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.stats = {"requests": 0, "device_batches": 0}
        # sliding windows (last 1024) for latency percentiles in stats()
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._batch_times: collections.deque = collections.deque(maxlen=1024)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: dict) -> dict:
        """Blocks until the item's result is available (or re-raises the
        batch's failure)."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        t0 = time.monotonic()
        done = threading.Event()
        box: list = [None, None]  # result, error
        self._q.put((item, done, box))
        done.wait()
        with self._lock:
            self._latencies.append(time.monotonic() - t0)
        if box[1] is not None:
            raise box[1]
        return box[0]

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=10)
        # fail any request that raced past the closed check (in-flight
        # HTTP threads during shutdown) instead of hanging it forever
        while True:
            try:
                entry = self._q.get_nowait()
            except queue.Empty:
                return
            if entry is not None:
                _, done, box = entry
                box[1] = RuntimeError("MicroBatcher is closed")
                done.set()

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._drain(batch)
                    return
                batch.append(nxt)
            self._drain(batch)

    def _drain(self, batch):
        items = [b[0] for b in batch]
        t0 = time.monotonic()
        try:
            results = self._run(items)
            if results is None or len(results) < len(batch):
                raise RuntimeError(
                    f"run_batch returned {0 if results is None else len(results)} "
                    f"results for {len(batch)} requests"
                )
            err = None
        except Exception as e:  # fan the failure out to every caller
            results, err = None, e
        with self._lock:
            self.stats["requests"] += len(batch)
            self.stats["device_batches"] += 1
            self._batch_times.append(time.monotonic() - t0)
        for i, (_, done, box) in enumerate(batch):
            if err is not None:
                box[1] = err
            else:
                box[0] = results[i]
            done.set()

    def latency_stats(self) -> dict:
        """p50/p90/p99 (ms) over the last ≤1024 requests and device
        batches — end-to-end submit→result vs device-batch run time."""
        with self._lock:
            lat = list(self._latencies)
            bt = list(self._batch_times)
        out = {}
        for name, xs in (("latency_ms", lat), ("batch_ms", bt)):
            if xs:
                arr = np.sort(np.asarray(xs)) * 1e3
                out[name] = {
                    p: float(arr[min(int(len(arr) * q), len(arr) - 1)])
                    for p, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99))
                }
            else:
                out[name] = {"p50": None, "p90": None, "p99": None}
        return out


class BadRequest(ValueError):
    pass


def _parse_point_cloud(req: dict, num_points: int, in_dim: int) -> np.ndarray:
    pc = req.get("point_cloud")
    if pc is None:
        raise BadRequest("missing 'point_cloud'")
    if isinstance(pc, dict):
        try:
            raw = base64.b64decode(pc["b64"])
            arr = np.frombuffer(raw, "<f4").reshape(pc["shape"]).copy()
        except (KeyError, ValueError, TypeError) as e:
            raise BadRequest(f"bad b64 point_cloud: {e}") from e
    else:
        try:
            arr = np.asarray(pc, np.float32)
        except (ValueError, TypeError) as e:  # ragged / non-numeric lists
            raise BadRequest(f"bad point_cloud: {e}") from e
    if arr.ndim != 2 or arr.shape[1] not in (3, 3 + in_dim):
        raise BadRequest(
            f"point_cloud must be (N, 3) or (N, {3 + in_dim}); "
            f"got {arr.shape}"
        )
    if arr.shape[0] == 0:
        raise BadRequest("point_cloud is empty")
    if arr.shape[1] == 3 and in_dim:
        # xyz-only request: zero-fill the feature channels EXCEPT the
        # height channel (last column by the training convention), which
        # is derivable from the geometry — the dataset computes z -
        # percentile(z, 0.99) over the full cloud (dataset.py:603-607)
        floor = np.percentile(arr[:, 2], 0.99)
        arr = np.concatenate(
            [arr, np.zeros((arr.shape[0], in_dim), np.float32)], axis=1
        )
        arr[:, -1] = arr[:, 2] - floor
    if arr.shape[0] != num_points:
        # the dataset's choice-with-replacement resample convention
        rng = np.random.default_rng(0)
        sel = rng.choice(
            arr.shape[0], num_points, replace=arr.shape[0] < num_points
        )
        arr = arr[sel]
    return np.ascontiguousarray(arr, np.float32)


class InferenceService:
    """A task's predictor + tokenizer + micro-batcher, independent of
    HTTP (drive it directly in tests or embed it in another server).

    ``task``: "ground" (:class:`GroundingPredictor`), "caption"
    (:class:`CaptionPredictor`, decoding with ``num_beams`` and
    ``length_penalty``) or "answer" (:class:`AnswerPredictor`, the top 10
    answers of each question; ``answer_vocab``, an id -> text list,
    names them). ``state_dict``: reference-layout weights (a
    ``save_params`` snapshot), loaded strictly; None keeps the seeded
    random initialisation.
    """

    def __init__(
        self,
        config: Config,
        state_dict: dict | None = None,
        *,
        task: str = "ground",
        tokenizer=None,
        batch_size: int = 8,
        max_wait_ms: float = 5.0,
        device=None,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        answer_vocab: list[str] | None = None,
    ):
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}")
        self.config = config
        self.task = task
        self.tokenizer = tokenizer or load_tokenizer()
        self.answer_vocab = answer_vocab
        self.num_points = config.dataset.num_points
        self.in_dim = config.model.input_feature_dim
        self.lang_num_max = config.model.lang_num_max
        self.seq_len = config.model.bert_seq_len
        if task == "ground":
            self._pred = GroundingPredictor(
                config, state_dict, batch_size=batch_size, device=device)
        elif task == "caption":
            self._pred = CaptionPredictor(
                config, state_dict, batch_size=batch_size, device=device,
                num_beams=num_beams, length_penalty=length_penalty)
        else:
            self._pred = AnswerPredictor(
                config, state_dict, batch_size=batch_size, device=device)
        self._batcher = MicroBatcher(
            self._run_batch, batch_size, max_wait_ms
        )

    def close(self):
        self._batcher.close()

    # -- batch path (single worker thread) --------------------------------

    def _run_batch(self, items: list[dict]) -> list[dict]:
        batch = {k: np.stack([it[k] for it in items]) for k in STREAM_KEYS}
        # copies only the occupied rows; pads on the device (run_padded)
        out = self._pred.run_padded(batch)
        if self.task == "ground":
            out["cluster_ref"] = out["cluster_ref"].reshape(
                self._pred.batch_size, self.lang_num_max, -1)
        return [
            {k: np.asarray(v[i]) for k, v in out.items()}
            for i in range(len(items))
        ]

    # -- request path (any number of HTTP threads) ------------------------

    def _make_item(self, req: dict) -> tuple[dict, int]:
        pc = _parse_point_cloud(req, self.num_points, self.in_dim)
        queries = req.get("queries") or []
        if self.task in ("ground", "answer") and not queries:
            raise BadRequest("missing 'queries'")
        if not isinstance(queries, list) or not all(
                isinstance(q, str) for q in queries):
            raise BadRequest("'queries' must be a list of strings")
        if len(queries) > self.lang_num_max:
            raise BadRequest(
                f"at most lang_num_max={self.lang_num_max} queries per "
                f"request; got {len(queries)} (send multiple requests — "
                "the batcher coalesces them)"
            )
        input_ids = np.zeros((self.lang_num_max, self.seq_len), np.int32)
        attention = np.zeros_like(input_ids)
        if queries:
            enc = self.tokenizer(list(queries), max_length=self.seq_len)
            input_ids[: len(queries)] = enc["input_ids"]
            attention[: len(queries)] = enc["attention_mask"]
        else:
            # a caption request without queries: CLS-only rows keep the
            # language branch's inputs valid
            input_ids[:, 0] = self.tokenizer.cls_token_id
            attention[:, 0] = 1
        item = {
            "point_clouds": pc,
            "input_ids": input_ids,
            "bert_attention_mask": attention,
            "lang_num": np.int32(max(len(queries), 1)),
        }
        return item, len(queries)

    def handle(self, req: dict) -> dict:
        item, n_queries = self._make_item(req)
        out = self._batcher.submit(item)
        if self.task == "caption":
            return {"proposals": self._proposals(out)}
        if self.task == "answer":
            return {"answers": self._answers(out, n_queries)}
        boxes = []
        for qi in range(n_queries):
            p = int(out["pred_ref"][qi])
            boxes.append(
                {
                    "proposal": p,
                    "center": out["pred_center"][p].tolist(),
                    "size": out["pred_size"][p].tolist(),
                    "heading": float(out["pred_heading"][p]),
                }
            )
        return {"boxes": boxes}

    def _proposals(self, out: dict) -> list:
        """Per-proposal box, objectness, class and caption
        (``vlp3d/serve.py:344-362``)."""
        obj = np.argmax(out["objectness_scores"], -1)
        sem = np.argmax(out["sem_cls_scores"], -1)
        return [
            {
                "center": out["pred_center"][k].tolist(),
                "size": out["pred_size"][k].tolist(),
                "heading": float(out["pred_heading"][k]),
                "objectness": int(obj[k]),
                "sem_class": int(sem[k]),
                "caption": self.tokenizer.decode(out["caption_ids"][k]),
            }
            for k in range(out["pred_center"].shape[0])
        ]

    def _answers(self, out: dict, n_queries: int) -> list:
        """Each question's top-k answers, best first (``vlp3d/serve.py:
        364-384``)."""
        vocab = self.answer_vocab or []
        return [
            [
                {
                    "answer_id": int(a),
                    "score": float(s),
                    **({"answer": vocab[int(a)]} if int(a) < len(vocab)
                       else {}),
                }
                for a, s in zip(out["answer_top_ids"][qi],
                                out["answer_top_scores"][qi])
            ]
            for qi in range(n_queries)
        ]

    def warmup(self) -> None:
        """One occupancy-1 batch through the predictor before serving
        traffic: the first forward on a card pays cuBLAS's and the
        kernels' first-use costs, which a server pays before it binds,
        not on a client's first request."""
        pc = np.zeros((self.num_points, 3 + self.in_dim), np.float32)
        req = {"point_cloud": pc}
        if self.task in ("ground", "answer"):
            req["queries"] = ["warmup"]
        item, _ = self._make_item(req)
        self._batcher.submit(item)

    def health(self) -> dict:
        return {
            "status": "ok",
            "task": self.task,
            "num_points": self.num_points,
            "point_channels": 3 + self.in_dim,
            "lang_num_max": self.lang_num_max,
            "batch_size": self._batcher.batch_size,
        }

    def stats(self) -> dict:
        s = dict(self._batcher.stats)
        s["mean_occupancy"] = s["requests"] / max(s["device_batches"], 1)
        s.update(self._batcher.latency_stats())
        # the device's memory ({} on the CPU)
        s.update(device_memory_mb(self._pred.device))
        return s


def make_server(services, host="127.0.0.1", port=0):
    """Build (without starting) a ThreadingHTTPServer.

    ``services``: one :class:`InferenceService` or a ``{task: service}``
    dict (tasks sharing one checkpoint); each task is routed at
    ``/v1/<task>`` with its own micro-batching queue. Call
    ``serve_forever()`` on the result; ``server_address[1]`` is the bound
    port (pass port=0 for an ephemeral one)."""
    if isinstance(services, InferenceService):
        services = {services.task: services}
    routes = {f"/v1/{t}": s for t, s in services.items()}
    only = next(iter(services.values())) if len(services) == 1 else None
    serving = ", ".join(sorted(routes))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, only.health() if only is not None else {
                    "status": "ok",
                    "tasks": {t: s.health() for t, s in services.items()}})
            elif self.path == "/stats":
                self._send(200, only.stats() if only is not None else
                           {t: s.stats() for t, s in services.items()})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            service = routes.get(self.path)
            if service is None:
                self._send(404, {"error": f"no route {self.path} (serving "
                                          f"{serving})"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError as e:
                    raise BadRequest(f"body is not valid JSON: {e}") from e
                if not isinstance(req, dict):
                    raise BadRequest(
                        f"body must be a JSON object, got {type(req).__name__}"
                    )
                self._send(200, service.handle(req))
            except BadRequest as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
