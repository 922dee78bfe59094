"""Online grounding, captioning and question-answering server.

The port's counterpart of ``vlp3d/cli/serve.py`` for the ground, caption
and answer tasks on one device: a JSON-over-HTTP endpoint
(:mod:`vlp3d_torch.serve`) with micro-batching in front of the
predictors.

    python -m vlp3d_torch.cli.serve --model_dir out/run1 --port 8080 \\
        --use_multiview --use_normal --task ground,caption
    curl -s localhost:8080/healthz
    curl -s -X POST localhost:8080/v1/ground -d \\
      '{"point_cloud": [[...], ...], "queries": ["the brown chair"]}'
    curl -s -X POST localhost:8080/v1/caption -d '{"point_cloud": ...}'
    curl -s -X POST localhost:8080/v1/answer -d \\
      '{"point_cloud": ..., "queries": ["what color is the chair"]}'

``--task`` takes one task, a comma-separated subset, or ``all``: the
tasks share one checkpoint, each routed at ``/v1/<task>`` with its own
micro-batching queue; ``--num_beams`` / ``--length_penalty`` set the
caption decode, ``--answer_vocab`` (a json list, id -> text; train_qa
writes one as answer_vocab.json) names the answers. ``--model_dir``
loads the ``model`` snapshot a training run saved (``save_params``); the
answer head's width is read from it. Without it the weights are the seeded
random ones (``--smoke``: the tiny synthetic configuration,
``--device cpu`` for the plain PyTorch ops). ``--data_devices`` other
than 1 raises (ROADMAP.md queue A item A18).
"""

from __future__ import annotations

import argparse

TASKS = ("ground", "caption", "answer")
DATA_PARALLEL_ITEM = "ROADMAP.md queue A item A18 (data parallel)"


def parse_args(argv=None):
    """Parse CLI flags; returns (args, tasks)."""
    from vlp3d_torch.cli.common import add_common_args

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--task", type=str, default="ground",
                   help="one of ground/caption/answer, a comma-separated "
                        "subset, or 'all' (tasks share the checkpoint)")
    p.add_argument("--model_dir", type=str, default="",
                   help="run directory holding a save_params 'model' "
                        "snapshot (a training run's output); random "
                        "seeded weights when empty (smoke only)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--serve_batch_size", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--data_devices", type=int, default=1,
                   help="serve data-parallel over N devices; the port "
                        "serves on one")
    p.add_argument("--vocab_path", type=str, default="",
                   help="WordPiece vocab.txt (hash tokenizer when empty)")
    p.add_argument("--answer_vocab", type=str, default="",
                   help="answer-id -> text json list (answer task)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warm-up batch before binding (the first "
                        "client request pays the first-use costs instead)")
    p.add_argument("--compile_cache_dir", type=str, default=None,
                   help="accepted for the JAX CLI's flag set and does "
                        "nothing: the port compiles no device programs "
                        "(its kernels are built once, at first use)")
    p.add_argument("--num_beams", type=int, default=1,
                   help="caption-task beam width (1 = greedy; >1 trades "
                        "~num_beams x decode cost for caption quality)")
    p.add_argument("--length_penalty", type=float, default=1.0,
                   help="caption-task beam-search length normalisation "
                        "exponent")
    args = p.parse_args(argv)

    tasks = TASKS if args.task == "all" else tuple(
        t.strip() for t in args.task.split(",") if t.strip()
    )
    unknown = set(tasks) - set(TASKS)
    if unknown or not tasks:
        p.error(f"--task must be a subset of {'/'.join(TASKS)} or 'all'; "
                f"got {args.task!r}")
    return args, tasks


def build_server(args, tasks):
    """Build (without starting) the HTTP server and its services —
    separated from main() so tests can drive the full startup path.
    Returns (server, {task: service})."""
    import dataclasses
    import json

    from vlp3d_torch.cli.common import resolve_config
    from vlp3d_torch.data.tokenizer import load_tokenizer
    from vlp3d_torch.serve import InferenceService, make_server
    from vlp3d_torch.train.checkpoint import load_params

    if args.data_devices != 1:
        raise NotImplementedError(
            f"vlp3d_torch serves on one device (--data_devices "
            f"{args.data_devices}); see {DATA_PARALLEL_ITEM}")

    # the served tasks decide the heads: the caption head only where the
    # caption task is served (its weights would go unused otherwise), the
    # answer head where the answer task is
    args.no_caption = "caption" not in tasks
    args.use_answer = args.use_answer or "answer" in tasks
    config = resolve_config(args)
    state_dict = (load_params(args.model_dir, "model") if args.model_dir
                  else None)
    head = (state_dict or {}).get("answer.answer_cls.3.weight")
    if config.model.use_answer and head is not None:
        # a train_qa snapshot's vocabulary size
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model, num_answers=int(head.shape[0])))
    answer_vocab = None
    if args.answer_vocab:
        with open(args.answer_vocab, encoding="utf-8") as f:
            answer_vocab = json.load(f)
    tokenizer = load_tokenizer(args.vocab_path or None)
    services = {
        task: InferenceService(
            config,
            state_dict,
            task=task,
            tokenizer=tokenizer,
            batch_size=args.serve_batch_size,
            max_wait_ms=args.max_wait_ms,
            device=args.device,
            num_beams=args.num_beams,
            length_penalty=args.length_penalty,
            answer_vocab=answer_vocab,
        )
        for task in tasks
    }
    if not args.no_warmup:
        for task, service in services.items():
            print(f"| vlp3d_torch serve: warming up /v1/{task}...",
                  flush=True)
            service.warmup()
    server = make_server(services, host=args.host, port=args.port)
    device = next(iter(services.values()))._pred.device
    print(
        f"| vlp3d_torch serve: {', '.join(f'/v1/{t}' for t in tasks)} on "
        f"http://{args.host}:{server.server_address[1]} "
        f"(batch {args.serve_batch_size}, {device})",
        flush=True,
    )
    return server, services


def main(argv=None):
    import signal
    import threading

    args, tasks = parse_args(argv)
    server, services = build_server(args, tasks)
    # SIGTERM (the fleet-manager stop signal) drains gracefully; the
    # handler runs on the thread inside serve_forever, so shutdown()
    # must be called from another thread to avoid self-deadlock
    signal.signal(
        signal.SIGTERM,
        lambda *_: threading.Thread(
            target=server.shutdown, daemon=True
        ).start(),
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        for s in services.values():
            s.close()


if __name__ == "__main__":
    main()
