"""Online grounding and captioning server.

The port's counterpart of ``vlp3d/cli/serve.py`` for the ground and
caption tasks on one device: a JSON-over-HTTP endpoint
(:mod:`vlp3d_torch.serve`) with micro-batching in front of the
predictors.

    python -m vlp3d_torch.cli.serve --model_dir out/run1 --port 8080 \\
        --use_multiview --use_normal --task ground,caption
    curl -s localhost:8080/healthz
    curl -s -X POST localhost:8080/v1/ground -d \\
      '{"point_cloud": [[...], ...], "queries": ["the brown chair"]}'
    curl -s -X POST localhost:8080/v1/caption -d '{"point_cloud": ...}'

``--task`` takes one task or a comma-separated subset: the tasks share
one checkpoint, each routed at ``/v1/<task>`` with its own micro-batching
queue; ``--num_beams`` / ``--length_penalty`` set the caption decode.
``--model_dir`` loads the ``model`` snapshot a training run saved
(``save_params``); without it the weights are the seeded random ones
(``--smoke``: the tiny synthetic configuration, ``--device cpu`` for the
plain PyTorch ops). ``--task answer`` and ``all`` raise (ROADMAP.md
queue A item A17), as does ``--data_devices`` other than 1 (A18).
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
                        "subset, or 'all' (tasks share the checkpoint); the "
                        "port serves ground and caption")
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
    from vlp3d_torch.cli.common import resolve_config
    from vlp3d_torch.data.tokenizer import load_tokenizer
    from vlp3d_torch.serve import (
        UNPORTED_TASKS,
        InferenceService,
        make_server,
    )
    from vlp3d_torch.train.checkpoint import load_params

    for task in tasks:
        if task in UNPORTED_TASKS:
            raise NotImplementedError(
                f"vlp3d_torch does not serve the {task} task yet; see "
                f"{UNPORTED_TASKS[task]}")
    if args.data_devices != 1:
        raise NotImplementedError(
            f"vlp3d_torch serves on one device (--data_devices "
            f"{args.data_devices}); see {DATA_PARALLEL_ITEM}")

    # the served tasks decide the heads: the caption head only where the
    # caption task is served (its weights would go unused otherwise)
    args.no_caption = "caption" not in tasks
    config = resolve_config(args)
    state_dict = (load_params(args.model_dir, "model") if args.model_dir
                  else None)
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
