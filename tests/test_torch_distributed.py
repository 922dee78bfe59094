"""vlp3d_torch.parallel on gloo ranks on the CPU: the rendezvous, the
collectives between steps, and every global reduction of a sharded
batch against the one-process computation on the whole batch.

The rank processes run this file (``python tests/test_torch_distributed.py
<job> <spec.json> <out_dir>``; it imports no JAX), two ranks on a free
port through env:// (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``) with ``--device cpu``'s gloo backend; each writes its
results to ``<out_dir>/rank<r>.npz``. :func:`run_ranks` starts them with
a time limit; tests/test_torch_ddp.py uses it for the train step and the
Solver. The model is the tiny configuration, one thread a rank (two
full-width processes on a few cores starve each other into gloo
timeouts, tests/dist_worker.py:7-16).

Rank r of W holds rows [r * B / W, (r + 1) * B / W) of a global batch
of B. The gradient convention (vlp3d_torch/parallel/reduce.py): every
rank computes the global loss, so a rank's gradient at its own inputs is
W times the one-process gradient's rows, and the parameters' gradients,
averaged over the ranks, are the one-process ones. Stated tolerances:
values and gradients within atol 1e-5 / rtol 1e-4 of the one-process
ones (float32 sums in another order); indices, draws and masks equal.
"""

import dataclasses
import functools
import json
import os
import random
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
RANK_TIMEOUT = 240  # seconds a rank job may take
B = 4  # the global batch
ATOL, RTOL = 1e-5, 1e-4
# the loss configuration whose every term the sharded reduction must match
# (the contrast head computes its terms in the forward: tested alone)
LOSS_FLAGS = dict(use_con=False, no_caption=False, use_mlm=True,
                  use_answer=True, use_kl_loss=True, use_vote_weight=True,
                  use_reg_head=True)


def loss_config():
    """The tiny configuration with every term of the joint loss on (the
    attribute loss and the debug diagnostics included)."""
    from vlp3d_torch.data.synthetic import tiny_config

    config = tiny_config(**LOSS_FLAGS)
    return dataclasses.replace(config, loss=dataclasses.replace(
        config.loss, use_attr_loss=True, debug=True))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, mode: str = "env") -> dict:
    """The environment of rank ``rank``: env:// (torchrun's variables),
    SLURM's, or ``"none"`` (one process, no rendezvous), with one thread a
    rank and one hash seed for all (the hash tokenizer's ids, C12)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONHASHSEED="0")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
              "SLURM_NODELIST", "SLURM_LOCALID"):
        env.pop(k, None)
    if mode == "env":
        env.update(RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    elif mode == "slurm":
        env.update(SLURM_PROCID=str(rank), SLURM_NTASKS=str(world),
                   SLURM_NODELIST="127.0.0.1", MASTER_PORT=str(port))
    return env


def launch(cmds, envs, timeout: int, cwd=None) -> list:
    """Run one process a rank; kill them all past ``timeout`` seconds.
    Returns [(returncode, stdout, stderr)] and fails with every rank's
    tail when one does not exit 0."""
    procs = [subprocess.Popen(c, env=e, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"--- rank {r} rc={rc}\nstdout: {out[-2000:]}\n"
                       f"stderr: {err[-3000:]}"
                       for r, (rc, out, err) in enumerate(results))
    assert len(results) == len(procs) and all(
        rc == 0 for rc, _, _ in results), report
    return results


def run_ranks(job: str, spec: dict, tmp_path, world: int = WORLD,
              timeout: int = RANK_TIMEOUT, mode: str = "env") -> list:
    """Run ``job`` of this file (or of tests/torch_parallel_jobs.py) on
    ``world`` gloo ranks; returns each rank's results (a dict of
    arrays)."""
    out_dir = tmp_path / f"{job}_out"
    out_dir.mkdir(parents=True)
    spec_path = tmp_path / f"{job}.json"
    spec_path.write_text(json.dumps(spec))
    port = free_port()
    launch([[sys.executable, __file__, job, str(spec_path), str(out_dir)]
            for _ in range(world)],
           [rank_env(r, world, port, mode) for r in range(world)], timeout)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def save_tree(path, **trees) -> None:
    """numpy arrays of dicts of tensors / arrays -> one npz, keys
    ``<tree>.<name>``."""
    flat = {}
    for tree, d in trees.items():
        for k, v in d.items():
            flat[f"{tree}.{k}"] = (v.detach().numpy() if torch.is_tensor(v)
                                   else np.asarray(v))
    np.savez(path, **flat)


def load_tree(path, tree: str) -> dict:
    data = np.load(path)
    pre = f"{tree}."
    return {k[len(pre):]: data[k] for k in data.files if k.startswith(pre)}


def rows_of(v: np.ndarray, b: int, rank: int, world: int):
    """Rank ``rank``'s rows of an array whose leading axis is the batch
    (B or B x L rows, batch-major); any other array as it is."""
    if np.ndim(v) == 0 or v.shape[0] % b:
        return v
    n = v.shape[0] // world
    return v[rank * n:(rank + 1) * n]


def leaves(arrays: dict, b: int) -> dict:
    """Tensors of the arrays; float arrays with the batch's rows are
    leaves that take a gradient."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.array(v))
        if t.is_floating_point() and t.dim() >= 1 and t.shape[0] % b == 0:
            t.requires_grad_(True)
        out[k] = t
    return out


def term_grads(metrics: dict, inputs: dict) -> dict:
    """{term: {input: gradient}} of every metric that takes a gradient,
    in sorted order (every rank runs the same backward collectives)."""
    grads = {}
    names = [k for k, v in inputs.items() if v.requires_grad]
    for key in sorted(metrics):
        v = metrics[key]
        if not (torch.is_tensor(v) and v.dim() == 0 and v.requires_grad):
            continue
        g = torch.autograd.grad(v, [inputs[n] for n in names],
                                retain_graph=True, allow_unused=True)
        grads[key] = {n: gi for n, gi in zip(names, g) if gi is not None}
    return grads


# ------------------------------------------------------------ rank jobs


def _units(spec: dict, shard) -> dict:
    """Every unit of the parallel package on this rank, against the
    inputs the parent wrote; the results keyed for the parent."""
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.contrast import ContrastModule
    from vlp3d_torch.models.layers import BatchNorm, Dropout
    from vlp3d_torch.models.match import MatchModule
    from vlp3d_torch.models.proposal import mask_boxes
    from vlp3d_torch.parallel import distributed as du

    r, w = shard.rank, shard.world
    res = {}
    # collectives between steps
    res["agree_all"] = du.all_processes_agree(True)
    res["agree_some"] = du.all_processes_agree(r == 0)
    du.barrier()
    res["bcast"] = du.broadcast_object(f"from {r}") == "from 0"
    torch.manual_seed(r)
    net = torch.nn.Linear(3, 2)
    res["replica_before"] = len(du.check_replicated(net))
    du.broadcast_module(net)
    res["replica_after"] = len(du.check_replicated(net))
    res["net_weight"] = net.weight.detach().numpy()
    res["host_rows"] = du.shard_host_batch(
        {"point_clouds": np.arange(8.0).reshape(4, 2), "epoch": 3,
         "scene_id": ["a", "b", "c", "d"]}, "cpu")["point_clouds"].numpy()

    # BatchNorm alone
    bn_in = load_tree(spec["npz"], "bn")
    bn = BatchNorm(bn_in["x"].shape[-1], device="cpu")
    bn.load_state_dict({"weight": torch.from_numpy(bn_in["weight"]),
                        "bias": torch.from_numpy(bn_in["bias"]),
                        "running_mean": torch.zeros(bn.weight.shape),
                        "running_var": torch.ones(bn.weight.shape),
                        "num_batches_tracked": torch.zeros((), dtype=torch.long)})
    bn.train()
    bn.shard = shard
    x = torch.from_numpy(rows_of(bn_in["x"], B, r, w)).requires_grad_(True)
    c = torch.from_numpy(rows_of(bn_in["c"], B, r, w))
    y = bn(x)
    shard.sum((y * c).sum()).backward()
    shard.average_gradients([bn.weight, bn.bias])
    res.update({"bn_y": y.detach().numpy(), "bn_dx": x.grad.numpy() / w,
                "bn_dweight": bn.weight.grad.numpy(),
                "bn_dbias": bn.bias.grad.numpy(),
                "bn_mean": bn.running_mean.numpy(),
                "bn_var": bn.running_var.numpy()})

    # every term of the joint loss
    config = loss_config()
    outs = leaves({k: rows_of(v, B, r, w)
                   for k, v in load_tree(spec["npz"], "out").items()}, B // w)
    batch = {k: torch.from_numpy(np.array(rows_of(v, B, r, w)))
             for k, v in load_tree(spec["npz"], "batch").items()}
    _, metrics = compute_joint_loss(config, outs, batch, caption=True,
                                    shard=shard)
    for k, v in metrics.items():
        if torch.is_tensor(v) and v.dim() == 0:
            res[f"metric.{k}"] = v.detach().numpy()
    for term, g in term_grads(metrics, outs).items():
        for name, gi in g.items():
            res[f"grad.{term}.{name}"] = gi.numpy() / w

    # the contrast head
    con_in = load_tree(spec["npz"], "con")
    con = ContrastModule(device="cpu")
    con.load_state_dict({k[len("w."):]: torch.from_numpy(v)
                         for k, v in con_in.items() if k.startswith("w.")})
    con.shard = shard
    ci = leaves({k: rows_of(v, B, r, w) for k, v in con_in.items()
                 if not k.startswith("w.")}, B // w)
    cout = con(ci["bbox_feature"], ci["lang_emb"], ci["pred_center"],
               ci["pred_size"], ci["gt_center"], ci["gt_size"],
               ci["objectness_masks"], ci["lang_num"], 60)
    total = cout["lang_con_loss"] + cout["iou_con_loss"]
    total.backward()
    shard.average_gradients(list(con.parameters()))
    res.update({"con_lang": cout["lang_con_loss"].detach().numpy(),
                "con_iou": cout["iou_con_loss"].detach().numpy(),
                "con_dfeat": ci["bbox_feature"].grad.numpy() / w,
                "con_dlang": ci["lang_emb"].grad.numpy() / w})
    for n, p in con.named_parameters():
        if p.grad is not None:
            res[f"con_dparam.{n}"] = p.grad.numpy()

    # copy-paste through the match module
    mi = load_tree(spec["npz"], "match")
    match = MatchModule(hidden_size=mi["feat"].shape[-1], heads=2,
                        num_proposals=mi["feat"].shape[1], device="cpu")
    match.load_state_dict({k[len("w."):]: torch.from_numpy(v)
                           for k, v in mi.items() if k.startswith("w.")})
    for m in match.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    match.train()
    match.shard = shard
    feat = torch.from_numpy(rows_of(mi["feat"], B, r, w)).requires_grad_(True)
    lang = torch.from_numpy(rows_of(mi["lang"], B, r, w))
    obj = torch.from_numpy(rows_of(mi["obj"], B, r, w))
    mout = match(feat, lang, obj, lang_num_max=mi["lang"].shape[0] // B,
                 random_gate=0.3)
    shard.sum((mout["cluster_ref"] * torch.from_numpy(
        rows_of(mi["c"], B, r, w))).sum()).backward()
    res.update({"match_ref": mout["cluster_ref"].detach().numpy(),
                "match_dfeat": feat.grad.numpy() / w})

    # draws: dropout, box masks, the caption token masks
    g = torch.Generator().manual_seed(3)
    drop = Dropout(0.5)
    drop.train()
    drop.generator, drop.shard = g, shard
    res["dropout"] = drop(torch.ones(B // w * 3, 5, 7)).numpy()
    center = torch.zeros(B // w, 6, 3)
    res["box_center"], res["box_size"] = (
        t.numpy() for t in mask_boxes(center, torch.ones(B // w, 6, 3),
                                      torch.Generator().manual_seed(4),
                                      shard))
    return res


def _steps(spec: dict, shard) -> dict:
    """Each run of ``spec["runs"]`` (:func:`_step`), keyed
    ``<name>/<result>``."""
    res = {}
    for run in spec["runs"]:
        res.update({f"{run['name']}/{k}": v
                    for k, v in _step(run, shard).items()})
    if "bad_batch" in spec:
        res["bad_batch"] = np.asarray(_bad_batch(**spec["bad_batch"]))
    return res


def _bad_batch(tp: int, batch_size: int) -> str:
    """The error of a Solver whose global batch the data size does not
    divide ("" when none is raised)."""
    import tempfile

    from vlp3d_torch.data.synthetic import make_synthetic_dataset, tiny_config
    from vlp3d_torch.train.solver import Solver

    config = tiny_config()
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=batch_size))
    ds = make_synthetic_dataset(config, n_scenes=1, anns_per_scene=2)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            Solver(config, ds, ds, tmp, device="cpu", tp=tp).close()
        except ValueError as e:
            return str(e)
    return ""


def _step(spec: dict, shard) -> dict:
    """Train steps of the tiny JointNet from a saved state on this rank's
    rows of each global batch (one a micro-batch): the metrics, then the
    gradients the update used (averaged over the ranks), the parameters
    and buffers after it, all in the whole (one-process) layout.

    ``spec["tp"]`` (default 1) runs tensor parallel on a (data, model)
    grid of the ranks, ``spec["zero1"]`` the ZeRO-1 optimizer; with
    either, the whole moments after the step are reported too.
    ``spec["dp"]`` runs data groups of that size inside the launch."""
    from vlp3d_torch.data.synthetic import tiny_config
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.models.layers import Dropout
    from vlp3d_torch.parallel import LOCAL
    from vlp3d_torch.parallel.distributed import shard_host_batch
    from vlp3d_torch.parallel.tensor_parallel import (
        full_tensor,
        make_grid,
        shard_model,
    )
    from vlp3d_torch.parallel.zero import ShardedAdam, optimizer_state_bytes
    from vlp3d_torch.train import make_optimizer, make_train_step
    from vlp3d_torch.train.schedules import cosine_lr

    config = tiny_config(**spec["flags"])
    model = JointNet(config, device="cpu")
    start = _load_state(spec["state"])
    model.load_state_dict(start, strict=True)
    if not spec["dropout"]:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    # dp: a data group of dp ranks inside the launch (each of world / dp
    # such groups runs the step alone) where tp is 1
    tp, zero1, dp = spec.get("tp", 1), spec.get("zero1", False), spec.get("dp")
    grid = None
    if tp > 1 or dp:
        grid = make_grid(tp if tp > 1 else shard.world // dp)
        shard = grid.data
        if tp > 1:
            shard_model(model, grid.model)
    opt = make_optimizer(
        model, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
        **spec["opt"])
    if zero1 or tp > 1:
        opt = ShardedAdam(opt, model, shard if zero1 else LOCAL)
    step = make_train_step(model, config, opt, shard=shard)
    assert opt.grad_accum == len(spec["batches"])
    gen = torch.Generator().manual_seed(spec["seed"])
    res = {}
    for i, path in enumerate(spec["batches"]):
        host = dict(np.load(path))
        batch = shard_host_batch(host, "cpu", shard=shard)
        for k, v in step(batch, gen).items():
            res[f"metric{i}.{k}"] = v.numpy()
    # the trained parameters and the buffers; the frozen text encoder only
    # as whether it kept its values
    params = dict(model.named_parameters())
    frozen_same = True
    for n, p in params.items():
        if p.grad is not None:
            res[f"grad.{n}"] = full_tensor(p.grad, p).numpy()
        if p.requires_grad:
            res[f"param.{n}"] = full_tensor(p.detach(), p).numpy()
        else:
            frozen_same &= torch.equal(full_tensor(p.detach(), p), start[n])
    for n, v in model.state_dict().items():
        if n not in params:
            res[f"buf.{n}"] = v.numpy()
    res["frozen_same"] = np.asarray(frozen_same)
    if isinstance(opt, ShardedAdam) or spec.get("moments"):
        names = {id(p): n for n, p in params.items()}
        order = [names[id(p)] for g in opt.param_groups for p in g["params"]]
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0:
                    res[f"moment.{order[i]}.{k}"] = v.numpy()
        res["state_bytes"] = np.asarray(optimizer_state_bytes(opt))
    return res


@functools.lru_cache(maxsize=2)
def _load_state(path: str) -> dict:
    """A saved state dict, read once a rank process (every run of a launch
    starts from one or two of them)."""
    return torch.load(path, weights_only=True)


def solver_datasets(config):
    """The Solver test's synthetic splits: 4 train scenes of 8 sentences
    (8 items of 4: 2 global batches of 4 an epoch) and a val split of 5
    items, whose last batch holds one."""
    from vlp3d_torch.data.synthetic import make_synthetic_dataset

    train = make_synthetic_dataset(config, n_scenes=4, anns_per_scene=8,
                                   n_points=600, augment=True, shuffle=True,
                                   seed=3)
    val = make_synthetic_dataset(config, n_scenes=5, anns_per_scene=3,
                                 n_points=600, split="val", seed=4)
    return train, val


def run_solver(config, workdir: str, interrupt_after: int = 0,
               **kw) -> tuple:
    """A Solver over :func:`solver_datasets` from Python's random seeded
    with 7 (``shuffle_data``): one eval epoch of the initial state, then
    its epochs; returns (the eval's result, the best record).
    ``interrupt_after`` > 0: SIGTERM's flag is set on this process after
    that many train steps."""
    import signal

    from vlp3d_torch.data.dataset import BatchIterator
    from vlp3d_torch.train.solver import Solver

    random.seed(7)
    train, val = solver_datasets(config)
    solver = Solver(config, train, val, workdir, log_every=1, seed=5, **kw)
    try:
        solver.init_state(next(iter(BatchIterator(train, 2))))
        if interrupt_after:
            step, calls = solver.train_step, []

            def counted(*args):
                out = step(*args)
                calls.append(1)
                if len(calls) == interrupt_after:
                    solver._on_signal(signal.SIGTERM, None)
                return out

            solver.train_step = counted
        return solver.eval_epoch(0), solver(config.train.epochs)
    finally:
        solver.close()


def _solver(spec: dict, shard) -> dict:
    from vlp3d_torch.data.synthetic import tiny_config

    config = tiny_config(**spec["flags"])
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=spec["batch_size"], epochs=spec["epochs"],
        num_workers=1))
    # the one-process reference runs on a mesh of one device
    place = {"mesh": ["cpu"]} if spec.get("mesh") else {"device": "cpu"}
    if shard.rank == spec.get("interrupted_rank", -1):
        place["interrupt_after"] = spec["interrupt_after"]
    val, best = run_solver(config, spec["workdir"], use_bn_schedule=True,
                           **place)
    return {f"{tree}.{k}": np.asarray(v)
            for tree, d in (("val", val), ("best", best))
            for k, v in d.items() if isinstance(v, (int, float))}


def _hash_seed(spec: dict, shard) -> dict:
    """Whether check_same_hash_seed raised on this rank."""
    from vlp3d_torch.parallel.distributed import check_same_hash_seed

    try:
        check_same_hash_seed()
    except RuntimeError:
        return {"raised": True}
    return {"raised": False}


def _rank_main(job: str, spec_path: str, out_dir: str) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    torch.set_num_threads(1)
    from vlp3d_torch.parallel import LOCAL, BatchShard
    from vlp3d_torch.parallel.distributed import (
        dist_close,
        dist_init,
        initialized,
    )

    with open(spec_path) as f:
        spec = json.load(f)
    ctx = dist_init(device="cpu")
    try:
        shard = BatchShard.of_group() if initialized() else LOCAL
        if job in JOBS:
            res = JOBS[job](spec, shard)
        else:  # the later parallel modes' jobs
            import torch_parallel_jobs

            res = torch_parallel_jobs.JOBS[job](spec, shard)
        np.savez(os.path.join(out_dir, f"rank{ctx.rank}.npz"), **res)
    finally:
        dist_close()


JOBS = {"units": _units, "steps": _steps, "solver": _solver,
        "hash_seed": _hash_seed}


# ----------------------------------------------------------- rendezvous


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, backend, **kw):
        self.calls.append(dict(kw, backend=backend))


@pytest.fixture
def recorder(monkeypatch):
    import torch.distributed as dist

    rec = _Recorder()
    monkeypatch.setattr(dist, "init_process_group", rec)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "SLURM_PROCID", "SLURM_NTASKS", "SLURM_NODELIST",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return rec


@pytest.mark.parametrize("mode", ["explicit", "env", "slurm", "none",
                                  "one_process"])
def test_dist_init_resolves_like_jax(recorder, monkeypatch, mode):
    """The resolution order and the context of JAX's dist_init; the port
    hands torch.distributed the rendezvous (env:// under torchrun, tcp://
    otherwise) and gloo for --device cpu. One process initialises its
    group of one but reports distributed=False, as JAX does."""
    from vlp3d_torch.parallel.distributed import DistContext, dist_init

    if mode == "explicit":
        ctx = dist_init("10.0.0.1:1234", 4, 2, device="cpu")
        want = DistContext(True, 2, 4, "10.0.0.1:1234")
        init = "tcp://10.0.0.1:1234"
    elif mode == "env":
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("WORLD_SIZE", "3")
        ctx = dist_init(device="cpu")
        # the reference's defaults for MASTER_ADDR / MASTER_PORT
        want = DistContext(True, 1, 3, "127.0.0.1:29500")
        init = "env://"
        assert os.environ["MASTER_PORT"] == "29500"
    elif mode == "slurm":
        monkeypatch.setenv("SLURM_PROCID", "5")
        monkeypatch.setenv("SLURM_NTASKS", "8")
        monkeypatch.setenv("SLURM_NODELIST", "gpu[07-09,12]")
        monkeypatch.setenv("MASTER_PORT", "4321")
        ctx = dist_init(device="cpu")
        want = DistContext(True, 5, 8, "gpu07:4321")
        init = "tcp://gpu07:4321"
    elif mode == "none":
        assert dist_init(device="cpu") == DistContext(False)
        assert recorder.calls == []
        return
    else:
        ctx = dist_init("127.0.0.1:5555", 1, 0, device="cpu")
        want = DistContext(False, 0, 1, "127.0.0.1:5555")
        init = "tcp://127.0.0.1:5555"
    assert ctx == want and ctx.is_main == (want.rank == 0)
    (call,) = recorder.calls
    assert call["backend"] == "gloo" and call["init_method"] == init
    assert (call["rank"], call["world_size"]) == (want.rank, want.world_size)


def test_dist_init_explicit_needs_the_counts(recorder):
    from vlp3d_torch.parallel.distributed import dist_init

    with pytest.raises(ValueError, match="num_processes and process_id"):
        dist_init("127.0.0.1:1", device="cpu")


def test_dist_init_on_the_card_needs_cuda(recorder):
    """Without --device cpu the backend is NCCL on cuda:LOCAL_RANK; a host
    without CUDA raises rather than fall back to gloo."""
    from vlp3d_torch.parallel.distributed import dist_init

    if torch.cuda.is_available():
        pytest.skip("the host has CUDA")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        dist_init("127.0.0.1:1", 2, 0)
    assert recorder.calls == []


@pytest.mark.parametrize("nodes", ["node[3-17,20]", "gpu[07-09,12]",
                                   "a1,b2,c3", "host7", "x[1]",
                                   "rack2-[0001-0004]"])
def test_slurm_first_host_matches_jax(nodes):
    from vlp3d.parallel.distributed import _slurm_first_host as jax_first

    from vlp3d_torch.parallel.distributed import _slurm_first_host

    assert _slurm_first_host(nodes) == jax_first(nodes)


_TOKENS = ("from vlp3d.data.tokenizer import HashTokenizer as J; "
           "from vlp3d_torch.data.tokenizer import HashTokenizer as P; "
           "print(J().tokenize_ids('brown chair'), "
           "P().tokenize_ids('brown chair'))")


def test_hash_tokenizer_ids_follow_the_process_hash_seed():
    """C12: both packages' hash tokenizer (the fallback without a BERT
    vocabulary) maps a word to Python's hash(), which a process seeds on
    its own. Two processes with other seeds give a word other ids; with
    one seed the ids agree, and the port's equal JAX's."""
    runs = {}
    for seed in ("1", "2", "1b"):
        env = dict(os.environ, PYTHONHASHSEED=seed.rstrip("b"))
        out = subprocess.run([sys.executable, "-c", _TOKENS], env=env,
                             cwd=os.path.dirname(HERE), capture_output=True,
                             text=True, timeout=120, check=True).stdout
        jax_ids, port_ids = out.strip().split("] [")
        assert jax_ids + "]" == "[" + port_ids
        runs[seed] = jax_ids
    assert runs["1"] == runs["1b"] and runs["1"] != runs["2"]


def test_ranks_with_other_hash_seeds_are_refused(tmp_path):
    """The training CLIs run check_same_hash_seed on the hash tokenizer:
    ranks whose hash seeds differ all raise, naming PYTHONHASHSEED."""
    port = free_port()
    envs = [dict(rank_env(r, WORLD, port), PYTHONHASHSEED=str(r + 1))
            for r in range(WORLD)]
    spec = tmp_path / "spec.json"
    spec.write_text("{}")
    out = tmp_path / "out"
    out.mkdir()
    launch([[sys.executable, __file__, "hash_seed", str(spec), str(out)]
            for _ in range(WORLD)], envs, RANK_TIMEOUT)
    assert all(bool(np.load(out / f"rank{r}.npz")["raised"])
               for r in range(WORLD))


_SHUFFLE = ("from vlp3d.data.synthetic import make_synthetic_dataset, "
            "tiny_config; ds = make_synthetic_dataset(tiny_config(), "
            "n_scenes=4, anns_per_scene=8, shuffle=True, seed=3); "
            "ds.shuffle_data(); print([[(a['scene_id'], a['object_id'], "
            "a['ann_id']) for a in c] for c in ds.chunks])")


def test_jax_processes_shuffle_with_their_own_python_random():
    """C13: JAX's datasets order their sentences with Python's random
    (shuffle_data), which nothing in vlp3d seeds, so two processes
    started as two JAX ranks shuffle the epoch differently and their
    item_slice rows are not one global batch. The port's Solver gives
    every rank rank 0's state first (sync_python_random; the 2-rank
    Solver test in test_torch_ddp.py holds its rows to one process's)."""
    procs = [subprocess.Popen([sys.executable, "-c", _SHUFFLE],
                              cwd=os.path.dirname(HERE),
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    orders = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs) and all(orders)
    assert orders[0] != orders[1]


def test_one_process_helpers_need_no_group():
    """Without a process group every helper is the one-process answer."""
    from vlp3d_torch.parallel import LOCAL
    from vlp3d_torch.parallel import distributed as du

    assert not du.initialized()
    assert (du.get_rank(), du.get_world_size(), du.is_main_process()) == (
        0, 1, True)
    du.barrier()
    assert du.all_processes_agree(True) and not du.all_processes_agree(False)
    assert du.broadcast_object("x") == "x"
    x = torch.arange(6.0).reshape(3, 2)
    assert du.check_replicated(torch.nn.Linear(2, 2)) == []
    assert LOCAL.sum(x) is x and LOCAL.cat(x) is x and LOCAL.own(x) is x
    assert float(LOCAL.mean(x)) == float(x.mean())


# ------------------------------------------------ 2 ranks against 1


def _bn_inputs(rng):
    c = 6
    # rank 1's rows sit far from rank 0's, so its own statistics differ
    x = rng.normal(size=(B, 5, c)).astype(np.float32)
    x[B // 2:] = 3.0 + 2.0 * x[B // 2:]
    return {"x": x, "c": rng.normal(size=x.shape).astype(np.float32),
            "weight": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}


def _loss_inputs():
    """The joint model's training outputs on a global batch of B (tiny
    configuration with every loss term on, dropout off), nudged so that
    every term is live, and counts that differ between the two halves of
    the batch: sentences (lang_num 4, 3 | 1, 2), good caption boxes,
    GT votes."""
    from vlp3d_torch.data.synthetic import make_batch, tiny_config
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.models.layers import Dropout

    config = tiny_config(**LOSS_FLAGS)
    model = JointNet(config, device="cpu")
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.05)
        model.proposal.proposal.box_predictor.weight.mul_(0.05)
        model.proposal.proposal.box_predictor.bias.fill_(-1.0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    batch = make_batch(config, batch_size=B, num_points=256, seed=17,
                       epoch=60)
    batch["random"] = np.float32(0.3)
    batch["lang_num"] = np.array([4, 3, 1, 2], batch["lang_num"].dtype)
    batch["vote_label_mask"][B // 2:, 64:] = 0
    rng = np.random.default_rng(2)
    l = config.model.lang_num_max
    batch["answer_cat_scores"] = (rng.random((B, l, 32)) < 0.1).astype(
        np.float32)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = model(tb, train=True)
    keep = {}
    for k, v in out.items():
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] % B == 0:
            keep[k] = v.detach()
    good = keep["good_bbox_masks"].clone()
    good[B // 2 * l:][::3] = False
    keep["good_bbox_masks"] = good
    return config, model, keep, batch


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """The units job on 2 ranks, and the one-process inputs."""
    from vlp3d_torch.models.contrast import ContrastModule
    from vlp3d_torch.models.match import MatchModule

    tmp = tmp_path_factory.mktemp("units")
    rng = np.random.default_rng(0)
    bn = _bn_inputs(rng)
    config, model, out, batch = _loss_inputs()
    torch.manual_seed(0)
    con = ContrastModule(device="cpu")
    k, h = out["bbox_feature"].shape[1:]
    l = config.model.lang_num_max
    con_in = {"bbox_feature": out["bbox_feature"], "lang_emb": out["lang_emb"],
              "pred_center": out["pred_center"], "pred_size": out["pred_size"],
              "objectness_masks": torch.from_numpy(
                  (rng.random((B, k)) < np.array([0.8, 0.6, 0.3, 0.2])[:, None]
                   ).astype(np.float32)),
              "gt_center": out["pred_center"][:, :l] + 0.05,
              "gt_size": out["pred_size"][:, :l] * 1.1,
              "lang_num": torch.from_numpy(batch["lang_num"])}
    con_w = {f"w.{n}": v for n, v in con.state_dict().items()}
    match = MatchModule(hidden_size=16, heads=2, num_proposals=8,
                        device="cpu")
    obj = np.zeros((B, 8), np.float32)
    obj[:B // 2, [1, 4, 6]] = 1.0  # rank 1's scenes hold no object
    match_in = {"feat": rng.normal(size=(B, 8, 16)).astype(np.float32),
                "lang": rng.normal(size=(B * 3, 5, 16)).astype(np.float32),
                "obj": obj,
                "c": rng.normal(size=(B * 3, 8)).astype(np.float32),
                **{f"w.{n}": v for n, v in match.state_dict().items()}}
    path = tmp / "inputs.npz"
    save_tree(path, bn=bn, out=out, batch=batch, con={**con_in, **con_w},
              match=match_in)
    ranks = run_ranks("units", {"npz": str(path)}, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(ranks=ranks, bn=bn, config=config, out=out, batch=batch,
                con=(con, con_in), match=(match, match_in))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def test_collectives_over_two_ranks(units):
    for r, res in enumerate(units["ranks"]):
        assert bool(res["agree_all"]) and not bool(res["agree_some"])
        assert bool(res["bcast"])
        # two seeds -> one mismatching weight and bias, none after the
        # broadcast of rank 0's
        assert int(res["replica_before"]) == 2
        assert int(res["replica_after"]) == 0
        np.testing.assert_array_equal(res["net_weight"],
                                      units["ranks"][0]["net_weight"])
        np.testing.assert_array_equal(
            res["host_rows"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])


def test_batchnorm_across_ranks_equals_one_process(units):
    """Forward, input and parameter gradients and running statistics of
    the sharded BatchNorm equal one process on the concatenated batch;
    each half's own statistics would not."""
    from vlp3d_torch.models.layers import BatchNorm

    bn_in, ranks = units["bn"], units["ranks"]
    bn = BatchNorm(bn_in["x"].shape[-1], device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(bn_in["weight"]))
        bn.bias.copy_(torch.from_numpy(bn_in["bias"]))
    bn.train()
    x = torch.from_numpy(bn_in["x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(bn_in["c"])).sum().backward()
    _close(_rows(ranks, "bn_y"), y.detach().numpy(), "forward")
    _close(_rows(ranks, "bn_dx"), x.grad.numpy(), "input gradient")
    for r in ranks:
        _close(r["bn_dweight"], bn.weight.grad.numpy(), "weight gradient")
        _close(r["bn_dbias"], bn.bias.grad.numpy(), "bias gradient")
        _close(r["bn_mean"], bn.running_mean.numpy(), "running mean")
        _close(r["bn_var"], bn.running_var.numpy(), "running variance")
    half = BatchNorm(bn_in["x"].shape[-1], device="cpu")
    half.train()
    half(torch.from_numpy(bn_in["x"][B // 2:]))
    assert not np.allclose(half.running_mean.numpy(),
                           bn.running_mean.numpy(), atol=1e-2)


def _one_process_loss(units):
    from vlp3d_torch.losses.joint import compute_joint_loss

    cfg = loss_config()
    outs = leaves({k: v.numpy() for k, v in units["out"].items()}, B)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in units["batch"].items()}
    _, metrics = compute_joint_loss(cfg, outs, batch, caption=True)
    return cfg, outs, batch, metrics


@pytest.fixture(scope="module")
def one_process(units):
    cfg, outs, batch, metrics = _one_process_loss(units)
    grads = term_grads(metrics, outs)
    return cfg, outs, batch, metrics, grads


# every term of the joint loss whose sharded value must hold; those
# marked True take a mean whose rank-local version differs here
LOSS_TERMS = [
    "vote_loss", "objectness_loss", "heading_reg_loss",
    "size_distance_loss", "sem_cls_loss", "box_loss", "ref_loss",
    "diou_loss", "kl_loss", "lang_loss", "attr_loss", "vote_weight_loss",
    "mlm_loss", "answer_loss", "cap_loss", "cap_acc", "pos_ratio",
    "neg_ratio", "obj_acc", "max_iou_rate_0.25", "top_iou_rate_1",
    "pred_iou_rate_0.25", "class_iou_rate_chair", "top_ind", "loss",
]


@pytest.mark.parametrize("term", LOSS_TERMS)
def test_each_loss_term_across_ranks_equals_one_process(units, one_process,
                                                        term):
    """The term's value on each rank and its gradients at the model's
    outputs (each rank's rows, divided by W) equal the one-process ones
    on the whole batch."""
    _, _, _, metrics, grads = one_process
    want = metrics[term].detach().numpy()
    for r in units["ranks"]:
        _close(r[f"metric.{term}"], want, term)
    for name, g in grads.get(term, {}).items():
        key = f"grad.{term}.{name}"
        got = _rows(units["ranks"], key)
        _close(got, g.numpy(), key)


def test_masked_means_differ_from_rank_local_means(units, one_process):
    """The batch's halves hold unequal counts (sentences, GT votes, good
    caption boxes, positives), so the mean of the halves' own masked means
    is not the global one: the terms above test the global reduction."""
    from vlp3d_torch.losses.joint import compute_joint_loss

    cfg, outs, batch, metrics, _ = one_process
    halves = []
    for r in range(WORLD):
        o = {k: torch.from_numpy(rows_of(v.detach().numpy(), B, r, WORLD))
             for k, v in outs.items()}
        b = {k: torch.from_numpy(np.array(rows_of(v.numpy(), B, r, WORLD)))
             for k, v in batch.items()}
        halves.append(compute_joint_loss(cfg, o, b, caption=True)[1])
    for term in ("vote_loss", "cap_loss", "mlm_loss", "top_iou_rate_1"):
        want = float(metrics[term].detach())
        local = np.mean([float(h[term].detach()) for h in halves])
        assert abs(local - want) > 1e-4 * max(1.0, abs(want)), term
    assert float(metrics["diou_loss"].detach()) > 0
    assert float(metrics["ref_loss"].detach()) > 0


def test_contrast_head_across_ranks_equals_one_process(units):
    con, con_in = units["con"]
    ins = leaves({k: v.detach().numpy() for k, v in con_in.items()}, B)
    out = con(ins["bbox_feature"], ins["lang_emb"], ins["pred_center"],
              ins["pred_size"], ins["gt_center"], ins["gt_size"],
              ins["objectness_masks"], ins["lang_num"], 60)
    assert float(out["lang_con_loss"]) > 0 and float(out["iou_con_loss"]) > 0
    (out["lang_con_loss"] + out["iou_con_loss"]).backward()
    for r in units["ranks"]:
        _close(r["con_lang"], out["lang_con_loss"].detach().numpy(), "OCC")
        _close(r["con_iou"], out["iou_con_loss"].detach().numpy(), "OSC")
        for n, p in con.named_parameters():
            if p.grad is not None:
                _close(r[f"con_dparam.{n}"], p.grad.numpy(), n)
    _close(_rows(units["ranks"], "con_dfeat"), ins["bbox_feature"].grad.numpy(),
           "bbox_feature gradient")
    _close(_rows(units["ranks"], "con_dlang"), ins["lang_emb"].grad.numpy(),
           "lang_emb gradient")


def test_copy_paste_pastes_across_ranks(units):
    """Rank 1's scenes hold no object, so every object they paste is rank
    0's: the sharded match module equals one process on the whole batch
    (cluster_ref and the feature gradient, which now reaches rank 0's
    objects from rank 1's loss), and differs from rank 1 alone, which
    has nothing to paste."""
    from vlp3d_torch.models.layers import Dropout

    match, mi = units["match"]
    match.train()
    for m in match.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    feat = torch.from_numpy(mi["feat"]).requires_grad_(True)
    out = match(feat, torch.from_numpy(mi["lang"]), torch.from_numpy(mi["obj"]),
                lang_num_max=3, random_gate=0.3)
    (out["cluster_ref"] * torch.from_numpy(mi["c"])).sum().backward()
    ranks = units["ranks"]
    _close(_rows(ranks, "match_ref"), out["cluster_ref"].detach().numpy(),
           "cluster_ref")
    _close(_rows(ranks, "match_dfeat"), feat.grad.numpy(), "feature gradient")
    with torch.no_grad():
        alone = match(torch.from_numpy(mi["feat"][B // 2:]),
                      torch.from_numpy(mi["lang"][B // 2 * 3:]),
                      torch.from_numpy(mi["obj"][B // 2:]), lang_num_max=3,
                      random_gate=0.3)["cluster_ref"].numpy()
    assert np.abs(alone - ranks[1]["match_ref"]).max() > 1e-3
    # rank 0's object features reach rank 1's scenes only by pasting
    obj_rows = feat.grad.numpy()[:B // 2][mi["obj"][:B // 2] > 0]
    assert np.abs(obj_rows).max() > 0


def test_random_draws_are_the_global_batch_rows(units):
    """Dropout and box masks drawn at the global shape from one seed:
    each rank's draw is its rows of the one-process draw."""
    from vlp3d_torch.models.layers import Dropout
    from vlp3d_torch.models.proposal import mask_boxes

    drop = Dropout(0.5)
    drop.train()
    drop.generator = torch.Generator().manual_seed(3)
    want = drop(torch.ones(B * 3, 5, 7)).numpy()
    np.testing.assert_array_equal(_rows(units["ranks"], "dropout"), want)
    center, size = mask_boxes(torch.zeros(B, 6, 3), torch.ones(B, 6, 3),
                              torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(_rows(units["ranks"], "box_center"),
                                  center.numpy())
    np.testing.assert_array_equal(_rows(units["ranks"], "box_size"),
                                  size.numpy())
    assert 0 < (want == 0).mean() < 1


if __name__ == "__main__":
    _rank_main(*sys.argv[1:4])
