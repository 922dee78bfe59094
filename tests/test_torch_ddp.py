"""Data-parallel training of vlp3d_torch on 2 gloo ranks on the CPU
against the JAX package's one program over the global batch, and
against the port's one-process step, Solver and CLIs.

JAX's ``Solver(mesh=...)`` runs one GSPMD program over the global batch,
so its step is the one-process step on that batch. The port's step on 2
ranks, each holding its contiguous half of the batch (the JAX loader's
``item_slice``), must equal it at tests/test_torch_train.py's stated
tolerances (``assert_step_matches``): the loss and every metric, every
gradient (the averaged one the update used, through
``vlp3d_torch.convert``), the BatchNorm running statistics and the
parameters after the update; the two ranks' states must be equal bit for
bit. Dropout is off on both sides there (tests/test_torch_train.py says
why); the dropout, box-mask and MLM-mask draws are held against the
port's one-process step from the same generator seed instead, at the
same tolerances. The ranks run tests/test_torch_distributed.py's
``steps`` and ``solver`` jobs (no JAX in the rank processes).
"""

import dataclasses
import json
import math
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_distributed import (
    RANK_TIMEOUT,
    WORLD,
    free_port,
    launch,
    rank_env,
    run_ranks,
    solver_datasets,
)
from test_torch_train import (
    BATCH,
    FLAGS,
    OPT,
    _batch,
    _port,
    assert_step_matches,
    jax_side,  # noqa: F401  (the fixture)
)
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.models.layers import Dropout
from vlp3d_torch.train import batch_to_device, make_optimizer, make_train_step
from vlp3d_torch.train.schedules import cosine_lr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX comparisons: (epoch, gate); 0.3 turns copy-paste on, which
# pastes across the two ranks
JAX_CASES = [(0, 0.7), (10, 0.3)]
# the draws case: dropout, box masks and MLM token masks, the contrast
# head live (epoch 60; one-process port step as the reference: JAX's
# contrast head reads scene 0's mask for every scene, C2)
DRAW_FLAGS = dict(FLAGS, mask_box=True, use_mlm=True)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A Solver or CLI run writes ~1 GB of snapshots (the tiny model's
    state dict holds BERT's 30522-word embedding); remove them after each
    test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _save_batch(path, batch):
    np.savez(path, **{k: np.asarray(v) for k, v in batch.items()})
    return str(path)


def _with_mlm_head(sd):
    """The JAX fixture's weights (nudged so that every loss is live) in
    the draws model, whose MLM head keeps its seeded weights."""
    model = JointNet(tiny_config(**DRAW_FLAGS), device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.startswith("mlm.") for k in missing)
    return model.state_dict()


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every data-parallel step of this file on 2 gloo ranks, in one
    launch: the JAX cases, the draws case, grad_accum 2."""
    tmp = tmp_path_factory.mktemp("ddp")
    state = tmp / "jax_state.pt"
    torch.save(jax_side["sd"], state)
    runs = []
    for epoch, gate in JAX_CASES:
        runs.append(dict(
            name=f"jax_{epoch}", state=str(state), flags=FLAGS,
            dropout=False, seed=0, opt=OPT,
            batches=[_save_batch(tmp / f"b{epoch}.npz",
                                 _batch(epoch, gate))]))
    draw_state = tmp / "draw_state.pt"
    torch.save(_with_mlm_head(jax_side["sd"]), draw_state)
    draw_batch = make_batch(tiny_config(**DRAW_FLAGS), batch_size=BATCH,
                            num_points=256, seed=17, epoch=60)
    draw_batch["random"] = np.float32(0.3)
    runs.append(dict(name="draws", state=str(draw_state), flags=DRAW_FLAGS,
                     dropout=True, seed=11, opt=OPT,
                     batches=[_save_batch(tmp / "draws.npz", draw_batch)]))
    runs.append(dict(name="accum", state=str(state), flags=FLAGS,
                     dropout=False, seed=0, opt=dict(OPT, grad_accum=2),
                     batches=[_save_batch(tmp / f"a{i}.npz",
                                          _batch(0, 0.7, seed=17 + i))
                              for i in range(2)]))
    res = run_ranks("steps", {"runs": runs}, tmp)
    sd = torch.load(draw_state, weights_only=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(res=res, draw=(sd, draw_batch))


def _rank_model(res, name, sd, config):
    """A port model holding rank 0's state after the run ``name`` (its
    frozen text encoder, which the rank reports unchanged, from ``sd``),
    with its gradients in ``.grad``; its metrics."""
    model = JointNet(config, device="cpu")
    pre = f"{name}/"
    assert bool(res[0][pre + "frozen_same"])
    after = dict(sd)
    after.update({k[len(pre) + 6:]: torch.from_numpy(v)
                  for k, v in res[0].items() if k.startswith(pre + "param.")})
    after.update({k[len(pre) + 4:]: torch.from_numpy(v)
                  for k, v in res[0].items() if k.startswith(pre + "buf.")})
    model.load_state_dict(after, strict=True)
    for n, p in model.named_parameters():
        g = res[0].get(f"{pre}grad.{n}")
        p.grad = None if g is None else torch.from_numpy(g)
    metrics = {k[len(pre) + 8:]: torch.from_numpy(v)
               for k, v in res[0].items() if k.startswith(pre + "metric0.")}
    return model, metrics


def _ranks_agree(res, name):
    """Both ranks hold the same state after the update, bit for bit, and
    report the same metrics."""
    pre = f"{name}/"
    keys = [k for k in res[0] if k.startswith(pre)]
    assert keys and set(keys) == {k for k in res[1] if k.startswith(pre)}
    for k in keys:
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)


@pytest.mark.parametrize("epoch,gate", JAX_CASES)
def test_two_rank_step_matches_jax_on_the_global_batch(jax_side, ranks,
                                                       epoch, gate):
    batch = _batch(epoch, gate)
    jparams, jstats, jmetrics, jgrads = jax.device_get(jax_side["run"](batch))
    config, model0 = _port(jax_side["sd"])
    before = {k: v.clone() for k, v in model0.state_dict().items()}
    name = f"jax_{epoch}"
    _ranks_agree(ranks["res"], name)
    model, metrics = _rank_model(ranks["res"], name, jax_side["sd"], config)
    assert_step_matches(model, before, metrics, jmetrics,
                        jax_to_torch_state_dict(jgrads, jstats),
                        jax_to_torch_state_dict(jparams, jstats), epoch)


def _one_process(sd, flags, batches, seed, opt, dropout):
    """The port's one-process step(s) from ``sd`` on the global
    batches."""
    config = tiny_config(**flags)
    model = JointNet(config, device="cpu")
    model.load_state_dict(sd, strict=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    o = make_optimizer(model, lr_schedule=lambda e, lr0: cosine_lr(
        e, lr0, 200), **opt)
    step = make_train_step(model, config, o)
    gen = torch.Generator().manual_seed(seed)
    metrics = [step(batch_to_device(b, "cpu"), gen) for b in batches]
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    return config, model, metrics, grads


def test_two_rank_step_with_dropout_and_masks_matches_one_process(ranks):
    """Dropout, the box masks and the MLM token masks are the global
    batch's draws from one generator seed: the 2-rank step equals the
    one-process port step (the contrast head live, copy-paste on)."""
    sd, draw_batch = ranks["draw"]
    config, want, wmetrics, wgrads = _one_process(
        sd, DRAW_FLAGS, [draw_batch], 11, OPT, dropout=True)
    assert "mlm_loss" in wmetrics[0] and float(wmetrics[0]["mlm_loss"]) > 0
    _ranks_agree(ranks["res"], "draws")
    model, metrics = _rank_model(ranks["res"], "draws", sd, config)
    before = {k: v.clone() for k, v in sd.items()}
    assert_step_matches(model, before, metrics,
                        {k: v.numpy() for k, v in wmetrics[0].items()},
                        wgrads, want.state_dict(), 60)


def test_two_rank_grad_accum_matches_one_process(jax_side, ranks):
    """grad_accum 2 on 2 ranks: two micro-batches, one update whose
    averaged, accumulated gradients and new parameters equal the
    one-process port's grad_accum 2 on the same global batches."""
    batches = [_batch(0, 0.7, seed=17 + i) for i in range(2)]
    config, want, wmetrics, wgrads = _one_process(
        jax_side["sd"], FLAGS, batches, 0, dict(OPT, grad_accum=2),
        dropout=False)
    res = ranks["res"]
    _ranks_agree(res, "accum")
    for i in range(2):
        for k, v in wmetrics[i].items():
            np.testing.assert_allclose(res[0][f"accum/metric{i}.{k}"],
                                       v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    for n, p in want.named_parameters():
        g = wgrads[n].numpy()
        got = res[0].get(f"accum/grad.{n}", np.zeros_like(g))
        scale = max(float(np.abs(g).max()), 1e-3)
        err = np.abs(got - g)
        assert np.median(err) <= 1e-4 * scale and err.max() <= 5e-3 * scale, n
        if p.requires_grad:
            assert np.abs(res[0][f"accum/param.{n}"] - p.detach().numpy()
                          ).max() <= 2.2 * OPT["base_lr"], n
    params = dict(want.named_parameters())
    for n, v in want.state_dict().items():
        if n in params:
            continue
        got = res[0][f"accum/buf.{n}"]
        if n.endswith("num_batches_tracked"):
            assert int(got) == 2
        else:
            np.testing.assert_allclose(got, v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=n)


# ------------------------------------------------------------ the Solver


SOLVER = dict(flags=dict(use_con=True, no_caption=True), batch_size=4,
              epochs=1)


def _solver_config():
    config = tiny_config(**SOLVER["flags"])
    return dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=SOLVER["batch_size"],
        epochs=SOLVER["epochs"], num_workers=1))


def _records(workdir):
    with open(os.path.join(workdir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _numbers_equal(got: dict, want: dict, what: str) -> int:
    """Every number of ``want`` (times and ETAs aside) equal in ``got``;
    returns how many were compared."""
    n = 0
    for k, v in want.items():
        if k in ("time", "eta", "phase") or k.startswith(
                ("fetch", "iter", "mean_")):
            continue
        if isinstance(v, float) and math.isfinite(v):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what} {k}")
        else:
            assert got[k] == v, (what, k)
        n += 1
    return n


def test_two_rank_solver_matches_one_process(tmp_path):
    """The Solver on 2 ranks against the one-process Solver over a
    one-device mesh, from one seeded state: an eval epoch (a full batch of
    4 and a partial one of 1, which every rank runs whole) gives the same
    Acc, grounding breakdown and loss scalars, and the epoch's first
    train step the same logged numbers. Later steps are not compared:
    where a gradient is rounding noise around 0 its sign is noise, and
    Adam's first update moves such a parameter by the whole learning rate
    either way (tests/test_torch_train.py). Only rank 0 writes the log,
    log.txt, the snapshots and the checkpoint; rank 1 its own
    TensorBoard directory."""
    workdir = str(tmp_path / "dp")
    res = run_ranks("solver", dict(SOLVER, workdir=workdir), tmp_path)
    # the reference in a process of its own with the ranks' hash seed
    # (the synthetic sentences' ids, C12), and no rendezvous
    one = str(tmp_path / "one")
    (ref,) = run_ranks("solver", dict(SOLVER, workdir=one, mesh=True),
                       tmp_path / "one_process", world=1, mode="none")
    val = {k[len("val."):]: v.item() for k, v in ref.items()
           if k.startswith("val.")}
    assert "overall_acc@0.25" in val and "lang_acc" in val
    for r in res:
        got = {k[len("val."):]: v.item() for k, v in r.items()
               if k.startswith("val.")}
        assert set(got) == set(val)
        _numbers_equal(got, val, "eval epoch")
    got, want = _records(workdir), _records(one)
    assert [r["phase"] for r in got] == [r["phase"] for r in want]
    assert [r["phase"] for r in got[:2]] == ["val", "train"]
    assert _numbers_equal(got[0], want[0], "val") > 20
    assert _numbers_equal(got[1], want[1], "train") > 15
    for r in got:
        assert all(math.isfinite(v) for v in r.values()
                   if isinstance(v, float)), r["phase"]
    for name in ("model_last.pth", "model.pth", "checkpoint_meta.json",
                 "log.txt"):
        assert os.path.exists(os.path.join(workdir, name)), name
    tb = os.path.join(workdir, "tensorboard")
    assert sorted(os.listdir(tb)) == ["rank1", "train", "val"]


def test_an_interrupt_on_one_rank_stops_every_rank_at_one_step(tmp_path):
    """SIGTERM reaches rank 1 alone, after its third step (the first of
    epoch 1): both ranks stop at that step boundary (no rank waits in a
    collective for the other), decide together to save, and rank 0
    writes the checkpoint through epoch 0 and the interrupt record."""
    workdir = str(tmp_path / "dp")
    run_ranks("solver", dict(SOLVER, workdir=workdir, epochs=2,
                             interrupted_rank=1, interrupt_after=3),
              tmp_path)
    recs = _records(workdir)
    assert [r["phase"] for r in recs][-3:] == ["train", "interrupt", "best"]
    assert recs[-2]["epoch"] == 1
    assert [(r["epoch"], r["iter"]) for r in recs if r["phase"] == "train"
            ] == [(0, 0), (0, 1), (1, 0)]
    with open(os.path.join(workdir, "checkpoint_meta.json")) as f:
        assert json.load(f)["epoch"] == 0


def test_solver_mesh_of_one_device_runs_and_of_two_raises(tmp_path):
    """A mesh of one device takes the place of ``device`` (the one-process
    Solver above runs on mesh=["cpu"]); a mesh of more, which JAX runs as
    one program, is one process a card here, and the error names the
    command (ROADMAP.md C11)."""
    from vlp3d_torch.train.solver import Solver

    config = _solver_config()
    train, val = solver_datasets(config)
    with pytest.raises(ValueError, match="torch.distributed.run "
                                         "--nproc_per_node 2"):
        Solver(config, train, val, str(tmp_path), mesh=["cpu", "cpu"])
    solver = Solver(config, train, val, str(tmp_path), mesh=["cpu"])
    try:
        assert solver.device == torch.device("cpu")
        assert not solver.shard.distributed and solver.is_main
    finally:
        solver.close()


# ------------------------------------------------------------ the CLIs


@pytest.mark.parametrize("module,mode", [("train_3dvlp", "env"),
                                         ("train_qa", "slurm")])
def test_training_cli_runs_on_two_ranks(tmp_path, module, mode):
    """``--synthetic --smoke --device cpu`` on 2 ranks (env:// as torchrun
    sets it, or SLURM's variables as srun does): exit 0, one log written
    by rank 0 with finite losses, rank 1's TensorBoard apart."""
    workdir = tmp_path / "run"
    port = free_port()
    argv = [sys.executable, "-m", f"vlp3d_torch.cli.{module}", "--synthetic",
            "--smoke", "--device", "cpu", "--num_workers", "1",
            "--workdir", str(workdir)]
    results = launch([argv] * WORLD,
                     [rank_env(r, WORLD, port, mode) for r in range(WORLD)],
                     RANK_TIMEOUT, cwd=REPO)
    assert "distributed init (rank 0/2)" in results[0][1]
    recs = _records(workdir)
    train = [r for r in recs if r["phase"] == "train"]
    assert train and all(math.isfinite(r["loss"]) for r in train)
    assert any(r["phase"] == "val" for r in recs)
    assert os.path.isdir(workdir / "tensorboard" / "rank1")
    assert os.path.exists(workdir / "checkpoint_meta.json")
