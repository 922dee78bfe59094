"""The port's Solver (vlp3d_torch/train/solver.py) against the JAX
package's (vlp3d/train/solver.py) on the CPU.

Both solvers run ``tiny_config(use_con=True, no_caption=True)`` at batch
2 over their own ``make_synthetic_dataset`` (batches equal bit for bit,
tests/test_torch_data.py): 2 train scenes (one step an epoch) and 3 val
scenes (a full batch and a trailing partial one). The JAX state is a
seeded fill of the JAX model's parameter shapes (``jax.eval_shape`` of
its init: fan-in-scaled normal kernels, unit norm scales), nudged so
that every loss is live and with random BatchNorm statistics, as in
tests/test_torch_train.py; the port loads it through
``jax_to_torch_state_dict``. Dropout is off on both sides. The data
generator of each solver, and Python's ``random`` that ``shuffle_data``
draws from, are reseeded before each call, so both see the same batches.
Stated tolerances:

  * ``eval_epoch``: Acc@0.25/0.5 (``iou_rate_*``), ``lang_acc`` and the
    unique/multiple x others breakdown equal; the loss scalars within
    tests/test_torch_train.py's atol 1e-4 / rtol 1e-4. JAX pads the
    partial batch by repeating its last row; at one real row of two the
    padded batch means are the row's own, so the port, which runs the
    partial batch as it is, must agree (with more real rows the two
    weigh the repeated row differently, ROADMAP.md C5);
  * the first step's logged metrics within atol 1e-4 / rtol 1e-4, the
    BatchNorm running statistics after it within atol 1e-5 / rtol 1e-4,
    at epochs 0, 20 and 40 (torch momentum 0.5, 0.25, 0.125; a port that
    took flax's convention would agree at epoch 0 only), each solver's
    ``train_epoch(e)`` run from the initial state;
  * the LR of each group and the BatchNorm momentum at epochs 0, 19, 20,
    40, 49 and 50 equal to JAX's (the port's momentum is one minus JAX's
    flax momentum), and the snapshot taxonomy over a scripted sequence of
    val results equal (names, epochs, the ``best`` dict);
  * log.jsonl records with the same phases and keys.
"""

import dataclasses
import json
import os
import random

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlp3d.train.solver as jax_solver_mod
from vlp3d.data.synthetic import make_batch as jax_make_batch
from vlp3d.data.synthetic import make_synthetic_dataset as jax_dataset
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.train.state import TrainState
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import make_synthetic_dataset, tiny_config
from vlp3d_torch.models.layers import BatchNorm, Dropout
from vlp3d_torch.train.solver import Solver

FLAGS = dict(use_con=True, no_caption=True)
BATCH, EPOCHS, SEED, DATA_SEED = 2, 50, 7, 11
TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
BN_EPOCHS = (0, 20, 40)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(config):
    return dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=BATCH, epochs=EPOCHS, num_workers=1))


def _datasets(make, config):
    train = make(config, n_scenes=2, anns_per_scene=4, augment=True,
                 shuffle=True, seed=1)
    val = make(config, n_scenes=3, anns_per_scene=4, split="val", seed=2)
    return train, val


def _records(workdir):
    with open(os.path.join(workdir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _running(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX solver's eval_epoch(0), its log and BatchNorm statistics
    after train_epoch(e) from the initial state for e in BN_EPOCHS (each
    a fresh compile of its train step: JAX builds a model for each BN
    momentum), the
    arguments it gave make_optimizer, its BN momenta, and the initial
    state as the port's state dict."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)
    captured = {}
    real_make = jax_solver_mod.make_optimizer

    def make_optimizer(**kw):
        captured.update(kw)
        return real_make(**kw)

    mp.setattr(jax_solver_mod, "make_optimizer", make_optimizer)
    try:
        config = _train(jax_tiny_config(**FLAGS))
        workdir = str(tmp_path_factory.mktemp("jax_solver"))
        train, val = _datasets(jax_dataset, config)
        solver = jax_solver_mod.Solver(config, train, val, workdir,
                                       use_bn_schedule=True, log_every=1,
                                       seed=SEED)
        model = JaxJointNet(config)
        b0 = jax_make_batch(config, batch_size=BATCH, num_points=256, seed=5)
        shapes = jax.eval_shape(lambda b: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
            train=True), b0)
        rng = np.random.default_rng(1)

        def param(path, a):
            name = path[-1].key
            if name in ("scale", "negative_slope") or (
                    name == "weight" and len(a.shape) == 1):
                return (1.0 + rng.normal(0.0, 0.05, a.shape)).astype(
                    np.float32)
            if name == "bias" or len(a.shape) < 2:
                return rng.normal(0.0, 0.01, a.shape).astype(np.float32)
            if name == "embedding":
                return rng.normal(0.0, 0.02, a.shape).astype(np.float32)
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, a.shape).astype(
                np.float32)

        def stat(path, a):
            if path[-1].key == "var":
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

        params = jax.tree_util.tree_map_with_path(param, shapes["params"])
        for leaf in params["vgen"]["Dense_2"].values():
            leaf *= 0.05
        params["proposal"]["roi_heads"]["Dense_3"]["bias"][:] = -1.0
        stats = jax.tree_util.tree_map_with_path(stat,
                                                 shapes["batch_stats"])

        def reset():
            p = jax.tree_util.tree_map(jnp.asarray, params)
            solver.state = solver._place_state(TrainState(
                step=jnp.zeros((), jnp.int32), params=p,
                batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                opt_state=solver.optimizer.init(p)))
            solver._model_cache.clear()

        reset()
        solver.np_rng = np.random.default_rng(DATA_SEED)
        evaluated = solver.eval_epoch(0)
        trained = {}
        for epoch in BN_EPOCHS:  # each from the initial state and batch
            reset()
            random.seed(DATA_SEED)
            solver.train_dataset = _datasets(jax_dataset, config)[0]
            solver.np_rng = np.random.default_rng(DATA_SEED)
            solver.timers = type(solver.timers)()
            n = len(_records(workdir))
            solver.train_epoch(epoch)
            after = jax.device_get(solver.state)
            trained[epoch] = (_records(workdir)[n:], _running(
                jax_to_torch_state_dict(after.params, after.batch_stats)))
            if epoch == 0:
                records = _records(workdir)
        momenta = {e: solver._bn_momentum(e) for e in (0, 19, 20, 40, 49, 50)}
    finally:
        mp.undo()
    sd = jax_to_torch_state_dict(params, stats)
    return dict(sd=sd, eval=evaluated, trained=trained, optimizer=captured,
                momenta=momenta, records=records)


def _port_solver(jax_side, workdir):
    config = _train(tiny_config(**FLAGS))
    random.seed(DATA_SEED)
    train, val = _datasets(make_synthetic_dataset, config)
    solver = Solver(config, train, val, str(workdir), use_bn_schedule=True,
                    log_every=1, seed=SEED, device="cpu")
    solver.init_state()
    solver.model.load_state_dict(jax_side["sd"], strict=True)
    for m in solver.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    solver.np_rng = np.random.default_rng(DATA_SEED)
    return solver


def test_eval_epoch_matches_jax_with_a_partial_batch(jax_side, tmp_path):
    solver = _port_solver(jax_side, tmp_path)
    assert len(solver.val_dataset) % BATCH  # a trailing partial batch
    got = solver.eval_epoch(0)
    solver.close()
    want = jax_side["eval"]
    assert set(got) == set(want)
    assert want["overall_count"] == len(solver.val_dataset) * 4 > 0
    exact = [k for k in want if k.startswith(("iou_rate_", "lang_acc",
                                              "overall", "unique",
                                              "multiple"))]
    assert len(exact) == 30
    for k in exact:
        assert got[k] == want[k], k
    for k in set(want) - set(exact):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert want["loss"] > 0


@pytest.mark.parametrize("epoch", BN_EPOCHS)
def test_first_step_and_running_statistics_match_jax(jax_side, tmp_path,
                                                     epoch):
    solver = _port_solver(jax_side, tmp_path)
    momentum = solver.bn_momentum(epoch)
    solver.train_epoch(epoch)
    solver.close()
    assert {m.momentum for m in solver.model.modules()
            if isinstance(m, BatchNorm)} == {momentum}
    want_log, want_stats = jax_side["trained"][epoch]
    got_log = [r for r in _records(tmp_path) if r["phase"] == "train"]
    want_log = [r for r in want_log if r["phase"] == "train"]
    assert len(got_log) == len(want_log) == 1
    got, want = got_log[0], want_log[0]
    assert set(got) == set(want)
    for k, w in want.items():
        if k in ("phase", "epoch", "iter", "eta"):
            assert got[k] == w, k
        elif not k.startswith(("mean_", "time")):
            np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)
    assert np.isfinite(got["loss"]) and got["loss"] > 0
    running = _running(solver.model.state_dict())
    assert running.keys() == want_stats.keys() and len(running) == 2 * 24
    for k, w in want_stats.items():
        assert not torch.equal(running[k], jax_side["sd"][k]), k
        np.testing.assert_allclose(running[k].numpy(), w.numpy(),
                                   err_msg=k, **STATS_TOL)


@pytest.fixture(scope="module")
def port_solver(tmp_path_factory):
    config = _train(tiny_config(**FLAGS))
    train, val = _datasets(make_synthetic_dataset, config)
    solver = Solver(config, train, val, str(tmp_path_factory.mktemp("lr")),
                    use_bn_schedule=True, seed=SEED, device="cpu")
    solver.init_state()
    solver.close()
    return solver


@pytest.mark.parametrize("epoch", [0, 19, 20, 40, 49, 50])
def test_lr_and_bn_momentum_match_jax(jax_side, port_solver, epoch):
    solver = port_solver
    # the port's torch momentum is one minus the flax momentum of JAX's
    assert solver.bn_momentum(epoch) == pytest.approx(
        1.0 - jax_side["momenta"][epoch], abs=1e-12)
    jopt = jax_side["optimizer"]
    assert solver.steps_per_epoch == jopt["steps_per_epoch"] == 1
    opt = solver.optimizer
    opt.step_count = epoch * opt.steps_per_epoch
    lrs = {g["name"]: opt.group_lr(g) for g in opt.param_groups}
    assert lrs["base"] == pytest.approx(float(jopt["lr_schedule"](
        epoch, jopt["base_lr"])), rel=1e-5)  # f32 cos in JAX
    assert lrs["module"] == pytest.approx(float(jopt["lr_schedule"](
        epoch, jopt["module_lr"])), rel=1e-5)


def test_bn_momentum_without_the_schedule_is_jaxs_default(jax_side,
                                                          tmp_path):
    config = _train(tiny_config(**FLAGS))
    train, val = _datasets(make_synthetic_dataset, config)
    solver = Solver(config, train, val, str(tmp_path), device="cpu")
    solver.close()
    jax_solver = jax_solver_mod.Solver(_train(jax_tiny_config(**FLAGS)),
                                       train, val, str(tmp_path / "jax"))
    for epoch in (0, 20, 60):
        assert solver.bn_momentum(epoch) == pytest.approx(
            1.0 - jax_solver._bn_momentum(epoch), abs=1e-12) == 0.1


# val results by epoch: improvements, ties, a fall, a 25-only and a
# 50-only best, and the epoch-49 snapshot and the 10-epoch checkpoints
SCRIPT = {0: (0.1, 0.05), 1: (0.2, 0.05), 2: (0.2, 0.05), 3: (0.15, 0.1),
          9: (0.3, 0.1), 10: (0.3, 0.2), 11: (0.05, 0.0), 48: (0.4, 0.2),
          49: (0.4, 0.25), 50: (0.5, 0.3)}


def _scripted(solver, log):
    def eval_epoch(epoch):
        r25, r50 = SCRIPT.get(epoch, (0.01, 0.0))
        return {"iou_rate_0.25": r25, "iou_rate_0.5": r50,
                "lang_acc": 0.5 + epoch / 100, "loss": 1.0 / (epoch + 1)}

    solver.train_epoch = lambda epoch: log.append((epoch, "train"))
    solver.eval_epoch = eval_epoch
    solver._snapshot = lambda name: log.append((None, name))
    solver._save_full_checkpoint = lambda epoch: log.append(
        (epoch, "checkpoint"))


def _named(log):
    """(epoch, name) for every snapshot, by the train epoch before it."""
    out, epoch = [], None
    for e, name in log:
        if name == "train":
            epoch = e
        else:
            out.append((epoch if e is None else e, name))
    return out


def test_snapshot_taxonomy_matches_jax(tmp_path):
    config = _train(tiny_config(**FLAGS))
    train, val = _datasets(make_synthetic_dataset, config)
    port, jax_log, port_log = {}, [], []
    solver = Solver(config, train, val, str(tmp_path / "port"),
                    device="cpu")
    _scripted(solver, port_log)
    port = solver(52)
    solver.close()
    jax_solver = jax_solver_mod.Solver(_train(jax_tiny_config(**FLAGS)),
                                       train, val, str(tmp_path / "jax"))
    _scripted(jax_solver, jax_log)
    want = jax_solver(52)
    assert _named(port_log) == _named(jax_log)
    assert port == want
    names = {n for _, n in _named(port_log)}
    assert names == {"model_last", "model", "ground_model",
                     "ground_model_25", "ground_model_5", "epoch_50",
                     "checkpoint"}
    # the resumed clock: epochs [50, 52) only
    log = []
    solver = Solver(config, train, val, str(tmp_path / "resumed"),
                    device="cpu")
    _scripted(solver, log)
    solver(52, start_epoch=50)
    solver.close()
    assert [e for e, n in log if n == "train"] == [50, 51]


def test_log_records_carry_jaxs_phases_and_keys(jax_side, tmp_path):
    solver = _port_solver(jax_side, tmp_path)
    solver.eval_epoch(0)
    solver.train_epoch(0)
    solver.close()
    got, want = _records(tmp_path), jax_side["records"]
    assert [r["phase"] for r in got] == [r["phase"] for r in want] == [
        "val", "train"]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g["phase"], set(g) ^ set(w))
