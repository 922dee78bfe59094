"""The port's training CLI and the trainer behind it on the CPU:
``python -m vlp3d_torch.cli.train_3dvlp --synthetic --smoke --device cpu``.

What the run writes; the interrupt and resume rules (a signal lands at a
step boundary, even one delivered inside ``optimizer.step``; the
interrupt checkpoint is stamped with the last completed epoch and
``--auto_resume`` continues after it, as ``tests/test_auto_resume.py``
pins for JAX; an interrupt before any epoch completes overwrites
nothing; ``--use_checkpoint`` restarts the epoch clock at 0 while the LR
schedule goes on from the restored step count, which is what optax's
restored count does in JAX); ``--pretrain``; gradient accumulation (k
micro-batches equal one step on the batch k times as large, as
``tests/test_grad_accum.py`` pins for JAX); remat (gradients and
BatchNorm statistics equal to a plain step's, FPS and ball query once a
block); ``--profile_dir``; the model options in a smoke run
(``--no_reference``, the detection-only stage, and ``--no_detection``
with every option of the grounding model); ``Solver(detection=False)``
and ``Solver(reference=False)``; and the flags that still raise.
"""

import dataclasses
import json
import math
import os
import shutil
import signal
import sys

import numpy as np
import pytest
import torch
from torch import nn

import vlp3d_torch.train.solver as solver_mod
import vlp3d_torch.train.state as state_mod
from vlp3d_torch.cli.train_3dvlp import main
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.models import JointNet
from vlp3d_torch.models import layers
from vlp3d_torch.models.layers import Dropout
from vlp3d_torch.train import checkpoint as ckpt
from vlp3d_torch.train.optimizer import make_optimizer
from vlp3d_torch.train.schedules import cosine_lr
from vlp3d_torch.train.state import batch_to_device, make_train_step

# 2 synthetic scenes of 10 sentences at lang_num_max 4: 6 items, 3 steps
# an epoch at the smoke run's batch of 2; 2 epochs
ARGS = ["--synthetic", "--smoke", "--no_caption", "--use_con", "--coslr",
        "--device", "cpu", "--num_workers", "1", "--num_scenes", "2",
        "--verbose", "1"]
STEPS_PER_EPOCH = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A run writes ~1 GB of snapshots (the tiny model's state dict holds
    BERT's 30522-word embedding); remove them after each test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _records(workdir):
    with open(os.path.join(workdir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _trained_epochs(records):
    return sorted({r["epoch"] for r in records if r["phase"] == "train"})


def _signal_at(monkeypatch, epoch, step_in_epoch, where="after"):
    """SIGTERM to this process at a train step of ``epoch``: after the
    step (``where="after"``), or inside ``optimizer.step``, between the
    moment updates and the parameter updates of its first group
    (``"optimizer"``)."""
    real = state_mod.make_train_step

    def make(model, config, optimizer, **kw):
        step = real(model, config, optimizer, **kw)
        seen = {"n": 0}

        def train_step(batch, generator=None):
            hit = int(batch["epoch"]) == epoch and \
                seen["n"] == step_in_epoch
            if int(batch["epoch"]) == epoch:
                seen["n"] += 1
            if hit and where == "optimizer":
                _signal_at.before_step = {
                    k: v.detach().clone()
                    for k, v in model.state_dict().items()}
                add = torch._foreach_add_
                calls = {"n": 0}

                def foreach_add(*a, **k):
                    calls["n"] += 1
                    if calls["n"] == 3:  # the first group's parameters
                        os.kill(os.getpid(), signal.SIGTERM)
                    return add(*a, **k)

                monkeypatch.setattr(torch, "_foreach_add_", foreach_add)
                try:
                    metrics = step(batch, generator)
                finally:
                    monkeypatch.setattr(torch, "_foreach_add_", add)
                assert calls["n"] >= 4  # the signal came mid-step
                _signal_at.after_step = {
                    k: v.detach().clone()
                    for k, v in model.state_dict().items()}
                _signal_at.step_count = optimizer.step_count
                return metrics
            metrics = step(batch, generator)
            if hit:
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics

        return train_step

    monkeypatch.setattr(solver_mod, "make_train_step", make)


@pytest.fixture(scope="module")
def finished(tmp_path_factory):
    """(workdir, best, profile dir) of one whole smoke run with
    --use_wandb (the package blocked: the offline stream), --no_donate
    and --profile_dir."""
    tmp = tmp_path_factory.mktemp("finished")
    workdir, prof = str(tmp / "run"), str(tmp / "prof")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "wandb", None)
        best = main(ARGS + ["--workdir", workdir, "--use_wandb",
                            "--no_donate", "--profile_dir", prof])
    yield workdir, best, prof
    shutil.rmtree(tmp, ignore_errors=True)


def test_train_cli_writes_its_files(finished):
    workdir, best, _ = finished
    for name in ("info.json", "log.jsonl", "log.txt", "model_last.pth",
                 "model.pth", "ground_model.pth", "ground_model_25.pth",
                 "ground_model_5.pth", "checkpoint_meta.json",
                 "wandb_offline.jsonl"):
        assert os.path.exists(os.path.join(workdir, name)), name
    for phase in ("train", "val"):
        tb = os.path.join(workdir, "tensorboard", phase)
        assert any(f.startswith("events.out.tfevents") for f in os.listdir(tb))
        assert os.path.exists(os.path.join(tb, "all_scalars.json"))
    with open(os.path.join(workdir, "info.json")) as f:
        assert json.load(f)["args"]["workdir"] == workdir
    records = _records(workdir)
    assert _trained_epochs(records) == [0, 1]
    train = [r for r in records if r["phase"] == "train"]
    assert len(train) == 2 * STEPS_PER_EPOCH  # --verbose 1: every step
    assert all(np.isfinite(r["loss"]) for r in train)
    assert [r["phase"] for r in records if r["phase"] != "train"] == \
        ["profile", "val", "val", "best"]
    meta = json.load(open(os.path.join(workdir, "checkpoint_meta.json")))
    assert meta["epoch"] == 1 and meta["best"]["epoch"] == best["epoch"]
    with open(os.path.join(workdir, "wandb_offline.jsonl")) as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert "train_loss" in keys and "val_iou_rate_0.5" in keys
    # the snapshots load strictly into the model they came from
    model = JointNet(tiny_config(no_caption=True, use_con=True), device="cpu")
    model.load_state_dict(ckpt.load_params(workdir, "model_last"),
                          strict=True)


AUTO_RESUME = ["--auto_resume", "--seed", "5"]


@pytest.fixture(scope="module")
def interrupted(tmp_path_factory):
    """A run with --auto_resume that gets SIGTERM inside the
    optimizer.step of epoch 1's second step: (workdir, printed output,
    the checkpoint it left, the model state before and after that
    step, the optimizer's step count after it)."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("interrupted")
    workdir = str(tmp / "run")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        _signal_at(mp, epoch=1, step_in_epoch=1, where="optimizer")
        main(ARGS + ["--workdir", workdir] + AUTO_RESUME)
    meta = json.load(open(os.path.join(workdir, "checkpoint_meta.json")))
    payload = torch.load(os.path.join(workdir, meta["dir"], "state.pt"),
                         weights_only=True)
    yield dict(workdir=workdir, out=out.getvalue(), meta=meta,
               payload=payload, before=_signal_at.before_step,
               after=_signal_at.after_step,
               step_count=_signal_at.step_count)
    shutil.rmtree(tmp, ignore_errors=True)


def test_signal_inside_optimizer_step_saves_a_whole_step(interrupted):
    assert "interrupted during epoch 1 — checkpoint (through epoch 0)" in \
        interrupted["out"]
    assert interrupted["meta"]["epoch"] == 0  # done_epoch
    payload, after = interrupted["payload"], interrupted["after"]
    assert payload["model"].keys() == after.keys()
    for k, v in after.items():
        assert torch.equal(payload["model"][k], v), k
    # a whole step: the (STEPS_PER_EPOCH + 2)-th update, which moved the
    # parameters of both groups
    assert payload["optimizer"]["step_count"] == interrupted["step_count"] == \
        STEPS_PER_EPOCH + 2
    before = interrupted["before"]
    for prefix in ("backbone_net.", "lang."):  # the base and module groups
        assert any(not torch.equal(v, before[k]) for k, v in after.items()
                   if k.startswith(prefix) and k.endswith("weight")
                   and "text_encoder" not in k), prefix


def test_sigterm_mid_run_then_auto_resume_continues(interrupted, capsys):
    """The interrupt checkpoint is stamped with the last completed epoch
    (0); the same command again continues at epoch 1 and trains only
    it (tests/test_auto_resume.py:37 for JAX)."""
    workdir = interrupted["workdir"]
    records = _records(workdir)
    assert records[-2]["phase"] == "interrupt" and records[-2]["epoch"] == 1
    main(ARGS + ["--workdir", workdir] + AUTO_RESUME)
    assert "continuing at epoch 1" in capsys.readouterr().out
    again = _records(workdir)[len(records):]
    assert _trained_epochs(again) == [1]  # epoch 0 is not replayed
    with open(os.path.join(workdir, "checkpoint_meta.json")) as f:
        assert json.load(f)["epoch"] == 1


def test_interrupt_before_any_epoch_completes_overwrites_nothing(
        finished, tmp_path, monkeypatch, capsys):
    """A finished run's resume record, re-run with --use_checkpoint (the
    clock restarts at 0) and interrupted in epoch 0: nothing is saved."""
    run = str(tmp_path / "run")
    os.makedirs(os.path.join(run, "checkpoint_a"))
    files = {}
    for name in ("checkpoint_meta.json",
                 os.path.join("checkpoint_a", "state.pt")):
        with open(os.path.join(finished[0], name), "rb") as f:
            files[name] = f.read()
        with open(os.path.join(run, name), "wb") as f:
            f.write(files[name])
    _signal_at(monkeypatch, epoch=0, step_in_epoch=0)
    main(ARGS + ["--workdir", run, "--use_checkpoint", run])
    assert "before any epoch of this run completed" in \
        capsys.readouterr().out
    for name, data in files.items():
        with open(os.path.join(run, name), "rb") as f:
            assert f.read() == data, name
    assert not os.path.exists(os.path.join(run, "checkpoint_b"))
    assert not os.path.exists(os.path.join(run, "model_last.pth"))


def test_use_checkpoint_restarts_the_clock_and_keeps_the_lr_count(
        finished, tmp_path, monkeypatch, capsys):
    first, second = finished[0], str(tmp_path / "second")
    seen = []
    real = solver_mod.Solver.train_epoch

    def train_epoch(self, epoch):
        lrs = {g["name"]: self.optimizer.group_lr(g)
               for g in self.optimizer.param_groups}
        seen.append((epoch, self.optimizer.step_count, lrs))
        return real(self, epoch)

    monkeypatch.setattr(solver_mod.Solver, "train_epoch", train_epoch)
    main(ARGS + ["--workdir", second, "--use_checkpoint", first])
    assert "epoch clock restarts at 0" in capsys.readouterr().out
    assert _trained_epochs(_records(second)) == [0, 1]
    # the clock restarts, the step count (and so the LR) goes on
    restored = 2 * STEPS_PER_EPOCH
    assert [(e, c) for e, c, _ in seen] == [
        (0, restored), (1, restored + STEPS_PER_EPOCH)]
    config = tiny_config()
    for i, (_, count, lrs) in enumerate(seen):
        lr_epoch = count // STEPS_PER_EPOCH
        assert lr_epoch == 2 + i
        for name, lr0 in (("base", config.train.lr),
                          ("module", config.train.module_lr)):
            assert lrs[name] == pytest.approx(cosine_lr(lr_epoch, lr0, 2))


def test_pretrain_reports_restored_and_fresh_entries(tmp_path, monkeypatch,
                                                     capsys):
    """--pretrain from a model without the contrast head: every entry
    but the contrast head's is restored, with the snapshot's values."""
    plain = JointNet(tiny_config(no_caption=True, use_con=False),
                     device="cpu")
    with torch.no_grad():
        for p in plain.parameters():
            p.mul_(0.5)
    path = ckpt.save_params(str(tmp_path), "stage1", plain.state_dict())
    seen = {}
    real = solver_mod.Solver.warm_start

    def warm_start(self, p):
        counts = real(self, p)
        seen.update({k: v.clone() for k, v in self.model.state_dict().items()})
        return counts

    monkeypatch.setattr(solver_mod.Solver, "warm_start", warm_start)
    _signal_at(monkeypatch, epoch=0, step_in_epoch=0)
    main(ARGS + ["--workdir", str(tmp_path / "warm"), "--pretrain", path])
    out = capsys.readouterr().out
    sd = plain.state_dict()
    fresh = sum(k.startswith("constrast.") for k in seen)
    assert fresh > 0 and len(seen) - fresh == len(sd)
    assert (f"warm-started from {path}: {len(sd)} entries restored, "
            f"{fresh} fresh") in out
    for k, v in sd.items():
        assert torch.equal(seen[k], v), k


# ------------------------------------------------------ grad accumulation


class _Toy(nn.Module):
    """A two-layer regression net with JointNet's call convention."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(2)
        self.backbone_net = nn.Linear(32, 64)
        self.match = nn.Linear(64, 1)
        for p in self.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.2

    def forward(self, batch, train=True):
        return {"pred": self.match(torch.relu(self.backbone_net(batch["x"])))}


def _mse(config, out, batch, **_):
    loss = ((out["pred"] - batch["y"]) ** 2).mean()
    return loss, {"loss": loss}


def test_grad_accum_micro_batches_equal_one_big_batch_step(monkeypatch):
    """make_train_step + make_optimizer(grad_accum=4): 4 micro-batches of
    8 take the step of one batch of 32 (batch-mean losses), and the
    parameters move only on the 4th."""
    monkeypatch.setattr(state_mod, "compute_joint_loss", _mse)
    k, bs = 4, 8
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(k * bs, 32, generator=g), torch.randn(k * bs, 1,
                                                               generator=g)
    acc, big = _Toy(), _Toy()
    opt_acc = make_optimizer(acc, grad_accum=k)
    opt_big = make_optimizer(big)
    step_acc = make_train_step(acc, None, opt_acc)
    step_big = make_train_step(big, None, opt_big)
    for i in range(k):
        before = [p.detach().clone() for p in acc.parameters()]
        step_acc({"x": x[i * bs:(i + 1) * bs], "y": y[i * bs:(i + 1) * bs]})
        moved = any(not torch.equal(a, p) for a, p in
                    zip(before, acc.parameters()))
        assert moved == (i == k - 1), (i, moved)
        assert opt_acc.step_count == (1 if i == k - 1 else 0)
    step_big({"x": x, "y": y})
    for a, b in zip(acc.parameters(), big.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=1e-7)
    assert opt_acc.micro_step == 0


def test_grad_accum_state_round_trips_mid_window(tmp_path, monkeypatch):
    """A checkpoint taken between micro-batches keeps the accumulated
    gradients and the micro-batch count, as optax.MultiSteps's state
    does."""
    monkeypatch.setattr(state_mod, "compute_joint_loss", _mse)
    g = torch.Generator().manual_seed(1)
    batches = [{"x": torch.randn(8, 32, generator=g),
                "y": torch.randn(8, 1, generator=g)} for _ in range(2)]
    ref, model = _Toy(), _Toy()
    opt_ref, opt = make_optimizer(ref, grad_accum=2), make_optimizer(
        model, grad_accum=2)
    for b in batches:
        make_train_step(ref, None, opt_ref)(b)
    make_train_step(model, None, opt)(batches[0])
    ckpt.save_checkpoint(str(tmp_path), model, opt, {"sum": 0.0}, 0)
    fresh = _Toy()
    opt2 = make_optimizer(fresh, grad_accum=2)
    ckpt.load_checkpoint(str(tmp_path), fresh, opt2)
    assert opt2.micro_step == 1
    make_train_step(fresh, None, opt2)(batches[1])
    for a, b in zip(fresh.parameters(), ref.parameters()):
        assert torch.equal(a, b)


def test_a_restored_optimizer_keeps_its_own_learning_rates(tmp_path,
                                                          monkeypatch):
    """--use_checkpoint with another --lr: moments and step count come
    from the checkpoint, the learning rates and weight decay from the
    new run's flags, as a restored optax state does."""
    monkeypatch.setattr(state_mod, "compute_joint_loss", _mse)
    g = torch.Generator().manual_seed(4)
    batch = {"x": torch.randn(8, 32, generator=g),
             "y": torch.randn(8, 1, generator=g)}
    first = _Toy()
    opt = make_optimizer(first, base_lr=2e-3, module_lr=5e-4)
    make_train_step(first, None, opt)(batch)
    ckpt.save_checkpoint(str(tmp_path), first, opt, {"sum": 0.0}, 0)
    second = _Toy()
    opt2 = make_optimizer(second, base_lr=1e-4, module_lr=1e-5,
                          weight_decay=0.5)
    ckpt.load_checkpoint(str(tmp_path), second, opt2)
    assert opt2.step_count == 1
    assert [(grp["base_lr"], grp["weight_decay"]) for grp in
            opt2.param_groups] == [(1e-4, 0.5), (1e-5, 0.5)]
    for p, q in zip(first.parameters(), second.parameters()):
        assert torch.equal(opt.state[p]["mu"], opt2.state[q]["mu"])


@pytest.mark.parametrize("k,batch_size,steps", [(1, 1, 6), (2, 1, 3),
                                                 (4, 1, 1), (1, 8, 1)])
def test_solver_divides_the_steps_of_an_epoch_by_grad_accum(
        tmp_path, k, batch_size, steps):
    """6 items: max(6 // (batch_size * k), 1) updates an epoch, the
    count the LR schedule divides by (vlp3d/train/solver.py:157-161)."""
    from vlp3d_torch.data.synthetic import make_synthetic_dataset

    config = tiny_config(no_caption=True, use_con=True)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=batch_size))
    ds = make_synthetic_dataset(config, n_scenes=2, anns_per_scene=10)
    assert len(ds) == 6
    s = solver_mod.Solver(config, ds, ds, str(tmp_path), grad_accum=k,
                          device="cpu")
    assert s.steps_per_epoch == steps
    s.close()


def test_grad_accum_moves_batchnorm_on_every_micro_batch():
    config = tiny_config(no_caption=True, use_con=True)
    model = JointNet(config, device="cpu")
    opt = make_optimizer(model, grad_accum=2)
    step = make_train_step(model, config, opt)
    bn = model.backbone_net.sa1.mlp_module.layer0.bn.bn
    for i in range(2):
        before = bn.running_mean.clone()
        step(batch_to_device(make_batch(config, batch_size=2, num_points=256,
                                        seed=i), "cpu"))
        assert not torch.equal(bn.running_mean, before)
        assert int(bn.num_batches_tracked) == i + 1
    assert opt.step_count == 1


# ------------------------------------------------------------------ remat


def _count_calls(monkeypatch):
    calls = {"fps": 0, "ball_query": 0, "group_points": 0, "interpolate": 0}
    for name, attr in (("fps", "furthest_point_sample"),
                       ("ball_query", "ball_query"),
                       ("group_points", "group_points"),
                       ("interpolate", "interpolate_features")):
        real = getattr(layers, attr)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(layers, attr, counted)
    return calls


def test_remat_step_equals_the_plain_step(monkeypatch):
    """Gradients and loss equal, BatchNorm statistics (and their update
    count) equal to a plain step's; FPS and ball query run once a block,
    the neighbourhood gathers (4 SA blocks) and the interpolations (2 FP
    blocks) again in the backward. Outside training remat changes
    nothing."""
    calls = _count_calls(monkeypatch)
    results, models = {}, {}
    for remat in (False, True):
        config = tiny_config(no_caption=True, use_con=True, remat=remat)
        model = JointNet(config, device="cpu")
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        batch = batch_to_device(make_batch(config, batch_size=2,
                                           num_points=256, seed=3), "cpu")
        for k in calls:
            calls[k] = 0
        out = model(batch, train=True)
        loss, _ = compute_joint_loss(config, out, batch)
        loss.backward()
        models[remat] = model
        results[remat] = (loss.item(), dict(calls), {
            n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}, {
            n: b.clone() for n, b in model.named_buffers()})
    loss_p, calls_p, grads_p, bufs_p = results[False]
    loss_r, calls_r, grads_r, bufs_r = results[True]
    assert loss_r == loss_p
    assert grads_r.keys() == grads_p.keys()
    for n, g in grads_p.items():
        assert torch.equal(grads_r[n], g), n
    for n, b in bufs_p.items():
        assert torch.equal(bufs_r[n], b), n
    assert calls_p == {"fps": 5, "ball_query": 5, "group_points": 5,
                       "interpolate": 2}
    assert calls_r == {"fps": 5, "ball_query": 5, "group_points": 9,
                       "interpolate": 4}

    b = make_batch(tiny_config(), batch_size=2, num_points=256, seed=4,
                   istrain=0)
    batch = batch_to_device({k: b[k] for k in ("point_clouds", "input_ids",
                                               "bert_attention_mask",
                                               "lang_num")}, "cpu")
    for k in calls:
        calls[k] = 0
    got = models[True](batch, is_eval=True)
    assert calls == {"fps": 5, "ball_query": 5, "group_points": 5,
                     "interpolate": 2}
    want = models[False](batch, is_eval=True)
    assert torch.equal(got["cluster_ref"], want["cluster_ref"])


# ------------------------------------------------------------ the profile


def test_profile_dir_writes_a_trace(finished):
    workdir, _, prof = finished
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert traces
    with open(os.path.join(prof, traces[0])) as f:
        assert json.load(f)["traceEvents"]
    assert [r for r in _records(workdir) if r["phase"] == "profile"][0][
        "dir"] == prof


# ------------------------------------------------ what is still to port


# --tp and --zero1 raised NotImplementedError here until the slice that
# ported them (the test keeps its name). In one process --zero1 trains on
# a data group of one, and --tp 2 needs a world of 2 x dp ranks, so it
# names the sizes (tests/test_torch_tensor_parallel.py trains it on
# gloo ranks).
@pytest.mark.parametrize("argv,item", [(["--tp", "2"], "world size is 1"),
                                       (["--zero1"], None)])
def test_parallel_flags_still_raise(tmp_path, argv, item):
    if item is not None:
        with pytest.raises(ValueError, match=item):
            main(ARGS + ["--workdir", str(tmp_path)] + argv)
        return
    main(ARGS + ["--workdir", str(tmp_path)] + argv)
    train = [r for r in _records(str(tmp_path)) if r["phase"] == "train"]
    assert train and all(math.isfinite(r["loss"]) for r in train)
    assert os.path.exists(tmp_path / "checkpoint_meta.json")


def test_world_size_above_one_raises(tmp_path, monkeypatch):
    """A WORLD_SIZE above 1 is a data-parallel launch (ROADMAP.md A18,
    tests/test_torch_ddp.py runs it over gloo with --device cpu). On the
    card's default device and a host without CUDA it raises before any
    rendezvous, rather than run the ranks on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA: the rendezvous would wait for a "
                    "second rank")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    argv = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="needs CUDA"):
        main(argv + ["--workdir", str(tmp_path)])


def test_solver_trains_and_scores_captions(tmp_path):
    """Solver(caption=True) with a caption_eval_ctx: the caption loss
    trains, each eval epoch scores the val split's captions, and the best
    caption sum keeps a caption_model snapshot."""
    from vlp3d_torch.data.synthetic import make_synthetic_dataset
    from vlp3d_torch.data.tokenizer import HashTokenizer
    from vlp3d_torch.eval.captioning import organize_scanrefer, prepare_corpus

    config = dataclasses.replace(
        tiny_config(no_caption=False, use_con=True),
        train=dataclasses.replace(tiny_config().train, batch_size=2))
    train = make_synthetic_dataset(config, n_scenes=2, anns_per_scene=4,
                                   seed=1)
    val = make_synthetic_dataset(config, n_scenes=2, anns_per_scene=4,
                                 split="val", seed=2)
    anns = [{"scene_id": f"scene{s:04d}_00", "object_id": str(10 + o),
             "object_name": "chair", "ann_id": str(o),
             "token": ["the", "chair"]} for s in range(2) for o in range(2)]
    ctx = {"corpus": prepare_corpus(anns), "organized": organize_scanrefer(anns),
           "tokenizer": HashTokenizer()}
    solver = solver_mod.Solver(config, train, val, str(tmp_path),
                               caption=True, caption_eval_ctx=ctx,
                               log_every=1, device="cpu")
    solver.init_state()
    best = solver(1)
    solver.close()
    records = _records(str(tmp_path))
    train_recs = [r for r in records if r["phase"] == "train"]
    val_recs = [r for r in records if r["phase"] == "val"]
    assert train_recs and all(r["cap_loss"] > 0 for r in train_recs)
    assert all(0 <= r["cap_acc"] <= 1 for r in train_recs)
    metrics = ("bleu-1", "bleu-2", "bleu-3", "bleu-4", "cider", "rouge",
               "meteor")
    assert len(val_recs) == 1 and all(np.isfinite(val_recs[0][m])
                                      for m in metrics)
    # the eval step leaves the caption loss out, as the JAX one does
    assert "cap_loss" not in val_recs[0]
    assert best["best_caption_epoch"] == 1
    assert best["caption_sum"] == pytest.approx(sum(
        val_recs[0][m] for m in ("bleu-4", "cider", "rouge", "meteor")))
    assert os.path.exists(tmp_path / "caption_model.pth")


# mesh= raised here too until the data-parallel slice
# (tests/test_torch_ddp.py::test_solver_mesh_of_one_device_runs_and_of_two_raises),
# and tp / zero1 until the slice that ported them (the test keeps its
# name): zero1 trains in one process (a data group of one), tp 2 names
# the world size it needs.
@pytest.mark.parametrize("kw,item", [({"tp": 2}, "world size is 1"),
                                     ({"zero1": True}, None)])
def test_solver_options_still_to_port_raise(tmp_path, kw, item):
    from vlp3d_torch.data.synthetic import make_synthetic_dataset

    config = tiny_config(no_caption=True, use_con=True)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=2, epochs=1))
    ds = make_synthetic_dataset(config, n_scenes=1, anns_per_scene=2)
    if item is not None:
        with pytest.raises(ValueError, match=item):
            solver_mod.Solver(config, ds, ds, str(tmp_path), device="cpu",
                              **kw)
        return
    solver = solver_mod.Solver(config, ds, ds, str(tmp_path), device="cpu",
                               **kw)
    try:
        solver.init_state()
        assert type(solver.optimizer).__name__ == "ShardedAdam"
        solver(1)
    finally:
        solver.close()
    assert os.path.exists(tmp_path / "checkpoint_meta.json")


# detection=False and reference=False raised NotImplementedError
# (test_solver_options_still_to_port_raise) until the slice that ported
# the grounding model's options
@pytest.mark.parametrize("kw", [{"detection": False}, {"reference": False}])
def test_solver_trains_without_a_loss_part(tmp_path, kw):
    """One epoch of each: the detection terms leave the sum (their
    metrics are still logged), or the reference terms do, with a
    no_reference model whose eval epoch logs the eval step's loss and
    detection scalars and keeps the last epoch as the best."""
    from vlp3d_torch.data.synthetic import make_synthetic_dataset

    reference = kw.get("reference", True)
    config = dataclasses.replace(
        tiny_config(no_caption=True, use_con=True,
                    no_reference=not reference),
        train=dataclasses.replace(tiny_config().train, batch_size=2))
    train = make_synthetic_dataset(config, n_scenes=2, anns_per_scene=4,
                                   seed=1)
    val = make_synthetic_dataset(config, n_scenes=2, anns_per_scene=4,
                                 split="val", seed=2)
    solver = solver_mod.Solver(config, train, val, str(tmp_path),
                               log_every=1, device="cpu", **kw)
    solver.init_state()
    best = solver(1)
    solver.close()
    records = _records(str(tmp_path))
    train_recs = [r for r in records if r["phase"] == "train"]
    (val_rec,) = [r for r in records if r["phase"] == "val"]
    assert train_recs
    for r in train_recs + [val_rec]:
        assert np.isfinite(r["loss"]) and r["vote_loss"] > 0
        assert "box_loss" in r and "obj_acc" in r
    if reference:
        for r in train_recs:  # the sum holds no detection term (epoch 0)
            assert r["loss"] == pytest.approx(
                0.3 * (r["ref_loss"] + r["diou_loss"] + r["lang_loss"])
                + r["con_loss"], rel=1e-5)
        assert "iou_rate_0.5" in val_rec and "ref_loss" in val_rec
    else:
        for r in train_recs:
            assert r["loss"] == pytest.approx(10 * (
                r["vote_loss"] + 0.1 * r["objectness_loss"]
                + r["box_loss"]), rel=1e-5)
        assert "iou_rate_0.5" not in val_rec and "ref_loss" not in val_rec
        assert best["epoch"] == 1 and best["loss"] == val_rec["loss"]
        assert os.path.exists(tmp_path / "model.pth")
        assert not os.path.exists(tmp_path / "ground_model.pth")


@pytest.mark.parametrize("argv", [
    ["--no_reference"],
    ["--no_detection", "--use_vote_weight", "--use_kl_loss",
     "--use_reg_head", "--use_lang_emb", "--mask_box", "--use_distil",
     "--no_lang_cls"]])
def test_cli_smoke_with_model_options(tmp_path, argv):
    """The training CLI runs to its end with the detection-only stage, and
    with every option of the grounding model (the smoke configuration
    keeps the model flags)."""
    best = main(ARGS + ["--workdir", str(tmp_path)] + argv)
    records = _records(str(tmp_path))
    train_recs = [r for r in records if r["phase"] == "train"]
    assert _trained_epochs(records) == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in train_recs)
    if "--no_reference" in argv:
        assert "ref_loss" not in train_recs[0] and best["epoch"] == 2
    else:
        for key in ("kl_loss", "vote_weight_loss", "ref_loss"):
            assert all(np.isfinite(r[key]) for r in train_recs), key
        assert "lang_loss" not in train_recs[0]
        sd = ckpt.load_params(str(tmp_path), "model_last")
        assert "proposal.votes_weight_predictor.2.weight" in sd
        assert not any("token_type" in k for k in sd)
