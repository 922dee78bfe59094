"""Training solver: epoch loop, curriculum, eval, best-model checkpoints.

Counterpart of ``vlp3d/train/solver.py`` (the reference's
``lib/joint/solver_3dvlp.py`` Solver.__call__/_feed, :273-1245), on one
device:

  * per epoch: dataset.shuffle_data() re-chunks sentences, train feed,
    val feed with grounding metrics, best-model selection keyed on
    2 x iou_rate_0.5 (criterion 'sum', solver:1114-1128);
  * the curriculum rides the loss (the epoch-50 switches read the
    batch's ``epoch``): the solver only hands the loader the epoch;
  * BN momentum schedule (detection/grounding runs): at each epoch every
    BatchNorm of the model gets ``momentum = bn_momentum_torch(epoch)``,
    torch's convention (the JAX solver rebuilds its model with flax's,
    one minus this), and 0.1 without the schedule (flax's 0.9);
  * checkpoints: model_last every epoch, epoch_50 at epoch 49,
    ground_model / ground_model_25 / ground_model_5 / model on val best,
    caption_model on the best bleu-4 + cider + rouge + meteor (with a
    ``caption_eval_ctx``), the full resume checkpoint every 10 epochs and
    at the end;
  * ``caption=True`` trains the caption branch (its loss joins the
    joint loss; the CLI then runs without the BatchNorm schedule, as the
    JAX one does) and, given a ``caption_eval_ctx``, scores Scan2Cap
    captions of the val split after each eval epoch;
  * a model with the answer head (``use_answer``) adds its loss to the
    joint loss, and each eval epoch reports the answer EM@1 / EM@10
    (``answer_acc_at1`` / ``answer_acc_at10``, lib/vqa/eval_helper.py:
    221-235) over the question slots each item fills (``lang_num``),
    ties to the lowest answer index as ``vlp3d.eval.vqa`` breaks them
    (the JAX solver's ``np.argpartition`` leaves the order of values
    tied at the tenth place unspecified); ``criterion="answer_acc_at1"``
    selects the best model on it (lib/vqa/solver.py:503-506);
  * phase timers (fetch / iter, see :mod:`vlp3d_torch.utils.timers` for
    which steps synchronise), the JSONL log, TensorBoard and wandb.

Where the port differs from the JAX solver, and why:

  * an interrupt lands only at a step boundary. SIGTERM and SIGINT set a
    flag; the loop reads it after each whole train step and each eval
    batch and then takes the save-and-exit path. An interrupt inside
    ``optimizer.step()`` would leave some parameter groups updated and
    others not (its ``_foreach`` updates run as many launches), which no
    checkpoint may record;
  * the trailing partial val batch runs as it is. JAX pads it to the
    batch size (one compiled shape) and unpads the outputs; its loss
    scalars of that batch then count the repeated last row, the port's
    do not (ROADMAP.md C5). The grounding and answer metrics read only
    the real rows in both, so they agree;
  * no donation: the optimizer updates in place, so there is no buffer
    to donate (the CLI accepts ``--no_donate`` and does nothing);
  * ``profile_dir``: a torch.profiler Chrome trace over ``PROFILE_STEPS``
    steps from iteration 2 of epoch 0.

Still to port, each raising NotImplementedError naming its ROADMAP.md
item: ``mesh`` and multi-process runs (A18), ``tp`` and ``zero1``
(A19), ``detection=False`` and ``reference=False`` (A9a).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np
import torch

from vlp3d_torch.config import Config
from vlp3d_torch.data.dataset import BatchIterator
from vlp3d_torch.device import resolve_device
from vlp3d_torch.eval.captioning import score_captions
from vlp3d_torch.eval.grounding import final_eval_breakdown, get_eval
from vlp3d_torch.eval.scan2cap import collect_batch
from vlp3d_torch.eval.vqa import answer_hits
from vlp3d_torch.models.jointnet import JointNet
from vlp3d_torch.models.layers import BatchNorm
from vlp3d_torch.train import checkpoint as ckpt
from vlp3d_torch.train.optimizer import make_optimizer
from vlp3d_torch.train.schedules import bn_momentum_torch, cosine_lr, step_lr
from vlp3d_torch.train.state import (
    batch_to_device,
    make_eval_step,
    make_train_step,
)
from vlp3d_torch.utils.memory import device_memory_mb
from vlp3d_torch.utils.tb_writer import SummaryWriter
from vlp3d_torch.utils.timers import PhaseTimers, eta_str
from vlp3d_torch.utils.wandb_writer import WandbWriter

# outputs eval_epoch reads on the host (get_eval's inputs)
EVAL_KEYS = ("objectness_scores", "cluster_ref", "pred_center", "pred_size",
             "pred_heading", "sem_cls_scores", "lang_scores")
# steps in the --profile_dir trace (the JAX solver's default window)
PROFILE_STEPS = 3
# the metrics whose sum picks the caption_model snapshot
# (solver_3dvlp.py:1166-1181)
CAPTION_METRICS = ("bleu-4", "cider", "rouge", "meteor")
_UNPORTED = {
    "mesh": "ROADMAP.md queue A item A18 (data parallel)",
    "tp": "ROADMAP.md queue A item A19 (the other parallel modes)",
    "zero1": "ROADMAP.md queue A item A19 (the other parallel modes)",
    "detection": "ROADMAP.md queue A item A9a (options of slice 1)",
}


def _unported(what: str, item: str):
    return NotImplementedError(
        f"vlp3d_torch's Solver does not implement {what} yet; see "
        f"{_UNPORTED[item]}")


class Solver:
    def __init__(
        self,
        config: Config,
        train_dataset,
        val_dataset,
        workdir: str,
        *,
        caption: bool = False,
        detection: bool = True,
        reference: bool = True,
        use_bn_schedule: bool = False,
        log_every: int = 50,
        criterion: str = "sum",
        mesh=None,
        tp: int = 1,
        zero1: bool = False,
        grad_accum: int = 1,
        seed: int = 42,
        caption_eval_ctx: dict | None = None,
        use_wandb: bool = False,
        profile_dir: str | None = None,
        device=None,
    ):
        """caption_eval_ctx (optional): {"corpus", "organized",
        "tokenizer"}, the Scan2Cap scoring of each eval epoch (the
        reference's Solver._eval -> eval_cap, solver_3dvlp.py:720-765)."""
        if mesh is not None:
            raise _unported("a device mesh", "mesh")
        if tp != 1:
            raise _unported(f"tp={tp}", "tp")
        if zero1:
            raise _unported("zero1=True", "zero1")
        if not detection:
            raise _unported("detection=False", "detection")
        if not reference:
            raise _unported("reference=False", "detection")
        self.config = config
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.caption = caption
        self.caption_eval_ctx = caption_eval_ctx
        self.use_bn_schedule = use_bn_schedule
        self.log_every = log_every
        # best-model criterion: 'sum' = 2 x iou_rate_0.5
        # (solver_3dvlp.py:1114-1128); a val-metric name selects on that
        # metric; anything else leaves cur_best at 0 (:1129-1135)
        self.criterion = criterion
        self.device = resolve_device(device)
        self.profile_dir = profile_dir
        self._profiled = False
        self.seed = seed
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.timers = PhaseTimers()
        self.mean_size_arr = config.dataset.mean_size_arr()

        # grad_accum > 1: mean gradients over k micro-batches, one update
        # per k (effective batch = k x batch_size; the LR schedule counts
        # updates)
        self.grad_accum = max(int(grad_accum), 1)
        self.steps_per_epoch = max(
            len(train_dataset) // (config.train.batch_size * self.grad_accum),
            1,
        )
        # schedule selection mirrors train_3dvlp.py:180-196: --coslr ->
        # CosineAnnealingLR(T_max=min(epoch,200), eta_min=1e-5) applied
        # per param group; detection-only without coslr -> MultiStepLR
        # [80,120,160] x 0.1; otherwise constant LR
        t_max = min(config.train.epochs, 200)
        if config.train.lr_schedule == "cosine":
            self.schedule = lambda e, lr0: cosine_lr(  # noqa: E731
                e, lr0, t_max, config.train.coslr_eta_min)
        elif config.train.lr_schedule == "step":
            self.schedule = lambda e, lr0: step_lr(  # noqa: E731
                e, lr0, config.train.lr_decay_steps,
                config.train.lr_decay_rate)
        else:
            self.schedule = None
        self.model: JointNet | None = None
        self.optimizer = None
        self.best = {
            "epoch": 0, "sum": -1e10, "ground_sum": -1e10,
            "ground_25": -1e10, "ground_5": -1e10, "caption_sum": -1e10,
        }
        self._logf = open(os.path.join(workdir, "log.jsonl"), "a")
        # tensorboard dual writers (solver_3dvlp.py:214-221)
        tb_dir = os.path.join(workdir, "tensorboard")
        self._tb_train = SummaryWriter(os.path.join(tb_dir, "train"))
        self._tb_val = SummaryWriter(os.path.join(tb_dir, "val"))
        # wandb mirror with phase-prefixed keys (solver_3dvlp.py:531-565);
        # offline JSONL fallback when the package is absent
        self._wandb = WandbWriter(workdir, enabled=use_wandb)
        self._global_step = 0
        self._signal = None

    # ------------------------------------------------------------ model
    def bn_momentum(self, epoch: int) -> float:
        """The epoch's BatchNorm momentum in torch's convention (the JAX
        solver's ``_bn_momentum`` is one minus this)."""
        if not self.use_bn_schedule:
            return 0.1
        return bn_momentum_torch(
            epoch,
            self.config.train.bn_momentum_init,
            0.5,
            self.config.train.bn_decay_step,
            self.config.train.bn_momentum_min,
        )

    def _set_epoch(self, epoch: int) -> None:
        m = self.bn_momentum(epoch)
        for mod in self.model.modules():
            if isinstance(mod, BatchNorm):
                mod.momentum = m

    def init_state(self, sample_batch: dict | None = None):
        """The model (JointNet's seeded initialisation), its optimizer and
        steps. ``sample_batch`` (a loader batch) is checked against the
        model's input width."""
        cfg = self.config
        if sample_batch is not None:
            width = np.shape(sample_batch["point_clouds"])[-1]
            want = 3 + cfg.model.input_feature_dim
            if width != want:
                raise ValueError(
                    f"the loader's point clouds have {width} channels; the "
                    f"model takes {want}")
        self.model = JointNet(cfg, device=self.device)
        self.optimizer = make_optimizer(
            self.model,
            base_lr=cfg.train.lr,
            module_lr=cfg.train.module_lr,
            weight_decay=cfg.train.weight_decay,
            lr_schedule=self.schedule,
            steps_per_epoch=self.steps_per_epoch,
            amsgrad=cfg.train.amsgrad,
            optim_name=cfg.train.optim_name,
            single_group=cfg.train.single_lr_group,
            clip_grad_value=cfg.train.clip_grad_value,
            grad_accum=self.grad_accum,
        )
        self.train_step = make_train_step(self.model, cfg, self.optimizer,
                                          caption=self.caption)
        self.eval_step = make_eval_step(self.model, cfg)

    # ------------------------------------------------------------ feeds
    def _log(self, record: dict):
        record["time"] = time.time()
        self._logf.write(json.dumps(record, default=float) + "\n")
        self._logf.flush()

    def _on_signal(self, signum, frame):
        self._signal = signum

    def _check_interrupt(self):
        """Raise KeyboardInterrupt at a step boundary once SIGTERM or
        SIGINT has arrived."""
        if self._signal is not None:
            raise KeyboardInterrupt

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, epoch: int):
        self._sync()
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_epoch{epoch}.json")
        prof.export_chrome_trace(path)
        self._profiled = True
        self._log({"phase": "profile", "dir": self.profile_dir,
                   "trace": path})

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.config
        self.train_dataset.shuffle_data()
        loader = BatchIterator(
            self.train_dataset,
            cfg.train.batch_size,
            epoch=epoch,
            num_workers=cfg.train.num_workers,
            rng=self.np_rng,
        )
        self._set_epoch(epoch)
        n_iters = len(loader)
        agg = []
        prof, stop_at = None, -1
        self.timers.start("fetch")
        for it, host in enumerate(loader):
            self.timers.stop("fetch")
            batch = batch_to_device(
                {k: v for k, v in host.items() if not isinstance(v, list)},
                self.device)
            if (self.profile_dir and not self._profiled and prof is None
                    and epoch == 0 and it == 2):  # past the first launches
                prof, stop_at = self._start_profile(), it + PROFILE_STEPS
            self.timers.start("iter")
            metrics = self.train_step(batch, self.generator)
            self._global_step += 1
            if prof is not None and it + 1 == stop_at:
                self._stop_profile(prof, epoch)
                prof = None
            if it % self.log_every == 0 or it == n_iters - 1:
                # the step's whole device work counts in its iter time
                self._sync()
                scal = {k: float(v) for k, v in metrics.items()}
                agg.append(scal)
                self._tb_train.add_scalars(scal, self._global_step)
                self._tb_train.add_scalars(
                    self.timers.report(), self._global_step, prefix="time/"
                )
                self._tb_train.flush()
                self._wandb.log(
                    {"iter": self._global_step, "epoch": epoch,
                     **{f"train_{k}": v for k, v in scal.items()}}
                )
                self._log(
                    {
                        "phase": "train",
                        "epoch": epoch,
                        "iter": it,
                        **scal,
                        **self.timers.report(),
                        "eta": eta_str(
                            self.timers.mean("iter"), n_iters - it
                        ),
                    }
                )
            self.timers.stop("iter")
            self._check_interrupt()
            self.timers.start("fetch")
        self.timers.stop("fetch")
        if prof is not None:  # epoch shorter than the profile window
            self._stop_profile(prof, epoch)
        # the device's memory high-water mark ({} on the CPU)
        mem = device_memory_mb(self.device)
        if mem:
            self._log({"phase": "memory", "epoch": epoch, **mem})
            self._tb_train.add_scalars(mem, self._global_step, prefix="mem/")
        return {
            k: float(np.mean([a[k] for a in agg]))
            for k in agg[0]
        } if agg else {}

    def eval_epoch(self, epoch: int) -> dict:
        cfg = self.config
        loader = BatchIterator(
            self.val_dataset,
            cfg.train.batch_size,
            epoch=epoch,
            drop_last=False,
            num_workers=cfg.train.num_workers,
            rng=self.np_rng,
        )
        ious, multiple, others, lang_accs, scalars = [], [], [], [], []
        ans_hit1 = ans_hit10 = 0.0
        ans_n = 0
        for host in loader:
            # a trailing partial batch runs as it is
            arrays = {
                k: v for k, v in host.items() if not isinstance(v, list)
            }
            batch = batch_to_device(arrays, self.device)
            out, metrics = self.eval_step(batch)
            if "answer_scores" in out and "answer_cats" in batch:
                hit1, hit10, n = self._answer_hits(out, batch)
                ans_hit1 += hit1
                ans_hit10 += hit10
                ans_n += n
            out_np = {k: out[k].cpu().numpy() for k in EVAL_KEYS if k in out}
            g = get_eval(
                out_np,
                arrays,
                mean_size_arr=self.mean_size_arr,
                use_lang_classifier=cfg.model.use_lang_classifier,
            )
            ious += g["ref_iou"]
            multiple += g["ref_multiple_mask"]
            others += g["ref_others_mask"]
            lang_accs.append(g["lang_acc"])
            scalars.append({k: float(v) for k, v in metrics.items()})
            self._check_interrupt()

        ious_np = np.asarray(ious)
        result = {
            "iou_rate_0.25": float((ious_np >= 0.25).mean()) if len(ious) else 0.0,
            "iou_rate_0.5": float((ious_np >= 0.5).mean()) if len(ious) else 0.0,
            "lang_acc": float(np.mean(lang_accs)) if lang_accs else 0.0,
            **final_eval_breakdown(ious, multiple, others),
        }
        if ans_n:
            result["answer_acc_at1"] = ans_hit1 / ans_n
            result["answer_acc_at10"] = ans_hit10 / ans_n
        if self.caption and self.caption_eval_ctx is not None:
            result.update(self.caption_eval(epoch))
        if scalars:
            for k in scalars[0]:
                result[k] = float(np.mean([s[k] for s in scalars]))
        val_scalars = {
            k: v for k, v in result.items() if np.ndim(v) == 0
        }
        self._tb_val.add_scalars(
            {k: float(v) for k, v in val_scalars.items()
             if isinstance(v, (int, float))},
            self._global_step,
        )
        self._tb_val.flush()
        self._wandb.log(
            {"epoch": epoch, **{
                f"val_{k}": float(v) for k, v in val_scalars.items()
                if isinstance(v, (int, float))
            }}
        )
        self._log({"phase": "val", "epoch": epoch, **val_scalars})
        return result

    @staticmethod
    def _answer_hits(out: dict, batch: dict):
        """(EM@1 hits, EM@10 hits, questions) of one eval batch, over the
        question slots its items fill (``lang_num``; the padded slots
        repeat a question and count in the loss only)."""
        cats = batch["answer_cats"]
        b, l = cats.shape[:2]
        hit1, hit10 = answer_hits(out["answer_scores"],
                                  cats.reshape(b * l, -1))
        valid = (torch.arange(l, device=cats.device)[None, :]
                 < batch["lang_num"][:, None]).reshape(-1)
        return (float(hit1[valid].sum()), float(hit10[valid].sum()),
                int(valid.sum()))

    def caption_eval(self, epoch: int) -> dict:
        """A greedy caption for every proposal of the val split, gated by
        NMS and IoU >= 0.5 against the assigned GT box, scored as
        BLEU / CIDEr / ROUGE-L / METEOR (eval_cap,
        lib/joint/eval_helper.py:278-357)."""
        ctx = self.caption_eval_ctx
        loader = BatchIterator(
            self.val_dataset, self.config.train.batch_size, epoch=epoch,
            num_workers=self.config.train.num_workers, rng=self.np_rng)
        candidates: dict = {}
        for host in loader:
            arrays = {k: v for k, v in host.items()
                      if not isinstance(v, list)}
            out, _ = self.eval_step(batch_to_device(arrays, self.device))
            collect_batch(self.model, out, arrays, host["scene_id"],
                          ctx["tokenizer"], ctx["organized"], candidates)
            self._check_interrupt()
        return score_captions(ctx["corpus"], candidates)

    # ------------------------------------------------------------ loop
    def _snapshot(self, name: str) -> None:
        ckpt.save_params(self.workdir, name, self.model.state_dict())

    def __call__(self, epochs: int, *, start_epoch: int = 0) -> dict:
        """Run epochs [start_epoch, epochs), each followed by its val
        epoch. start_epoch > 0 resumes the
        epoch/curriculum clock after a checkpoint restore (the epoch-50
        loss switches, BN-momentum schedule, and best-model taxonomy all
        key on the true epoch number; the reference's --use_checkpoint
        restores weights but restarts that clock at 0,
        train_3dvlp.py:160-171)."""
        # Preemption delivers SIGTERM, ^C SIGINT: both end the run through
        # the save-and-exit path, at the next step boundary
        # (solver_3dvlp.py:356-359 handles ^C only)
        saved_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                saved_handlers[sig] = signal.signal(sig, self._on_signal)
        self._signal = None
        epoch = start_epoch
        # last epoch whose training fully completed — what the interrupt
        # checkpoint must be stamped with. Stamping the CURRENT epoch
        # would make --auto_resume skip the interrupted epoch's remaining
        # batches; stamping done_epoch replays it from the top instead
        # (conservative: a few duplicated updates, never silently-missing
        # training).
        done_epoch = start_epoch - 1
        try:
            for epoch in range(start_epoch, epochs):
                self._check_interrupt()
                self.train_epoch(epoch)
                self._snapshot("model_last")
                if epoch == 49:
                    self._snapshot("epoch_50")

                val = self.eval_epoch(epoch)
                ground_sum = val["iou_rate_0.5"]
                # criterion 'sum' = 2 x iou_rate_0.5 (solver:1126-1128);
                # any val-metric name selects on that metric; unknown
                # names leave cur_best 0 as the joint reference does
                # (:1129-1135)
                cur_best = (
                    ground_sum * 2 if self.criterion == "sum"
                    else float(val.get(self.criterion, 0.0))
                )
                if cur_best > self.best["sum"]:
                    self.best.update(
                        epoch=epoch + 1, sum=cur_best, **{
                            k: v for k, v in val.items()
                            if np.ndim(v) == 0
                        }
                    )
                    self._snapshot("model")
                if ground_sum > self.best["ground_sum"]:
                    self.best["ground_sum"] = ground_sum
                    self._snapshot("ground_model")
                if val["iou_rate_0.25"] > self.best["ground_25"]:
                    self.best["ground_25"] = val["iou_rate_0.25"]
                    self._snapshot("ground_model_25")
                if val["iou_rate_0.5"] > self.best["ground_5"]:
                    self.best["ground_5"] = val["iou_rate_0.5"]
                    self._snapshot("ground_model_5")
                if "bleu-4" in val:
                    caption_sum = float(sum(val[m] for m in CAPTION_METRICS))
                    if caption_sum > self.best["caption_sum"]:
                        self.best["caption_sum"] = caption_sum
                        self.best["best_caption_epoch"] = epoch + 1
                        for m in CAPTION_METRICS:
                            self.best[f"best_caption_{m}"] = float(val[m])
                        self._snapshot("caption_model")

                # the epoch counts as done only once its eval + best-model
                # snapshotting completed: an interrupt landing during
                # eval_epoch(E) then replays E on --auto_resume instead of
                # silently skipping E's eval/taxonomy updates
                done_epoch = epoch

                if epoch % 10 == 0 and epoch != 0:
                    self._save_full_checkpoint(epoch)
        except KeyboardInterrupt:
            # save-and-exit on interrupt/preemption (solver_3dvlp.py:356-359).
            # The state is that of a whole step: the flag is read only
            # between steps. Never REGRESS the on-disk resume record: an
            # interrupt before any epoch of THIS call completed must not
            # overwrite whatever checkpoint already exists.
            if done_epoch >= start_epoch:
                self._save_full_checkpoint(done_epoch)
                print(f"interrupted during epoch {epoch} — checkpoint "
                      f"(through epoch {done_epoch}) saved to "
                      f"{self.workdir}")
            else:
                print(f"interrupted during epoch {epoch} before any "
                      f"epoch of this run completed — existing "
                      f"checkpoint (if any) stands; nothing saved")
            self._log({"phase": "interrupt", "epoch": epoch})
            self._finish()
            return self.best
        finally:
            for sig, handler in saved_handlers.items():
                signal.signal(sig, handler)
        self._save_full_checkpoint(epochs - 1)
        self._finish()
        return self.best

    def _save_full_checkpoint(self, epoch: int) -> None:
        ckpt.save_checkpoint(self.workdir, self.model, self.optimizer,
                             self.best, epoch)

    def _finish(self) -> None:
        """Best-metric report + all_scalars.json export (the reference's
        _finish, solver_3dvlp.py:1221-1245; checkpoints are already saved
        by the caller)."""
        lines = ["best model at epoch %d" % self.best.get("epoch", 0)]
        lines += [
            f"  {k}: {v:.6f}" if isinstance(v, float) else f"  {k}: {v}"
            for k, v in sorted(self.best.items())
        ]
        with open(os.path.join(self.workdir, "log.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
        self._log({"phase": "best", **self.best})
        self._tb_train.export_scalars_to_json()
        self._tb_val.export_scalars_to_json()
        self._tb_train.flush()
        self._tb_val.flush()

    def close(self) -> None:
        """Close the log, TensorBoard and wandb writers."""
        self._tb_train.close()
        self._tb_val.close()
        self._wandb.finish()
        self._logf.close()

    def warm_start(self, path: str) -> tuple[int, int]:
        """strict=False restore from a save_params snapshot (a ``.pth``
        file) into the live model (the reference's --pretrain,
        train_3dvlp.py:115-121); returns (restored, fresh) state-dict
        entries."""
        if self.model is None:
            raise RuntimeError("call init_state first")
        merged, n_restored, n_skipped = ckpt.load_params_partial(
            path, self.model.state_dict())
        self.model.load_state_dict(merged, strict=True)
        return n_restored, n_skipped
