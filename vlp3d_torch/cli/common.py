"""Shared CLI plumbing: the flag surface, the config, ScanRefer loading,
the datasets, the run directory and the solver's resume.

The port's own copy of ``vlp3d/cli/common.py``: the same flags (plus
``--device``), the same config arithmetic, the same datasets and the
same resume rules. ``--use_mlcv_net``, the one model option the port
lacks, raises NotImplementedError in :func:`config_from_args`
(:func:`vlp3d_torch.config.check_supported` names its ROADMAP item).
``--tp`` and ``--zero1`` act in the training CLIs (:func:`run_training`)
and, as in the JAX package, are accepted and ignored by the others, as
``--no_donate`` is. Unlike the JAX CLIs, ``--smoke`` keeps the model
options (:func:`model_flags`) in its tiny configuration, so that a smoke
run trains the model they describe.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

from vlp3d_torch.config import (
    Config,
    DatasetConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
    check_supported,
)
from vlp3d_torch.data.dataset import (
    DirectorySceneSource,
    ScanReferJointDataset,
    build_nyu40id2class,
    load_raw2label,
)
from vlp3d_torch.data.synthetic import make_synthetic_dataset, tiny_config
from vlp3d_torch.data.tokenizer import load_tokenizer




def model_flags(args) -> dict:
    """The ModelConfig options the CLI flags set (the run.sh flag ->
    field mapping of train_3dvlp.py:588-774)."""
    return dict(
        no_caption=args.no_caption,
        no_reference=args.no_reference,
        use_lang_classifier=not args.no_lang_cls,
        use_con=args.use_con,
        use_mlm=args.use_mlm,
        use_answer=args.use_answer,
        use_reg_head=args.use_reg_head,
        use_kl_loss=args.use_kl_loss,
        use_lang_emb=args.use_lang_emb,
        use_vote_weight=args.use_vote_weight,
        mask_box=args.mask_box,
        use_distil=args.use_distil,
        use_mlcv_net=getattr(args, "use_mlcv_net", False),
        remat=getattr(args, "remat", False),
    )


def add_common_args(p: argparse.ArgumentParser):
    # mirrors the reference's flag surface (train_3dvlp.py:588-774)
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--workdir", type=str, default="",
                   help="exact run directory (skips the timestamped "
                        "output_dir/STAMP layout). A stable workdir is "
                        "what makes --auto_resume usable on preemptible "
                        "machines: the restarted command finds its own "
                        "checkpoint")
    p.add_argument("--auto_resume", action="store_true",
                   help="if the workdir already holds a resume "
                        "checkpoint, continue from it (state + best "
                        "taxonomy + next epoch). With the solver's "
                        "SIGTERM save-and-exit, preemption recovery is: "
                        "rerun the same command (beyond the reference, "
                        "whose --use_checkpoint restores weights but "
                        "restarts the epoch/curriculum clock)")
    p.add_argument("--scanrefer_dir", type=str, default="data/scanrefer")
    p.add_argument("--scannet_data", type=str, default="data/scannet_data")
    p.add_argument("--labels_tsv", type=str, default="")
    p.add_argument("--mean_size_npz", type=str, default="")
    p.add_argument("--bert_vocab", type=str, default="")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--wd", type=float, default=1e-3)
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--num_proposals", type=int, default=256)
    p.add_argument("--lang_num_max", type=int, default=8)
    p.add_argument("--lang_num_aug", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--coslr", action="store_true")
    p.add_argument("--no_caption", action="store_true")
    p.add_argument("--no_reference", action="store_true")
    p.add_argument("--no_lang_cls", action="store_true")
    p.add_argument("--use_con", action="store_true")
    p.add_argument("--use_mlm", action="store_true")
    p.add_argument("--use_answer", action="store_true")
    p.add_argument("--use_diou_loss", action="store_true")
    p.add_argument("--use_kl_loss", action="store_true")
    p.add_argument("--use_reg_head", action="store_true")
    p.add_argument("--use_lang_emb", action="store_true")
    p.add_argument("--use_vote_weight", action="store_true")
    p.add_argument("--use_attr_loss", action="store_true")
    p.add_argument("--mask_box", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--multiview_hdf5", type=str, default="",
                   help="enet_feats_maxpool.hdf5 with per-point 128-d "
                        "features appended to the preprocess npy columns")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_height", action="store_true", default=True)
    p.add_argument("--use_distil", action="store_true")
    p.add_argument("--unfreeze", type=int, default=6)
    p.add_argument("--use_checkpoint", type=str, default="")
    p.add_argument("--pretrain", type=str, default="")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--num_workers", type=int, default=4,
                   help="loader worker threads (reference DataLoader "
                        "num_workers=4, train_3dvlp.py:48-77); the batch "
                        "stream is identical for any value")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree of the training CLIs: a "
                        "(data, model) grid of the torchrun ranks, world "
                        "size dp x tp, Megatron-style splits of the BERT, "
                        "caption and match feed-forward layers; the other "
                        "CLIs accept it and do nothing")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 in the training CLIs: the optimizer's "
                        "moments sharded over the data ranks (composes "
                        "with --tp); the other CLIs accept it and do "
                        "nothing")
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbone SA/FP blocks in the "
                        "backward pass (torch.utils.checkpoint; the point "
                        "indices are kept): less activation memory for "
                        "about one more backbone forward, the same "
                        "gradients")
    p.add_argument("--no_donate", action="store_true",
                   help="accepted for the JAX CLI's flag set and does "
                        "nothing: the port's optimizer updates the "
                        "parameters in place, so there is no buffer to "
                        "donate")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient accumulation: mean gradients over K "
                        "micro-batches, one optimizer update per K "
                        "(effective batch = K x batch_size; the LR "
                        "schedule counts updates)")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic scenes (no ScanNet needed)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes, 2 epochs — CI smoke run")

    # --- remaining reference-surface flags (train_3dvlp.py:588-774) ---
    # behavioral:
    p.add_argument("--dataset", type=str, default="ScanRefer",
                   help="annotation set; the reference accepts only "
                        "ScanRefer (train_3dvlp.py:256-262)")
    p.add_argument("--use_mlcv_net", action="store_true",
                   help="CGNL backbone/voting variant (jointnet.py:63-69)")
    p.add_argument("--use_color", action="store_true",
                   help="RGB input channels, normalized by MEAN_COLOR_RGB "
                        "(lib/joint/dataset.py:960)")
    p.add_argument("--no_height", action="store_true",
                   help="drop the height input channel")
    p.add_argument("--no_augment", action="store_true",
                   help="disable train-time augmentation")
    p.add_argument("--no_detection", action="store_true",
                   help="do NOT train the detection module")
    p.add_argument("--minor_aug", action="store_true",
                   help="minor-class sentence-slot augmentation")
    p.add_argument("--amsgrad", action="store_true",
                   help="AMSGrad variant of AdamW (scripts/utils/AdamW.py)")
    p.add_argument("--num_scenes", type=int, default=-1,
                   help="limit the number of training scenes (-1 = all)")
    p.add_argument("--num_ground_epoch", type=int, default=50,
                   help="grounding-curriculum switch epoch")
    p.add_argument("--criterion", type=str, default="sum",
                   help="best-model criterion: 'sum' (2 x iou_rate_0.5, "
                        "solver_3dvlp.py:1114-1128) or a val-metric name "
                        "(the VQA path's answer_acc_at1)")
    p.add_argument("--use_wandb", action="store_true",
                   help="mirror metrics to wandb (train_3dvlp.py:790-794); "
                        "falls back to an offline JSONL stream "
                        "(wandb_offline.jsonl) when the package is "
                        "unavailable")
    p.add_argument("--verbose", type=int, default=10,
                   help="iteration logging interval")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of a few "
                        "train iterations of epoch 0 (from iteration 2) "
                        "into this directory")
    p.add_argument("--val_step", type=int, default=2000)
    # accepted for flag-for-flag parity; inert in the reference's joint
    # path too (constructor args JointNet stores but never reads, or
    # 3DJCG-era graph/caption options the joint model doesn't build):
    p.add_argument("--gpu", type=str, default="0",
                   help="accepted for parity; the port picks its device "
                        "with --device")
    p.add_argument("--num_locals", type=int, default=-1)
    p.add_argument("--num_graph_steps", type=int, default=0)
    p.add_argument("--query_mode", type=str, default="center")
    p.add_argument("--graph_mode", type=str, default="edge_conv")
    p.add_argument("--graph_aggr", type=str, default="add")
    p.add_argument("--use_tf", action="store_true",
                   help="inert in the joint path: jointnet.forward ignores "
                        "use_tf (jointnet.py:112,214)")
    p.add_argument("--use_topdown", action="store_true")
    p.add_argument("--use_relation", action="store_true")
    p.add_argument("--use_new", action="store_true")
    p.add_argument("--use_orientation", action="store_true")
    p.add_argument("--use_distance", action="store_true")
    p.add_argument("--use_bidir", action="store_true")
    p.add_argument("--use_pc_encoder", action="store_true",
                   help="accepted for parity; dormant in the reference "
                        "(JointNet never instantiates pc_encoder, "
                        "jointnet.py:19,170)")
    p.add_argument("--use_match_con_loss", action="store_true",
                   help="stored but never read by the reference "
                        "(match_module.py:74)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the current "
                        "CUDA device; without one the run fails rather "
                        "than fall back). Pass cpu for the plain PyTorch "
                        "ops")
    return p


@contextlib.contextmanager
def process_group(args):
    """A training CLI's process group: the multi-process rendezvous
    (env:// under torchrun, SLURM under srun; a no-op in one process)
    before any device use, the group printed, the ranks' hash seed held
    equal under the hash tokenizer (no ``--bert_vocab``, ROADMAP.md C12),
    and the group destroyed at the end."""
    from vlp3d_torch.parallel.distributed import (
        backend,
        check_same_hash_seed,
        dist_close,
        dist_init,
        initialized,
    )

    ctx = dist_init(device=args.device)
    if initialized():  # a group of one under torchrun too
        print(f"| distributed init (rank {ctx.rank}/{ctx.world_size}): "
              f"{ctx.coordinator} over {backend()}", flush=True)
    try:
        if not args.bert_vocab:
            check_same_hash_seed()
        yield ctx
    finally:
        dist_close()


def resolve_workdir(args) -> str:
    """--workdir verbatim, else the reference's timestamped
    output_dir/STAMP[_TAG] layout (train_3dvlp.py:162-177), rank 0's
    stamp under data parallel."""
    if getattr(args, "workdir", ""):
        workdir = args.workdir
    else:
        from datetime import datetime

        from vlp3d_torch.parallel.distributed import broadcast_object

        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        if args.tag:
            stamp += "_" + args.tag.upper()
        workdir = os.path.join(args.output_dir, broadcast_object(stamp))
    os.makedirs(workdir, exist_ok=True)
    return workdir


def resume_solver(solver, args, workdir: str) -> int:
    """Apply --use_checkpoint / --auto_resume to a solver after
    ``init_state``; returns the start epoch for ``Solver.__call__``.

    Restores weights, optimizer (its moments and step count, so the LR
    schedule goes on from the restored count either way) and the
    best-model taxonomy (the reference's checkpoint_best,
    train_3dvlp.py:160-171). --auto_resume on the run's own checkpoint
    continues the epoch/curriculum clock at the epoch after the last
    completed one; --use_checkpoint restarts it at 0, as the reference
    does. Under data parallel every rank loads the same files, after a
    barrier: no rank reads the run directory while another still
    writes to it."""
    from vlp3d_torch.parallel.distributed import barrier

    barrier()
    resume_from = getattr(args, "use_checkpoint", "")
    continue_clock = False
    if (
        getattr(args, "auto_resume", False)
        and not resume_from
        and os.path.exists(os.path.join(workdir, "checkpoint_meta.json"))
    ):
        # the run's OWN checkpoint: continue the epoch/curriculum clock
        resume_from = workdir
        continue_clock = True
    if not resume_from:
        return 0
    from vlp3d_torch.train.checkpoint import load_checkpoint

    meta = load_checkpoint(resume_from, solver.model, solver.optimizer)
    solver.best.update(meta.get("best", {}))
    if not continue_clock:
        # explicit --use_checkpoint = fine-tuning-style restart: weights/
        # optimizer/best restored but the epoch clock starts at 0, like
        # the reference (train_3dvlp.py:160-171)
        print(f"restored {resume_from} (saved @ epoch {meta['epoch']}) — "
              f"epoch clock restarts at 0 (--auto_resume continues it)")
        return 0
    start_epoch = int(meta["epoch"]) + 1
    print(f"resumed from {resume_from} @ epoch {meta['epoch']} — "
          f"continuing at epoch {start_epoch}")
    return start_epoch


def run_training(args, config: Config, train_ds, val_ds, workdir: str, *,
                 caption: bool, use_bn_schedule: bool) -> dict:
    """The training CLIs' common end: the Solver over the datasets, its
    state, the ``--pretrain`` warm start (strict=False, from a previous
    stage's snapshot: the staged grounding -> caption -> QA recipe,
    train_3dvlp.py:115-121, train_caption.py:110-115, train_qa.py:
    129-134), ``--use_checkpoint`` / ``--auto_resume``, the epochs; prints
    and returns the best-model record."""
    from vlp3d_torch.data.dataset import BatchIterator
    from vlp3d_torch.train.solver import Solver

    solver = Solver(
        config,
        train_ds,
        val_ds,
        workdir,
        caption=caption,
        detection=not args.no_detection,
        reference=not config.model.no_reference,
        use_bn_schedule=use_bn_schedule,
        log_every=args.verbose,
        criterion=args.criterion,
        tp=args.tp,
        zero1=args.zero1,
        grad_accum=args.grad_accum,
        seed=args.seed,
        use_wandb=args.use_wandb,
        profile_dir=args.profile_dir or None,
        device=args.device,
    )
    try:
        sample = next(iter(BatchIterator(train_ds, config.train.batch_size)))
        solver.init_state(sample)
        if args.pretrain:
            n_restored, n_skipped = solver.warm_start(args.pretrain)
            print(f"warm-started from {args.pretrain}: {n_restored} "
                  f"entries restored, {n_skipped} fresh")
        # --auto_resume: a stable --workdir + rerunning the same command
        # is the whole preemption-recovery story (SIGTERM -> save-and-exit
        # -> restart -> continue); a first run falls through to a fresh
        # start
        start_epoch = resume_solver(solver, args, workdir)
        best = solver(config.train.epochs, start_epoch=start_epoch)
    finally:
        solver.close()
    print(json.dumps({k: v for k, v in best.items()}, default=float))
    return best


def config_from_args(args) -> Config:
    # input channel arithmetic mirrors train_3dvlp.py:82-83:
    # 3 + color*3 + (not no_height) + normal*3 + multiview*128
    input_dim = 0 if getattr(args, "no_height", False) else 1
    if getattr(args, "use_color", False):
        input_dim += 3
    if args.use_multiview:
        input_dim += 128
    if args.use_normal:
        input_dim += 3
    # relation's object embedding slices the multiview channels when
    # present (relation_module.py:101); otherwise use whatever per-point
    # features exist
    feat_before_mv = (
        3
        + 3 * int(getattr(args, "use_color", False))
        + 3 * int(args.use_normal)
    )
    mv_offset, mv_dim = (
        (feat_before_mv, 128) if args.use_multiview else (3, input_dim)
    )
    model = ModelConfig(
        input_feature_dim=input_dim,
        multiview_offset=mv_offset,
        multiview_dim=mv_dim,
        num_proposal=args.num_proposals,
        lang_num_max=args.lang_num_max,
        **model_flags(args),
    )
    config = Config(
        dataset=DatasetConfig(
            num_points=args.num_points, mean_size_path=args.mean_size_npz
        ),
        model=model,
        loss=LossConfig(
            use_diou_loss=args.use_diou_loss,
            use_attr_loss=args.use_attr_loss,
            num_ground_epoch=getattr(args, "num_ground_epoch", 50),
            debug=args.debug,
        ),
        train=TrainConfig(
            batch_size=args.batch_size,
            epochs=args.epoch,
            lr=args.lr,
            weight_decay=args.wd,
            amsgrad=getattr(args, "amsgrad", False),
            # train_3dvlp.py:180-196: --coslr -> cosine; detection-only
            # without it -> MultiStepLR; else no scheduler. The VQA
            # paths override after resolve with their own MultiStepLR
            # recipe ([100, 200] x 0.2; lib/vqa/solver.py:210-216 —
            # their --coslr is parsed but unused).
            lr_schedule=(
                "cosine" if getattr(args, "coslr", False)
                else "step" if getattr(args, "no_caption", False)
                else "none"
            ),
            seed=args.seed,
            num_workers=getattr(args, "num_workers", 4),
        ),
    )
    check_supported(config)
    return config


def resolve_config(args) -> Config:
    """config_from_args, or the tiny synthetic config when --smoke."""
    if getattr(args, "smoke", False):
        tiny = tiny_config(**model_flags(args))
        args.synthetic = True
        config = dataclasses.replace(
            tiny,
            train=dataclasses.replace(
                tiny.train, batch_size=min(args.batch_size, 2), epochs=2
            ),
        )
        check_supported(config)
        return config
    return config_from_args(args)


def load_scanrefer(scanrefer_dir: str, split: str) -> list:
    path = os.path.join(scanrefer_dir, f"ScanRefer_filtered_{split}.json")
    with open(path) as f:
        data = json.load(f)
    return sorted(data, key=lambda d: (d["scene_id"], int(d["object_id"])))


def _check_dataset(args) -> None:
    if getattr(args, "dataset", "ScanRefer") != "ScanRefer":
        # the reference accepts only ScanRefer (train_3dvlp.py:261-262)
        raise ValueError("Invalid dataset.")


def _scanrefer_dataset(args, config: Config, split: str, augment: bool,
                       shuffle: bool):
    raw2label = load_raw2label(args.labels_tsv) if args.labels_tsv else {}
    nyu40map = (
        build_nyu40id2class(args.labels_tsv) if args.labels_tsv else {}
    )
    tokenizer = load_tokenizer(args.bert_vocab or None)
    source = DirectorySceneSource(
        args.scannet_data, multiview_hdf5=args.multiview_hdf5 or None
    )
    anns = load_scanrefer(args.scanrefer_dir, split)
    num_scenes = getattr(args, "num_scenes", -1)
    if num_scenes and num_scenes > 0 and split == "train":
        # limit to the first N scenes (--num_scenes)
        keep = set(sorted({d["scene_id"] for d in anns})[:num_scenes])
        anns = [d for d in anns if d["scene_id"] in keep]
    return ScanReferJointDataset(
        anns,
        source,
        tokenizer,
        split=split,
        num_points=config.dataset.num_points,
        lang_num_max=config.model.lang_num_max,
        lang_num_aug=args.lang_num_aug,
        augment=augment,
        shuffle=shuffle,
        minor_aug=getattr(args, "minor_aug", False),
        use_height=not getattr(args, "no_height", False),
        mean_size_arr=config.dataset.mean_size_arr(),
        raw2label=raw2label,
        nyu40id2class=nyu40map,
        bert_max_len=config.model.bert_seq_len,
        seed=args.seed,
    )


def build_val_dataset(args, config: Config):
    """The val split's dataset, which is all that evaluation and
    prediction read."""
    _check_dataset(args)
    if args.synthetic:
        return make_synthetic_dataset(
            config, n_scenes=2, anns_per_scene=6, split="val",
            seed=args.seed + 1,
        )
    return _scanrefer_dataset(args, config, "val", False, False)


def build_datasets(args, config: Config):
    """(train, val) datasets, as ``vlp3d/cli/common.py`` builds them:
    --synthetic gives 4 train scenes of 10 annotations (--num_scenes
    changes the 4) and 2 val scenes of 6; the train split augments unless
    --no_augment, and shuffles."""
    _check_dataset(args)
    if args.synthetic:
        n_scenes = getattr(args, "num_scenes", -1)
        train = make_synthetic_dataset(
            config, n_scenes=n_scenes if n_scenes > 0 else 4,
            anns_per_scene=10, augment=True,
            shuffle=True, seed=args.seed,
        )
        return train, build_val_dataset(args, config)
    no_augment = getattr(args, "no_augment", False)
    return (_scanrefer_dataset(args, config, "train", not no_augment, True),
            build_val_dataset(args, config))
