"""Joint 3DVLP training entry point.

The port's counterpart of ``vlp3d/cli/train_3dvlp.py`` (itself
`scripts/joint_scripts/train_3dvlp.py`): run.sh's command with this
module's name trains on the card,

  python -m vlp3d_torch.cli.train_3dvlp --use_multiview --use_normal \\
      --batch_size 8 --epoch 200 --lang_num_max 8 --coslr --lr 0.002 \\
      --no_caption --lang_num_aug 0 --unfreeze 6 --debug --use_con \\
      --use_diou_loss [--synthetic]

and ``--synthetic --smoke --device cpu`` runs the tiny configuration on
the CPU with the plain PyTorch ops. One process, one device: a
``WORLD_SIZE`` above 1 raises (data parallel is ROADMAP.md queue A item
A18), as do ``--tp`` and ``--zero1`` (A19).
"""

from __future__ import annotations

import argparse
import json
import os

DIST_ITEM = "ROADMAP.md queue A item A18 (data parallel)"


def main(argv=None):
    from vlp3d_torch.cli.common import (
        add_common_args,
        build_datasets,
        resolve_config,
        resolve_workdir,
        resume_solver,
    )

    p = argparse.ArgumentParser()
    add_common_args(p)
    args = p.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"vlp3d_torch trains in one process (WORLD_SIZE="
            f"{os.environ['WORLD_SIZE']}); see {DIST_ITEM}")

    config = resolve_config(args)
    train_ds, val_ds = build_datasets(args, config)
    workdir = resolve_workdir(args)
    with open(os.path.join(workdir, "info.json"), "w") as f:
        json.dump({"args": vars(args)}, f, indent=2)

    from vlp3d_torch.data.dataset import BatchIterator
    from vlp3d_torch.train.solver import Solver

    solver = Solver(
        config,
        train_ds,
        val_ds,
        workdir,
        caption=not config.model.no_caption,
        detection=not args.no_detection,
        reference=not config.model.no_reference,
        use_bn_schedule=config.model.no_caption,
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
            # strict=False warm start from a previous stage's snapshot —
            # the staged grounding -> caption -> QA recipe
            # (train_3dvlp.py:115-121, train_caption.py:110-115)
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


if __name__ == "__main__":
    main()
