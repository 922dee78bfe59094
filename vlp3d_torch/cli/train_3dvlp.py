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
        run_training,
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

    return run_training(args, config, train_ds, val_ds, workdir,
                        caption=not config.model.no_caption,
                        use_bn_schedule=config.model.no_caption)


if __name__ == "__main__":
    main()
