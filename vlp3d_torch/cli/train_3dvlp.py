"""Joint 3DVLP training entry point.

The port's counterpart of ``vlp3d/cli/train_3dvlp.py`` (itself
`scripts/joint_scripts/train_3dvlp.py`): run.sh's command with this
module's name trains on the card,

  python -m vlp3d_torch.cli.train_3dvlp --use_multiview --use_normal \\
      --batch_size 8 --epoch 200 --lang_num_max 8 --coslr --lr 0.002 \\
      --no_caption --lang_num_aug 0 --unfreeze 6 --debug --use_con \\
      --use_diou_loss [--synthetic]

and ``--synthetic --smoke --device cpu`` runs the tiny configuration on
the CPU with the plain PyTorch ops. Data parallel, one process a card,
``--batch_size`` the global batch:

  python -m torch.distributed.run --nproc_per_node 8 \\
      -m vlp3d_torch.cli.train_3dvlp <the flags above>
  srun --ntasks-per-node 8 python -m vlp3d_torch.cli.train_3dvlp ...

(env:// or SLURM rendezvous, :func:`vlp3d_torch.parallel.distributed.dist_init`;
with ``--device cpu`` the ranks meet over gloo). Tensor parallel and
ZeRO-1 on a (data, model) grid of dp x tp ranks, here dp 2 x tp 2:

  python -m torch.distributed.run --nproc_per_node 4 \\
      -m vlp3d_torch.cli.train_3dvlp <the flags above> --tp 2 --zero1
"""

from __future__ import annotations

import argparse
import json
import os

def main(argv=None):
    from vlp3d_torch.cli.common import (
        add_common_args,
        build_datasets,
        process_group,
        resolve_config,
        resolve_workdir,
        run_training,
    )
    from vlp3d_torch.parallel.distributed import is_main_process

    p = argparse.ArgumentParser()
    add_common_args(p)
    args = p.parse_args(argv)
    with process_group(args):
        config = resolve_config(args)
        train_ds, val_ds = build_datasets(args, config)
        workdir = resolve_workdir(args)
        if is_main_process():
            with open(os.path.join(workdir, "info.json"), "w") as f:
                json.dump({"args": vars(args)}, f, indent=2)

        return run_training(args, config, train_ds, val_ds, workdir,
                            caption=not config.model.no_caption,
                            use_bn_schedule=config.model.no_caption)


if __name__ == "__main__":
    main()
