"""Captioning fine-tune entry point (scripts/joint_scripts/train_caption.py).

The port's counterpart of ``vlp3d/cli/train_caption.py``: the joint
trainer with the caption head on (``--no_caption`` dropped from the
flags), warm-started from a grounding run's snapshot with
``--pretrain <model.pth>`` (train_caption.py:110-115).

    python -m vlp3d_torch.cli.train_caption --use_multiview --use_normal \\
        --batch_size 8 --epoch 200 --lang_num_max 8 --coslr --lr 0.002 \\
        --lang_num_aug 0 --unfreeze 6 --use_con --use_diou_loss \\
        --pretrain RUN/model.pth
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = [a for a in argv if a != "--no_caption"]
    from vlp3d_torch.cli.train_3dvlp import main as train_main

    return train_main(argv)


if __name__ == "__main__":
    main()
