from vlp3d_torch.train.optimizer import make_optimizer
from vlp3d_torch.train.state import (
    batch_to_device,
    make_eval_step,
    make_train_step,
)

__all__ = ["make_optimizer", "make_train_step", "make_eval_step",
           "batch_to_device"]
