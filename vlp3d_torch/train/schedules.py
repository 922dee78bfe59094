"""LR and BatchNorm-momentum schedules.

Counterpart of ``vlp3d/train/schedules.py``. Cosine LR: torch
CosineAnnealingLR stepped per epoch with T_max = min(epochs, 200), eta_min
1e-5 (train_3dvlp.py:181-193). BN momentum: 0.5 * 0.5^(epoch // 20)
floored at 1e-3 (solver_3dvlp.py:261-271), in torch's convention, which
is also :class:`vlp3d_torch.models.layers.BatchNorm`'s.
"""

from __future__ import annotations

import math


def cosine_lr(epoch: int, base_lr: float, t_max: int,
              eta_min: float = 1e-5) -> float:
    e = min(epoch, t_max)
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * e / t_max)) / 2


def step_lr(epoch: int, base_lr: float, decay_steps,
            decay_rate: float) -> float:
    """MultiStepLR for detection-only runs (LR_DECAY_STEP = [80, 120, 160],
    rate 0.1; train_3dvlp.py:180, 194)."""
    k = sum(int(epoch >= s) for s in decay_steps)
    return base_lr * (decay_rate ** k)


def bn_momentum_torch(epoch: int, init: float = 0.5, rate: float = 0.5,
                      step: int = 20, floor: float = 1e-3) -> float:
    return max(init * (rate ** (int(epoch) // step)), floor)
