"""Optimizer: decoupled AdamW with per-module LR groups, and the VQA
recipe's Adam.

Counterpart of ``vlp3d/train/optimizer.py`` (the reference's vendored
AdamW + set_params_lr_dict, scripts/utils/AdamW.py,
script_utils.py:3-31): parameters under the lang / relation / match /
caption modules train at ``module_lr`` (5e-4) and everything else at
``base_lr`` (2e-3), each group on its own schedule of the epoch. Frozen
parameters (``requires_grad=False``: the BERT text encoder) are in no
group, so they see neither updates nor weight decay. A trained parameter
that got no gradient in a step (``.grad`` None: the contrast head before
epoch 50, whose losses are gated off) is updated as with a zero
gradient, as optax updates the JAX package's: its moments decay and
weight decay applies.

The update is written out rather than left to ``torch.optim.AdamW`` so
that it is, term for term, the chain the JAX package runs: moments, bias
correction, then ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
with ``amsgrad`` the running maximum is over the raw second moment and is
bias-corrected when read, torch's formulation (AdamW.py:100-110). Each
term runs as one ``torch._foreach_*`` call over a group's tensors: a loop
over ~200 parameters costs ~2000 small launches a step, which on the card
is host time the device waits for.

The VQA recipe (``optim_name="adam"``, ``single_group``,
``clip_grad_value``; scripts/joint_scripts/train_qa.py:145-159,
lib/vqa/solver.py:336-339) is optax's chain ``clip -> add_decayed_weights
-> scale_by_adam -> scale_by_learning_rate`` in the JAX package: every
gradient value is clipped to [-c, c] first, then the L2 term ``wd * p``
is added to it before the moments (coupled, torch's ``optim.Adam``), and
the update is ``p -= lr * m_hat / (sqrt(v_hat) + eps)``; one group at
``base_lr`` holds every trained parameter. The frozen BERT parameters
are in no group under either recipe. A parameter without a gradient
gets the zero gradient here too, so under coupled L2 its decay enters
its moments.

``grad_accum`` = k is ``optax.MultiSteps``'s accumulation: the train step
(:func:`vlp3d_torch.train.state.make_train_step`) adds the gradients of
``loss / k`` over k micro-batches into ``.grad`` and calls :meth:`step`
on every k-th, so the clip, the moments, the weight decay and
``step_count`` (which the LR schedule reads) act once a k micro-batches,
on the mean gradient; BatchNorm statistics move on every micro-batch. A caller
passes ``steps_per_epoch`` already divided by k (the solver does).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

MODULE_LR_GROUPS = ("lang", "relation", "match", "caption")
# parameter-name prefixes the model freezes (lang_bert_module.py:84-95)
FROZEN_PREFIXES = ("lang.text_encoder.",)

OPTIMIZERS = ("adamw", "adam")


def label_params(model: nn.Module, single_group: bool = False) -> dict:
    """name -> 'frozen' | 'module' | 'base' for every parameter ('module'
    only without ``single_group``)."""
    labels = {}
    for name, _ in model.named_parameters():
        if name.startswith(FROZEN_PREFIXES):
            labels[name] = "frozen"
        elif not single_group and name.split(".")[0] in MODULE_LR_GROUPS:
            labels[name] = "module"
        else:
            labels[name] = "base"
    return labels


class Adam(torch.optim.Optimizer):
    """Adam over groups that carry ``base_lr``, with decoupled weight
    decay (AdamW, ``decoupled=True``) or coupled L2 (Adam), after an
    optional clip of the gradient values to [-clip_grad_value,
    clip_grad_value]; the group's ``lr`` of a step is
    ``lr_schedule(step // steps_per_epoch, base_lr)``, with ``step`` the
    count of updates already taken."""

    def __init__(self, groups, *, lr_schedule, steps_per_epoch: int,
                 weight_decay: float, amsgrad: bool, decoupled: bool = True,
                 clip_grad_value: float = 0.0, grad_accum: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        for g in groups:
            g["lr"] = g["base_lr"]
        super().__init__(groups, dict(weight_decay=weight_decay))
        self.lr_schedule = lr_schedule
        self.steps_per_epoch = steps_per_epoch
        self.amsgrad = amsgrad
        self.decoupled = decoupled
        self.clip_grad_value = clip_grad_value
        self.b1, self.b2, self.eps = b1, b2, eps
        self.step_count = 0
        # micro-batches whose gradients .grad holds since the last update
        self.grad_accum = max(int(grad_accum), 1)
        self.micro_step = 0

    def state_dict(self):
        """torch's state dict plus the step count and, mid-window, the
        micro-batch count and the gradients accumulated so far (what
        optax.MultiSteps keeps in its state)."""
        sd = super().state_dict()
        sd["step_count"] = self.step_count
        sd["micro_step"] = self.micro_step
        if self.micro_step:
            sd["accumulated"] = [
                None if p.grad is None else p.grad.detach().cpu()
                for g in self.param_groups for p in g["params"]]
        return sd

    def load_state_dict(self, state_dict):
        """Restore the moments, counts and accumulated gradients; the
        groups' learning rates and weight decay stay this optimizer's, as
        a restored optax state takes them from the code that built it."""
        state_dict = dict(state_dict)
        self.step_count = state_dict.pop("step_count", self.step_count)
        self.micro_step = state_dict.pop("micro_step", 0)
        accumulated = state_dict.pop("accumulated", None)
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in self.param_groups]
        super().load_state_dict(state_dict)
        for group, h in zip(self.param_groups, hyper):
            group.update(h)
        params = [p for g in self.param_groups for p in g["params"]]
        for p, g in zip(params, accumulated or [None] * len(params)):
            p.grad = None if g is None else g.to(p.device)

    def group_lr(self, group) -> float:
        if self.lr_schedule is None:
            return group["base_lr"]
        return float(self.lr_schedule(self.step_count // self.steps_per_epoch,
                                      group["base_lr"]))

    @torch.no_grad()
    def step(self, closure=None):
        count = self.step_count + 1
        for group in self.param_groups:
            lr = group["lr"] = self.group_lr(group)
            params = group["params"]
            if not params:
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            self.update(params, grads, [self.moments(p, p) for p in params],
                        lr, group["weight_decay"], count)
        self.step_count = count

    def moments(self, p, like: torch.Tensor) -> dict:
        """``p``'s state: mu, nu (and nu_max with amsgrad), zeros shaped
        like ``like`` at the first step (the parameter, or the slice of it
        that this rank updates)."""
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(like)
            st["nu"] = torch.zeros_like(like)
            if self.amsgrad:
                st["nu_max"] = torch.zeros_like(like)
        return st

    def update(self, params, grads, states, lr: float, weight_decay: float,
               count: int) -> None:
        """The elementwise update of update number ``count`` on tensors
        ``params`` (parameters or slices of them, updated in place) with
        ``grads`` and the moments ``states`` of the same shapes."""
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** count
        bc2 = 1.0 - b2 ** count
        if self.clip_grad_value > 0:
            grads = torch._foreach_clamp_min(grads, -self.clip_grad_value)
            torch._foreach_clamp_max_(grads, self.clip_grad_value)
        if not self.decoupled:  # coupled L2: into the moments
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        mus = [st["mu"] for st in states]
        nus = [st["nu"] for st in states]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        if self.amsgrad:
            nu_maxs = [st["nu_max"] for st in states]
            torch._foreach_maximum_(nu_maxs, nus)
            denom = torch._foreach_sqrt(nu_maxs)
            torch._foreach_div_(denom, bc2 ** 0.5)
        else:
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        if self.decoupled:
            torch._foreach_add_(upd, params, alpha=weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)


def make_optimizer(model: nn.Module, *, base_lr: float = 2e-3,
                   module_lr: float = 5e-4, weight_decay: float = 1e-3,
                   lr_schedule: Callable[[int, float], float] | None = None,
                   steps_per_epoch: int = 1, amsgrad: bool = False,
                   optim_name: str = "adamw", single_group: bool = False,
                   clip_grad_value: float = 0.0,
                   grad_accum: int = 1) -> Adam:
    """``lr_schedule`` maps (epoch, group_base_lr) -> the group's absolute
    LR: torch LR schedulers run per parameter group on the group's own
    base LR (CosineAnnealingLR anneals every group to the same eta_min).
    ``optim_name`` "adamw" (decoupled decay) or "adam" (coupled L2);
    ``single_group``: one group at ``base_lr`` instead of the base /
    module split; ``clip_grad_value`` > 0 clips the gradient values
    first."""
    if optim_name not in OPTIMIZERS:
        raise ValueError(f"optim_name {optim_name!r} is not one of "
                         f"{OPTIMIZERS}")
    labels = label_params(model, single_group)
    by_label = {"base": [], "module": []}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        elif p.requires_grad:
            by_label[labels[name]].append(p)
    groups = [dict(params=by_label["base"], base_lr=base_lr, name="base")]
    if not single_group:
        groups.append(dict(params=by_label["module"], base_lr=module_lr,
                           name="module"))
    return Adam(groups, lr_schedule=lr_schedule,
                steps_per_epoch=steps_per_epoch, weight_decay=weight_decay,
                amsgrad=amsgrad, decoupled=optim_name == "adamw",
                clip_grad_value=clip_grad_value or 0.0,
                grad_accum=grad_accum)
