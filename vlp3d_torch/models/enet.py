"""The ENet 2D encoder of multiview feature extraction.

Counterpart of ``ENetEncoder`` in ``vlp3d/models/enet.py`` (the
reference's torch7-converted ``lib/visual_grounding/enet.py:130-717``, the
network behind ``enet_feats_maxpool.hdf5``), with its quirks:

  * per-channel PReLU everywhere;
  * ``RefDropout``, the reference's Dropout2d that multiplies by (1 - p)
    before the dropout: at evaluation the activations are scaled by
    (1 - p), in training a kept value keeps its magnitude;
  * BatchNorm with eps 1e-3, always on its running statistics (the JAX
    module's ``use_running_average=True``);
  * asymmetric bottlenecks: a bias-free (1, 5) conv, then a (5, 1) conv
    with a bias, one BN + PReLU after the pair;
  * downsampling bottlenecks: a bias-free 2x2 stride-2 conv; the main
    branch max-pools and appends zero channels at the end;
  * the 3x3 convs carry a bias, the 1x1 ones do not;
  * the plan: the initial block (conv 3 -> 13 beside a 2x2 max-pool, 16
    channels), a downsampling bottleneck to 64 and 4 regular ones, a
    downsampling one to 128 and [regular, dilated 2, asym, dilated 4,
    regular, dilated 8, asym, dilated 16] twice: 22 bottlenecks, then
    with ``num_classes`` the bias-free 1x1 classifier.

Frames are channels-last (B, H, W, 3) in and (B, H / 8, W / 8, 128) out,
as in the JAX module; inside, the convolutions run on (B, C, H, W) with
``torch.nn.functional.conv2d`` (on the card cuDNN's, in float32 when
``torch.backends.cudnn.allow_tf32`` is off, as the compute_multiview CLI
sets it). Submodule names follow the JAX module's (``initial``,
``blocks.{i}`` for ``block{i}``, ``classifier``);
:func:`load_enet_reference_state_dict` reads the reference's
``create_enet`` state dict and :func:`vlp3d_torch.convert.enet_to_torch_state_dict`
the JAX tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import Dropout, PReLU

# (kind, dilation) of the 8 bottlenecks of each of stages 2 and 3
_STAGE_PLAN = (
    ("regular", 1), ("dilated", 2), ("asym", 1), ("dilated", 4),
    ("regular", 1), ("dilated", 8), ("asym", 1), ("dilated", 16),
)


def enet_block_specs() -> list[dict]:
    """The 22 bottlenecks in execution order."""
    specs = [dict(out_ch=64, inter_ch=16, kind="down", dilation=1,
                  pdrop=0.01)]
    specs += [dict(out_ch=64, inter_ch=16, kind="regular", dilation=1,
                   pdrop=0.01) for _ in range(4)]
    specs += [dict(out_ch=128, inter_ch=32, kind="down", dilation=1,
                   pdrop=0.1)]
    for _ in range(2):
        specs += [dict(out_ch=128, inter_ch=32, kind=k, dilation=d,
                       pdrop=0.1) for k, d in _STAGE_PLAN]
    return specs


class PReLU2d(PReLU):
    """Per-channel PReLU over dim 1 of (B, C, H, W)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight[:, None, None] * x)


class EvalBatchNorm2d(nn.Module):
    """BatchNorm on its running statistics, eps 1e-3, over dim 1, in
    flax's order: (x - mean) * (rsqrt(var + eps) * weight) + bias."""

    eps = 1e-3

    def __init__(self, c: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class RefDropout(nn.Module):
    """x * (1 - p), then in training flax's inverted dropout."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.drop = Dropout(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(x * (1.0 - self.p))


def _conv(cin, cout, kernel, device, *, stride=1, padding=0, dilation=1,
          bias=True):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                     dilation=dilation, bias=bias, device=device)


class InitialBlock(nn.Module):
    """concat[conv 3x3 s2 p1 (3 -> 13), max-pool 2x2] -> BN -> PReLU."""

    def __init__(self, device):
        super().__init__()
        self.conv = _conv(3, 13, 3, device, stride=2, padding=1)
        self.bn = EvalBatchNorm2d(16, device)
        self.prelu = PReLU2d(16, device=device)

    def forward(self, x):
        y = torch.cat([self.conv(x), F.max_pool2d(x, 2, 2)], dim=1)
        return self.prelu(self.bn(y))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, inter_ch: int,
                 kind: str = "regular", dilation: int = 1, pdrop: float = 0.1,
                 *, device=None):
        super().__init__()
        self.out_ch, self.kind = out_ch, kind
        if kind == "down":
            self.conv0 = _conv(in_ch, inter_ch, 2, device, stride=2,
                               bias=False)
        else:
            self.conv0 = _conv(in_ch, inter_ch, 1, device, bias=False)
        self.bn0 = EvalBatchNorm2d(inter_ch, device)
        self.prelu0 = PReLU2d(inter_ch, device=device)
        if kind == "asym":
            self.conv1a = _conv(inter_ch, inter_ch, (1, 5), device,
                                padding=(0, 2), bias=False)
            self.conv1b = _conv(inter_ch, inter_ch, (5, 1), device,
                                padding=(2, 0))
        else:
            self.conv1 = _conv(inter_ch, inter_ch, 3, device,
                               padding=dilation, dilation=dilation)
        self.bn1 = EvalBatchNorm2d(inter_ch, device)
        self.prelu1 = PReLU2d(inter_ch, device=device)
        self.conv2 = _conv(inter_ch, out_ch, 1, device, bias=False)
        self.bn2 = EvalBatchNorm2d(out_ch, device)
        self.drop = RefDropout(pdrop)
        self.prelu_out = PReLU2d(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        main = F.max_pool2d(x, 2, 2) if self.kind == "down" else x
        if main.shape[1] != self.out_ch:  # zero channels at the end
            main = F.pad(main, (0, 0, 0, 0, 0, self.out_ch - main.shape[1]))
        y = self.prelu0(self.bn0(self.conv0(x)))
        if self.kind == "asym":
            y = self.conv1b(self.conv1a(y))
        else:
            y = self.conv1(y)
        y = self.prelu1(self.bn1(y))
        y = self.drop(self.bn2(self.conv2(y)))
        return self.prelu_out(y + main)


class ENetEncoder(nn.Module):
    """(B, H, W, 3) frames -> (B, H / 8, W / 8, 128) feature maps, or
    with ``num_classes`` the classifier's logits. Starts in evaluation
    mode (the BatchNorms read their running statistics in either
    mode; training draws RefDropout's masks)."""

    def __init__(self, num_classes: int | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.initial = InitialBlock(device)
        self.blocks = nn.ModuleList()
        cin = 16
        for spec in enet_block_specs():
            self.blocks.append(Bottleneck(cin, **spec, device=device))
            cin = spec["out_ch"]
        self.classifier = (_conv(128, num_classes, 1, device, bias=False)
                           if num_classes is not None else None)
        self.eval()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        y = self.initial(frames.permute(0, 3, 1, 2))
        for block in self.blocks:
            y = block(y)
        if self.classifier is not None:
            y = self.classifier(y)
        return y.permute(0, 2, 3, 1)


def load_enet_reference_state_dict(state_dict,
                                   num_classes: int | None = None) -> dict:
    """The reference's ``create_enet`` state dict -> :class:`ENetEncoder`'s.

    By position, as ``convert_enet_state_dict`` in the JAX package reads
    it: the torch Sequential registers its tensors in execution order,
    which is the order :func:`enet_block_specs` walks (the initial conv,
    BN and PReLU, then each bottleneck's conv0, bn0, prelu0, conv1 or
    conv1a + conv1b, bn1, prelu1, conv2, bn2, prelu_out; a BN is weight,
    bias, running mean and variance, and num_batches_tracked where the
    dump has it). With ``num_classes`` the trailing classifier conv is
    read too. Accepts tensors or numpy arrays; returns CPU tensors."""
    items = [(k, torch.as_tensor(v)) for k, v in state_dict.items()]
    pos = 0
    out: dict = {}

    def take():
        nonlocal pos
        pos += 1
        return items[pos - 1][1]

    def conv(name, bias=True):
        out[f"{name}.weight"] = take()
        if bias:
            out[f"{name}.bias"] = take()

    def bn(name):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = take()
        tracked = torch.zeros((), dtype=torch.long)
        if pos < len(items) and items[pos][0].endswith("num_batches_tracked"):
            tracked = take()
        out[f"{name}.num_batches_tracked"] = tracked

    def prelu(name):
        out[f"{name}.weight"] = take().reshape(-1)

    conv("initial.conv")
    bn("initial.bn")
    prelu("initial.prelu")
    for i, spec in enumerate(enet_block_specs()):
        b = f"blocks.{i}"
        conv(f"{b}.conv0", bias=False)
        bn(f"{b}.bn0")
        prelu(f"{b}.prelu0")
        if spec["kind"] == "asym":
            conv(f"{b}.conv1a", bias=False)
            conv(f"{b}.conv1b")
        else:
            conv(f"{b}.conv1")
        bn(f"{b}.bn1")
        prelu(f"{b}.prelu1")
        conv(f"{b}.conv2", bias=False)
        bn(f"{b}.bn2")
        prelu(f"{b}.prelu_out")
    if num_classes is not None:
        conv("classifier", bias=False)
    return {k: v.float() if v.is_floating_point() else v
            for k, v in out.items()}
