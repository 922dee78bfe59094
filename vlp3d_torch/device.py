"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A
default-device construction on a host without CUDA raises; it never
drops to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """None -> the current CUDA device, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vlp3d_torch runs on a CUDA device by default and this host "
                "has none; pass device='cpu' to run the plain PyTorch ops"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device
