"""Device-memory observability.

Counterpart of ``vlp3d/utils/memory.py``: the per-device high-water
mark decides whether a configuration fits, so the solver logs it each
epoch and the HTTP server's ``/stats`` reports it. The same three keys
as the JAX function, read from PyTorch's caching allocator
(``memory_allocated`` / ``max_memory_allocated``) and the device's
total memory (``mem_get_info``). A CPU device reports no memory statistics,
so it gives ``{}``, as the JAX function does on a backend without them.
"""

from __future__ import annotations

import torch


def device_memory_mb(device=None) -> dict:
    """{'hbm_in_use_mb', 'hbm_peak_mb', 'hbm_limit_mb'} for one CUDA
    device (default: the current one), or {} for a CPU device or on a
    host without CUDA."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    _, total = torch.cuda.mem_get_info(device)
    return {
        "hbm_in_use_mb": round(torch.cuda.memory_allocated(device) / 1e6, 2),
        "hbm_peak_mb": round(torch.cuda.max_memory_allocated(device) / 1e6,
                             2),
        "hbm_limit_mb": round(total / 1e6, 2),
    }
