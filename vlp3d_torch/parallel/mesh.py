"""Device lists for data parallel within one process (the serving
predictors) and the row split of a batch over them.

Counterpart of ``vlp3d/parallel/mesh.py``. A JAX mesh is an array of
devices with a named data axis, over which GSPMD shards a batch's
leading axis; here a mesh is the ordered list of devices, a batch splits
into contiguous row blocks, one a device, and the caller runs a replica
on each. Training across cards is one process a card
(:mod:`vlp3d_torch.parallel.distributed`), as PyTorch runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from vlp3d_torch.device import resolve_device


def local_devices(kind: str = "cuda") -> list:
    """Every local device of ``kind``: each CUDA card, or the one CPU."""
    if torch.device(kind).type == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")  # raises without CUDA
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, kind: str = "cuda") -> list:
    """The first ``n_devices`` local devices of ``kind`` in order; every
    one for None or 0."""
    devices = local_devices(kind)
    return devices[:n_devices] if n_devices else devices


def make_mesh_for_batch(batch_size: int, kind: str = "cuda") -> list:
    """The mesh over the largest local device count that divides
    ``batch_size``."""
    n = len(local_devices(kind))
    while n > 1 and batch_size % n != 0:
        n -= 1
    return make_mesh(n, kind)


def shard_batch(mesh: list, batch: dict) -> list:
    """A host batch -> one dict a device of ``mesh``, device i holding
    rows [i * B / n, (i + 1) * B / n) of every array whose leading
    dimension is the batch's, on that device; other arrays and scalars go
    to every device whole. B must divide by the device count."""
    bs = np.shape(batch["point_clouds"])[0]
    n = len(mesh)
    if bs % n:
        raise ValueError(f"batch {bs} not divisible by the {n}-device mesh")
    k = bs // n
    out = []
    for i, device in enumerate(mesh):
        out.append({
            key: torch.as_tensor(np.asarray(
                v[i * k:(i + 1) * k]
                if np.ndim(v) >= 1 and np.shape(v)[0] == bs else v)
            ).to(device)
            for key, v in batch.items() if not isinstance(v, list)
        })
    return out
