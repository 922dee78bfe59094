"""Multi-process rendezvous, the rank helpers and the collectives the
trainer needs between steps.

Counterpart of ``vlp3d/parallel/distributed.py`` over
``torch.distributed``: one process a card (``torchrun`` or ``srun``
starts them), each holding a replica of the model and its rows of every
global batch. Rendezvous resolution order is the JAX package's (and the
reference's ``utils/dist.py:6-46``):

  1. explicit arguments;
  2. env:// -- ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
     ``MASTER_PORT`` (what ``python -m torch.distributed.run`` sets);
  3. SLURM -- ``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_NODELIST``,
     the first hostname as the rendezvous host;
  4. otherwise one process, no process group.

:func:`dist_init` initialises the default process group: NCCL when the
entry point runs on the card, gloo under ``--device cpu``. Each rank
takes ``cuda:LOCAL_RANK`` (``SLURM_LOCALID`` under srun). A rendezvous of
one process returns ``distributed=False``, as JAX's does, but still
initialises its group of one, so that a one-process launch through
``torchrun`` takes the same data-parallel path as a larger one.

What the port needs of JAX's placement helpers:

  * ``global_mesh`` -> the default process group itself (a rank is a
    device of the data axis), or the (data, model) subgroups of
    :func:`vlp3d_torch.parallel.tensor_parallel.make_grid`;
  * ``replicate_global`` / ``place_global`` -> :func:`broadcast_module`,
    rank 0's parameters and buffers copied to every rank, then split by
    ``shard_model`` (tensor parallel) and ``ShardedAdam`` (ZeRO-1,
    :mod:`vlp3d_torch.parallel.zero`);
  * ``host_global`` -> the state dicts of the split layers and of
    ``ShardedAdam``, which gather the whole tensors; :func:`check_replicated`
    confirms that the ranks' whole modules agree;
  * ``shard_host_batch`` -> :func:`shard_host_batch`, a rank's rows of a
    host batch on its device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess

import numpy as np
import torch

_DEFAULT_PORT = "29500"  # the reference's default, dist.py:21
# a collective waits this long for a late rank: a checkpoint write on
# rank 0 or a slow first step must not kill the others
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The resolved topology (the fields the reference's dist_init writes
    onto ``args``, dist.py:8-31)."""

    distributed: bool
    rank: int = 0
    world_size: int = 1
    coordinator: str | None = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _slurm_first_host(node_list: str) -> str:
    """First hostname of a SLURM node list (``scontrol show hostname``,
    else the common ``prefix[a-b,...]`` form parsed by hand)."""
    try:
        out = subprocess.run(
            ["scontrol", "show", "hostname", node_list],
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    if "[" in node_list:
        prefix, rest = node_list.split("[", 1)
        first = rest.split("]", 1)[0].split(",")[0].split("-")[0]
        return prefix + first
    return node_list.split(",", 1)[0]


def dist_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> DistContext:
    """Initialise the default process group from explicit arguments,
    env:// or SLURM; without rendezvous information a no-op returning
    ``DistContext(distributed=False)`` (dist.py:33-36).

    ``device``: the entry point's ``--device``. A CPU device takes gloo;
    anything else NCCL on ``cuda:LOCAL_RANK``, which becomes the current
    CUDA device, and NCCL must initialise: there is no fallback to gloo
    on the card."""
    init_method = None
    if coordinator_address is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            process_id = int(os.environ["RANK"])
            num_processes = int(os.environ["WORLD_SIZE"])
            addr = os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
            port = os.environ.setdefault("MASTER_PORT", _DEFAULT_PORT)
            coordinator_address = f"{addr}:{port}"
            # env:// joins torchrun's own store where torchrun made one
            init_method = "env://"
        elif "SLURM_PROCID" in os.environ:
            process_id = int(os.environ["SLURM_PROCID"])
            num_processes = int(os.environ["SLURM_NTASKS"])
            addr = _slurm_first_host(os.environ["SLURM_NODELIST"])
            port = os.environ.get("MASTER_PORT", _DEFAULT_PORT)
            os.environ["MASTER_PORT"] = port  # dist.py:22
            coordinator_address = f"{addr}:{port}"
        else:
            return DistContext(distributed=False)
    if num_processes is None or process_id is None:
        raise ValueError(
            "explicit coordinator_address requires num_processes and "
            "process_id")
    import torch.distributed as dist

    if torch.device(device or "cuda").type == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "data parallel on the card needs CUDA; pass --device cpu "
                "for gloo ranks on the CPU")
        local = int(os.environ.get(
            "LOCAL_RANK", os.environ.get(
                "SLURM_LOCALID", process_id % torch.cuda.device_count())))
        torch.cuda.set_device(local)
        backend = "nccl"
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{coordinator_address}",
        rank=process_id, world_size=num_processes, timeout=TIMEOUT)
    return DistContext(
        distributed=num_processes > 1,
        rank=process_id,
        world_size=num_processes,
        coordinator=coordinator_address,
    )


def dist_close() -> None:
    """Destroy the default process group, where there is one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def backend() -> str | None:
    """The default group's backend ("nccl" or "gloo"), None without one."""
    import torch.distributed as dist

    return dist.get_backend() if initialized() else None


def get_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if initialized() else 0


def get_world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    """Gate for checkpoint and log writes (the reference's rank-0
    pattern)."""
    return get_rank() == 0


def _comm_device() -> torch.device:
    """Where the default group's collectives take their tensors."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Block until every process reaches this point (dist.py:46); a
    no-op in one process. Waits up to :data:`TIMEOUT` for a late rank."""
    import torch.distributed as dist

    if initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_processes_agree(flag: bool) -> bool:
    """Collective AND of a per-process bit (one process: the bit).

    The solver's interrupt path uses it: SIGTERM lands at different
    instants on different ranks, and a rank that left the step loop alone
    would leave the others waiting in their next collective, so whether
    to stop (and save) is decided by all of them at once."""
    if not initialized():
        return bool(flag)
    import torch.distributed as dist

    bit = torch.tensor([int(bool(flag))], device=_comm_device())
    dist.all_reduce(bit, op=dist.ReduceOp.MIN)
    return bool(bit.item())


def shard_host_batch(batch: dict, device, *, local: bool = False,
                     shard=None) -> dict:
    """A host batch -> this rank's rows as tensors on ``device``.

    ``local``: the batch is already this rank's rows (the train feed's
    ``item_slice`` loader builds only those). Otherwise it is the global
    batch, the same on every rank (the eval feed), and each array whose
    leading dimension is the batch's keeps rows [r * B / W, (r + 1) * B /
    W); scalars go as they are. Lists (scene ids, object names) stay on
    the host. ``shard`` (a :class:`~vlp3d_torch.parallel.reduce.BatchShard`)
    gives the rank and W in place of the default group's: the data group
    of a tensor-parallel grid."""
    arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
    if not local:
        bs = np.shape(arrays["point_clouds"])[0]
        rank, world = ((get_rank(), get_world_size()) if shard is None
                       else (shard.rank, shard.world))
        if bs % world:
            raise ValueError(
                f"global batch {bs} not divisible by {world} processes")
        n = bs // world
        lo = rank * n
        arrays = {
            k: (v[lo:lo + n] if np.ndim(v) >= 1 and np.shape(v)[0] == bs
                else v)
            for k, v in arrays.items()
        }
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in arrays.items()}


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers into every rank's module
    (``replicate_global``'s guarantee: every rank starts from one
    state)."""
    if not initialized():
        return
    import torch.distributed as dist

    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


@torch.no_grad()
def check_replicated(module: torch.nn.Module) -> list:
    """Names of the parameters and buffers whose values differ between
    ranks (empty when every rank holds the same state; always empty in
    one process). Every rank gets the same list."""
    if not initialized():
        return []
    import torch.distributed as dist

    names, tensors = [], []
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        names.append(name)
        tensors.append(t.detach().reshape(-1).double())
    flat = torch.cat(tensors)
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    differs = (hi != lo).cpu()
    out, offset = [], 0
    for name, t in zip(names, tensors):
        if bool(differs[offset:offset + t.numel()].any()):
            out.append(name)
        offset += t.numel()
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank; ``obj`` in one
    process."""
    if not initialized():
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


def check_same_hash_seed() -> None:
    """Raise unless every rank hashes a string alike.

    The hash tokenizer, both packages' fallback without a ``--bert_vocab``,
    maps a word to Python's ``hash()``, which each process seeds on its own
    unless ``PYTHONHASHSEED`` fixes it; the ranks would then give one word
    different ids in their rows of a batch (ROADMAP.md C12)."""
    probe = hash("vlp3d_torch")
    if not all_processes_agree(broadcast_object(probe) == probe):
        raise RuntimeError(
            "the ranks hash strings differently, so the hash tokenizer "
            "would give a word another id on each rank: give every rank "
            "one PYTHONHASHSEED (e.g. PYTHONHASHSEED=0 torchrun ...), or "
            "pass --bert_vocab")


def sync_python_random() -> None:
    """Give every rank rank 0's state of Python's ``random``.

    The datasets' ``shuffle_data`` orders sentences with Python's
    ``random`` (the reference's), and each rank builds its rows of one
    global order; a fresh process seeds ``random`` from the OS, so
    without this the ranks would shuffle differently and their rows would
    not make one batch."""
    import random

    random.setstate(broadcast_object(random.getstate()))
