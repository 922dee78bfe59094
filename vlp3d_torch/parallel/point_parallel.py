"""Point-axis (sequence) parallel: the raw-point stage sharded over ranks.

Counterpart of ``vlp3d/parallel/point_parallel.py``. Rank ``i`` of a
point group of W ranks owns the contiguous global slab ``[i * Nl, (i +
1) * Nl)`` of the point axis (Nl = N / W); the group is the second axis
of a :func:`~vlp3d_torch.parallel.tensor_parallel.make_grid` grid, whose
first axis shards the batch (JAX's ``(data, point)`` mesh). Because rank
order is global index order, every "first in scan order" rule of the
dense ops merges exactly across the slabs, and the outputs equal the
dense ops' on the whole cloud bit for bit:

  * :func:`fps_sharded`: start at global index 0, skip points with
    ``|p|^2 <= 1e-3``, take the largest running distance, the lowest
    global index on ties, index 0 everywhere for an all-invalid row. On
    the card one of two routes, chosen once a group and batch size
    before any launch (:func:`fps_route`, ROADMAP C22): the peer route,
    one launch of the ``fps_shard_loop`` kernel (``csrc/point_parallel.cu``)
    a call, which runs every iteration and exchanges each rank's
    candidate through peer memory (a group of one through its own
    buffer), the group's exchange buffers shared once by CUDA IPC, for a
    group whose ranks are on one host and whose cards all reach each
    other (:func:`check_peer_group`); else the collective route, one
    launch of the ``fps_shard_step`` kernel an iteration, each after an
    all-gather of the ranks' candidates over NCCL (JAX runs a ``pmax``,
    a ``pmin`` and a ``psum`` an iteration, over any mesh). Either route
    can be forced (``route=``); a failure raises, nothing retries on
    the other. A slab of any length: a share of the loop kernel too
    long for registers streams from global memory. On the CPU,
    :func:`fps_sharded_plain` runs the collective route's loop with the
    plain step over gloo;
  * :func:`ball_query_sharded`: ``ball_query.cu``'s count variant on the
    slab (the first ``nsample`` in-ball local indices and the count), an
    all-gather of both, and :func:`ball_query_merge` (the
    ``ball_query_merge`` kernel): strict ``d^2 < r^2`` with the
    ``(dx^2 + dy^2) + dz^2`` order, padding with the first hit, all zeros
    for an empty ball;
  * :func:`gather_points_sharded` / :func:`group_points_sharded`: the rows
    this rank owns (:func:`gather_owned`, the ``gather_owned`` kernel;
    zeros elsewhere) summed over the group. Every rank then holds every
    row and computes the same loss, so the backward passes each rank the
    output gradient unsummed and scatters it into the rows it owns
    (``grouping.cu``'s backward, which drops indices outside [0, Nl)).

The front end (:func:`large_scene_front`) and
:func:`apply_backbone_large_scene` put them together as SA1's FPS,
centre gather and grouped neighbourhoods, the only stage that touches the
raw N-point cloud: only O(npoint x nsample) rows ever sit on one rank.
A CUDA tensor takes the kernels and NCCL, a CPU tensor the plain versions
beside them and gloo; without a process group (a group of one) the
collectives are the identity.
"""

from __future__ import annotations

import ctypes
import socket

import torch

from vlp3d_torch.ops import _kernels
from vlp3d_torch.ops.ball_query import ball_query_with_count
from vlp3d_torch.ops.grouping import (
    _group_points_grad_cuda,
    group_points_grad_plain,
)
from vlp3d_torch.ops.sampling import _CLUSTER, _REGS_THREADS, _fps_plan
from vlp3d_torch.parallel.tensor_parallel import ModelGroup

LOCAL_POINTS = ModelGroup()
"""A point group of one rank and no process group: the collectives are the
identity."""

_MIN_SQ_NORM = 1e-3  # sampling_gpu.cu:105-106
_INF = 1e10
_EMPTY = -3.0  # a rank offering nothing: below any real candidate (-1)
_NO_INDEX = 2 ** 31 - 1
FPS_SPIN_TIMEOUT_S = 10.0
"""Seconds an FPS loop waits for a rank's candidate before it traps. A
call of several ranks starts behind a collective on its stream, so the
wait counts from the moment every rank has reached the call: only a fault
of the exchange (a rank whose launch failed) outlasts it, and that then
fails the run instead of hanging it."""
LOOP_MAX_RANKS = 32  # a point group the loop kernel takes: one warp
ROUTES = ("peer", "collective")


# ------------------------------------------------------------ collectives


def _gather(x: torch.Tensor, point: ModelGroup) -> torch.Tensor:
    """The group's ``x`` stacked in rank order along a new first axis
    (``x`` itself with one axis more without a process group)."""
    x = x.contiguous()
    if point.group is None:
        return x[None]
    import torch.distributed as dist

    out = torch.empty((point.world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=point.group)
    return out.view((point.world,) + tuple(x.shape))


def _sum(x: torch.Tensor, point: ModelGroup) -> torch.Tensor:
    if point.group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, group=point.group)
    return x


# ------------------------------------------------------------------ FPS


def _seed(xyz: torch.Tensor, rank: int) -> torch.Tensor:
    """Each rank's candidate before the first iteration (1, B, 5): rank 0
    offers global point 0, which every rank then picks; the others offer
    nothing."""
    b = xyz.shape[0]
    cand = torch.zeros((1, b, 5), dtype=torch.int32, device=xyz.device)
    as_float = cand.view(torch.float32)
    if rank == 0:
        as_float[0, :, 0] = _INF
        as_float[0, :, 2:5] = xyz[:, 0, :]
    else:
        as_float[0, :, 0] = _EMPTY
        cand[0, :, 1] = _NO_INDEX
    return cand


def fps_shard_step_plain(xyz, temp, cands, offset: int, t: int, last: bool,
                         out_idx):
    """One FPS iteration on a slab in plain PyTorch, in the loop kernel's
    layout: ``cands`` (W, B, 5) int32, one candidate a rank a row
    (distance bits, global index, x, y, z bits) of the previous
    iteration. Writes the winner (largest distance, then lowest global
    index) into ``out_idx[:, t]`` and, unless ``last``, min-updates
    ``temp`` (B, Nl) in place and returns this rank's candidate (1, B,
    5): its largest running distance (-1 where the point is invalid),
    lowest local index first, plus ``offset``."""
    b = xyz.shape[0]
    rows = torch.arange(b, device=xyz.device)
    vals = cands.view(torch.float32)[..., 0]
    idx = cands[..., 1]
    top = vals.max(0).values
    at = vals == top
    win = torch.where(at, idx, _NO_INDEX).min(0).values
    src = (at & (idx == win)).int().argmax(0)
    p = cands.view(torch.float32)[src, rows, 2:5]
    out_idx[:, t] = win
    if last:
        return None
    x, y, z = xyz.unbind(-1)
    dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
    torch.minimum(temp, (dx * dx + dy * dy) + dz * dz, out=temp)
    cand = torch.where((x * x + y * y) + z * z > _MIN_SQ_NORM, temp,
                       torch.tensor(-1.0, device=xyz.device))
    best = cand.max(1).values
    local = (cand == best[:, None]).int().argmax(1)  # the first maximum
    out = torch.empty((1, b, 5), dtype=torch.int32, device=xyz.device)
    out.view(torch.float32)[0, :, 0] = best
    out[0, :, 1] = local + offset
    out.view(torch.float32)[0, :, 2:5] = xyz[rows, local]
    return out


def fps_shard_step(xyz, temp, cands, offset: int, t: int, last: bool,
                   out_idx):
    """:func:`fps_shard_step_plain` for the collective route: one launch
    of the ``fps_shard_step`` kernel on CUDA tensors (xyz, temp, cands
    and out_idx contiguous, as :func:`_fps_collective` makes them), the
    plain step on CPU ones."""
    if not _kernels.cuda_or_cpu(xyz):
        return fps_shard_step_plain(xyz, temp, cands, offset, t, last,
                                    out_idx)
    _kernels.require(xyz, "xyz", torch.float32, 3, 3)
    _kernels.require(temp, "temp", torch.float32, 2)
    _kernels.require(cands, "cands", torch.int32, 3, 5)
    _kernels.require(out_idx, "out_idx", torch.int32, 2)
    b, nl, _ = xyz.shape
    if temp.shape != (b, nl) or cands.shape[1] != b \
            or out_idx.shape[0] != b or not 0 <= t < out_idx.shape[1]:
        raise ValueError("fps_shard_step: xyz, temp, cands and out_idx "
                         "disagree")
    cand = None if last else torch.empty((1, b, 5), dtype=torch.int32,
                                         device=xyz.device)
    with _kernels.on_device(xyz):
        rc = _kernels.function("point_parallel", "vlp3d_fps_shard_step")(
            xyz.data_ptr(), temp.data_ptr(), cands.data_ptr(),
            cands.shape[0], b, nl, offset, t, int(last), out_idx.shape[1],
            out_idx.data_ptr(), None if cand is None else cand.data_ptr(),
            _kernels.stream_ptr(xyz))
        if rc != 0:
            _kernels.check(rc, "fps shard step kernel")
    _kernels.launches["fps_shard_step"] += 1
    return cand


def _fps_collective(xyz: torch.Tensor, npoint: int, point: ModelGroup,
                    step) -> torch.Tensor:
    """The collective route's loop: npoint iterations of ``step``
    (:func:`fps_shard_step_plain` or :func:`fps_shard_step`), each after
    an all-gather of the ranks' candidates."""
    b, nl, _ = xyz.shape
    out = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0 or npoint == 0:
        return out
    temp = torch.full((b, nl), _INF, dtype=torch.float32, device=xyz.device)
    cand = _seed(xyz, point.rank)
    for t in range(npoint):
        cand = step(xyz, temp, _gather(cand, point).view(-1, b, 5),
                    point.rank * nl, t, t == npoint - 1, out)
    return out


def fps_sharded_plain(xyz: torch.Tensor, npoint: int,
                      point: ModelGroup = LOCAL_POINTS) -> torch.Tensor:
    """Plain :func:`fps_sharded`: npoint iterations of
    :func:`fps_shard_step_plain`, each after an all-gather of the ranks'
    candidates (on a CUDA tensor it runs as it does on the CPU: the
    kernels' yardstick)."""
    with torch.no_grad():
        return _fps_collective(xyz.float().contiguous(), npoint, point,
                               fps_shard_step_plain)


def loop_plan(nl: int, cluster: int | None = None) -> tuple[int, int]:
    """(blocks a cluster, points a thread) of the FPS loop kernel for
    slabs of ``nl`` points: the dense FPS's plan for a row of that length
    (at least two blocks: the loop kernel always runs a cluster), or
    ``cluster`` blocks. 0 points a thread: a block's share is too long for
    registers, and the block streams it from global memory, its running
    distances in a scratch."""
    if cluster is None:
        plan = _fps_plan(nl)
        cluster = max(2, plan[0]) if plan else _CLUSTER
    share = -(-nl // cluster)
    for points, most in _REGS_THREADS.items():
        if -(-share // points) <= min(most, 512):
            return cluster, points
    return cluster, 0


_MAX_CLUSTERS: dict = {}


def loop_max_clusters(cluster: int, nl: int, points: int) -> int:
    """Clusters of the loop kernel the current card runs at once (every
    cluster of a launch must be resident: a cluster waiting on a peer
    holds its SMs); asked once a configuration and card."""
    key = (torch.cuda.current_device(), cluster, nl, points)
    if key not in _MAX_CLUSTERS:
        _MAX_CLUSTERS[key] = _kernels.function(
            "point_parallel", "vlp3d_fps_shard_loop_max_clusters")(
                cluster, nl, points)
    return _MAX_CLUSTERS[key]


def exchange_words(b: int, w: int) -> int:
    """int64 words of one rank's exchange buffer: two slots of (B, W)
    candidates, each five (lane, flag) pairs padded to 48 bytes."""
    return 12 * b * w


def _launch_loop(xyz, npoint: int, out, *, nl: int, w: int, rank0: int,
                 ranks_here: int, nc: int, cluster: int, points: int,
                 peers, seq: int, timeout_s: float = FPS_SPIN_TIMEOUT_S):
    """One launch of the loop kernel (see ``vlp3d_fps_shard_loop``); the
    streamed form (``points`` 0) gets a scratch for its distances."""
    temp = None if points else torch.empty(
        (ranks_here, xyz.shape[0], nl), dtype=torch.float32,
        device=xyz.device)
    with _kernels.on_device(xyz):
        rc = _kernels.function("point_parallel", "vlp3d_fps_shard_loop")(
            xyz.data_ptr(), xyz.shape[0], xyz.shape[1], nl, npoint, w, rank0,
            ranks_here, nc, cluster, points, peers.data_ptr(), seq,
            timeout_s, None if temp is None else temp.data_ptr(),
            out.data_ptr(), _kernels.stream_ptr(xyz))
        if rc != 0:
            _kernels.check(rc, "fps shard loop kernel")
    _kernels.launches["fps_shard_loop"] += 1


# ---- the exchange buffers of a point group, shared once by CUDA IPC

_EXCHANGES: dict = {}
_OPENED: dict = {}  # IPC handle -> its base, opened in this process


def _gather_objects(obj, point: ModelGroup) -> list:
    import torch.distributed as dist

    out = [None] * point.world
    dist.all_gather_object(out, obj, group=point.group)
    return out


def _bus_id(device: int) -> str:
    """The PCI bus id of this process's card ``device``: the name of a card
    that every process of a host shares, however each numbers its cards
    (``CUDA_VISIBLE_DEVICES``)."""
    buf = ctypes.create_string_buffer(32)
    _kernels.check(_kernels.function("point_parallel", "vlp3d_pci_bus_id")(
        device, buf, len(buf)), "reading a card's PCI bus id")
    return buf.value.decode()


def peer_info(device: torch.device) -> dict:
    """This rank's host and card (ordinal here, and PCI bus id), and which
    cards this process sees, by bus id, the card reaches as a peer
    (``cudaDeviceCanAccessPeer``)."""
    me = device.index
    return {"host": socket.gethostname(), "device": me, "card": _bus_id(me),
            "reach": {_bus_id(d): d == me or
                      torch.cuda.can_device_access_peer(me, d)
                      for d in range(torch.cuda.device_count())}}


def check_peer_group(infos: list) -> str | None:
    """Why a point group (``infos``: :func:`peer_info` of each rank, in
    rank order) cannot take the peer route, naming its first two ranks
    that are on different hosts, or of which one cannot see the other's
    card (so that peer access cannot be checked) or cannot reach it; None
    when every pair reaches the other."""
    for a, ia in enumerate(infos):
        for b, ib in enumerate(infos):
            if ia["host"] != ib["host"]:
                return (f"rank {a} is on {ia['host']!r}, rank {b} on "
                        f"{ib['host']!r}")
            if ib["card"] not in ia["reach"]:
                return (f"rank {a} (cuda:{ia['device']}, {ia['card']}) does "
                        f"not see rank {b}'s card ({ib['card']}), so peer "
                        f"access between them cannot be checked "
                        f"(CUDA_VISIBLE_DEVICES)")
            if not ia["reach"][ib["card"]]:
                return (f"rank {a} (cuda:{ia['device']}, {ia['card']}) "
                        f"cannot access rank {b}'s card ({ib['card']}) as a "
                        f"peer")
    return None


def fps_route(point: ModelGroup, device: torch.device) -> tuple[str, str]:
    """(route, why) of ``point``'s FPS: "peer" for a group of one, or of up
    to :data:`LOOP_MAX_RANKS` ranks that pass :func:`check_peer_group`;
    "collective" otherwise. The verdict is taken from every rank's
    :func:`peer_info` (a collective), so every rank takes the same."""
    if point.group is None:
        return "peer", "a group of one"
    if point.world > LOOP_MAX_RANKS:
        return "collective", (f"{point.world} ranks, past the loop kernel's "
                              f"{LOOP_MAX_RANKS}")
    why = check_peer_group(_gather_objects(peer_info(device), point))
    return ("collective", why) if why else ("peer", "every card a peer")


def _segment(t: torch.Tensor) -> tuple[int, int]:
    """(base, offset) of ``t``'s data in the device allocation that holds
    it: a CUDA IPC handle names a whole allocation."""
    ptr = t.data_ptr()
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] == t.device.index and \
                seg["address"] <= ptr < seg["address"] + seg["total_size"]:
            return seg["address"], ptr - seg["address"]
    raise RuntimeError("fps_sharded: the exchange buffer's allocation was "
                       "not found")


def _open(handle: bytes) -> int:
    if handle not in _OPENED:
        ptr = ctypes.c_void_p()
        _kernels.check(_kernels.function("point_parallel", "vlp3d_ipc_open")(
            handle, ctypes.byref(ptr)), "opening a peer's exchange buffer")
        _OPENED[handle] = ptr.value
    return _OPENED[handle]


class _Exchange:
    """The peer route's exchange buffers of ``point`` for B rows: this
    rank's (zeroed), and a device array of every rank's, peers' opened by
    CUDA IPC (a group of one: its own buffer alone); the sequence number
    the next call starts at."""

    route = "peer"

    def __init__(self, point: ModelGroup, b: int, device: torch.device,
                 why: str = ""):
        self.why = why
        self.seq = 1  # every flag starts at 0
        if point.group is None:
            self.buf = torch.zeros(exchange_words(b, 1), dtype=torch.int64,
                                   device=device)
            self.peers = torch.tensor([self.buf.data_ptr()],
                                      dtype=torch.int64, device=device)
            return
        self.buf = torch.zeros(exchange_words(b, point.world),
                               dtype=torch.int64, device=device)
        base, offset = _segment(self.buf)
        handle = ctypes.create_string_buffer(64)
        _kernels.check(_kernels.function("point_parallel", "vlp3d_ipc_handle")(
            base, handle), "sharing the exchange buffer")
        # zero before a peer can write into it
        torch.cuda.synchronize(device)
        shared = _gather_objects((handle.raw, offset), point)
        ptrs = [self.buf.data_ptr() if r == point.rank else _open(h) + off
                for r, (h, off) in enumerate(shared)]
        self.peers = torch.tensor(ptrs, dtype=torch.int64, device=device)
        # the collective a call of the group starts behind
        self.token = torch.zeros(1, dtype=torch.int32, device=device)


class _Collective:
    """The collective route of a group: nothing to set up."""

    route = "collective"

    def __init__(self, why: str):
        self.why = why


def _exchange(point: ModelGroup, b: int, device: torch.device,
              route: str | None = None):
    """The FPS route of ``point`` for B rows, chosen once (the group's
    verdict, or ``route`` forced) before any launch: an :class:`_Exchange`
    (peer) or a :class:`_Collective`. A forced peer route still takes the
    group's verdict and raises, before anything is allocated, for a group
    that cannot take it."""
    key = (id(point.group), point.rank, b, device.index, route)
    if key not in _EXCHANGES:
        if route == "collective":
            chosen, why = route, "forced"
        else:
            chosen, why = fps_route(point, device)
            if route == "peer":
                if chosen != "peer":
                    raise ValueError(f"fps_sharded: the peer route was "
                                     f"forced, but {why}")
                why = f"forced ({why})"
        _EXCHANGES[key] = (point.group,
                           _Exchange(point, b, device, why)
                           if chosen == "peer" else _Collective(why))
    return _EXCHANGES[key][1]


def _fps_loop_cuda(xyz: torch.Tensor, npoint: int, point: ModelGroup,
                   route: str | None = None) -> torch.Tensor:
    _kernels.require(xyz, "xyz", torch.float32, 3, 3)
    b, nl, _ = xyz.shape
    if b == 0 or npoint == 0:
        return torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    ex = _exchange(point, b, xyz.device, route)
    if ex.route == "collective":
        return _fps_collective(xyz, npoint, point, fps_shard_step)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    w = point.world if point.group is not None else 1
    cluster, points = loop_plan(nl)
    with _kernels.on_device(xyz):
        most = loop_max_clusters(cluster, nl, points)
    if most < 1:
        raise RuntimeError(f"fps_sharded: the card runs no cluster of "
                           f"{cluster} blocks of the loop kernel ({most})")
    if w > 1:
        # on this stream the launch then starts once every rank has
        # reached the call: the spin limit counts from there
        _sum(ex.token, point)
    seq = ex.seq
    ex.seq += npoint
    _launch_loop(xyz, npoint, out, nl=nl, w=w, rank0=point.rank,
                 ranks_here=1, nc=min(b, most), cluster=cluster,
                 points=points, peers=ex.peers, seq=seq)
    return out


def fps_sharded(xyz: torch.Tensor, npoint: int,
                point: ModelGroup = LOCAL_POINTS, *,
                route: str | None = None) -> torch.Tensor:
    """FPS over a point-sharded cloud: xyz (B, Nl, 3), this rank's slab
    of the global (B, N, 3) -> (B, npoint) int32 global indices, the same
    on every rank of ``point``. No gradient. A CUDA tensor takes the
    group's route (:func:`fps_route`; ``route`` "peer" or "collective"
    forces one, the same on every rank), a CPU tensor
    :func:`fps_sharded_plain`."""
    if route not in (None, *ROUTES):
        raise ValueError(f"fps_sharded: route {route!r} is not one of "
                         f"{ROUTES}")
    if not _kernels.cuda_or_cpu(xyz):
        return fps_sharded_plain(xyz, npoint, point)
    with torch.no_grad():
        return _fps_loop_cuda(xyz.float().contiguous(), npoint, point, route)


# ---------------------------------------------------------- ball query


def ball_query_merge_plain(all_idx: torch.Tensor, all_cnt: torch.Tensor,
                           nl: int, nsample: int) -> torch.Tensor:
    """Plain PyTorch merge (JAX's arithmetic): all_idx (W, B, M, S) local
    first-k indices, all_cnt (W, B, M) in-ball counts -> (B, M, S) int32
    global indices."""
    w = all_idx.shape[0]
    cnt = all_cnt.long().clamp(max=nsample)
    ends = cnt.cumsum(0)
    starts = ends - cnt
    total = ends[-1]
    s = torch.arange(nsample, device=all_idx.device)
    owner = (ends[..., None] <= s).sum(0).clamp(max=w - 1)  # (B, M, S)
    start_sel = torch.gather(starts[..., None].expand(-1, -1, -1, nsample),
                             0, owner[None])[0]
    t = (s - start_sel).clamp(0, nsample - 1)
    per_shard = torch.gather(all_idx.long(), 3, t[None].expand(w, -1, -1, -1))
    picked = torch.gather(per_shard, 0, owner[None])[0]
    gidx = picked + owner * nl
    first = torch.where(total[..., None] > 0, gidx[..., :1], 0)
    return torch.where(s < total[..., None], gidx, first).to(torch.int32)


def ball_query_merge(all_idx: torch.Tensor, all_cnt: torch.Tensor, nl: int,
                     nsample: int) -> torch.Tensor:
    """The per-shard ball queries merged into global slots: the
    ``ball_query_merge`` kernel for CUDA tensors (one warp a centre, the
    shards 32 at a time, any number of them; 32-bit indices), the plain
    version for CPU ones."""
    if not _kernels.cuda_or_cpu(all_idx):
        return ball_query_merge_plain(all_idx, all_cnt, nl, nsample)
    _kernels.require(all_idx, "all_idx", torch.int32, 4, nsample)
    _kernels.require(all_cnt, "all_cnt", torch.int32, 3)
    w, b, m, _ = all_idx.shape
    if all_cnt.shape != (w, b, m):
        raise ValueError("ball_query_merge: all_idx and all_cnt disagree")
    if all_idx.numel() >= 2 ** 31:
        raise ValueError("ball_query_merge: 2^31 or more slots")
    out = torch.empty((b, m, nsample), dtype=torch.int32,
                      device=all_idx.device)
    if out.numel() == 0:
        return out
    with _kernels.on_device(all_idx):
        rc = _kernels.function("point_parallel", "vlp3d_ball_query_merge")(
            all_idx.data_ptr(), all_cnt.data_ptr(), w, b, m, nsample, nl,
            out.data_ptr(), _kernels.stream_ptr(all_idx))
        if rc != 0:
            _kernels.check(rc, "ball query merge kernel")
    _kernels.launches["ball_query_merge"] += 1
    return out


def ball_query_sharded(radius: float, nsample: int, xyz: torch.Tensor,
                       new_xyz: torch.Tensor,
                       point: ModelGroup = LOCAL_POINTS) -> torch.Tensor:
    """Ball query with the support points sharded over ``point``: xyz
    (B, Nl, 3) this rank's slab, new_xyz (B, M, 3) the centres, the same
    on every rank -> (B, M, nsample) int32 global indices, the same on
    every rank, equal to the dense ball query on the whole cloud."""
    with torch.no_grad():
        idx, cnt = ball_query_with_count(radius, nsample, xyz, new_xyz)
        return ball_query_merge(_gather(idx, point), _gather(cnt, point),
                                xyz.shape[1], nsample)


# ------------------------------------------- ranks emulated in one process


def fps_emulated(xyz: torch.Tensor, w: int, npoint: int, *,
                 route: str | None = None) -> list:
    """:func:`fps_sharded` over ``w`` ranks emulated on one device: xyz
    (B, N, 3) the whole cloud -> every rank's (B, npoint) int32 indices.
    On the card, one launch of the loop kernel holds the ``w`` ranks'
    clusters, their exchange buffers in one device buffer (raises when
    they cannot all be resident at once: a cluster of smaller blocks is
    tried first); with ``route`` "collective", and on the CPU, the ranks'
    steps (:func:`fps_shard_step`) in turn, the all-gather a
    concatenation of the ranks' candidates."""
    with torch.no_grad():
        xyz = xyz.float().contiguous()
        b, n, _ = xyz.shape
        nl = n // w
        if _kernels.cuda_or_cpu(xyz) and route != "collective":
            return list(_fps_emulated_cuda(xyz, w, nl, npoint))
        slabs = [xyz[:, i * nl:(i + 1) * nl].contiguous() for i in range(w)]
        outs = [torch.zeros((b, npoint), dtype=torch.int32,
                            device=xyz.device) for _ in range(w)]
        temps = [torch.full((b, nl), _INF, dtype=torch.float32,
                            device=xyz.device) for _ in range(w)]
        cands = [_seed(s, i) for i, s in enumerate(slabs)]
        for t in range(npoint):
            gathered = torch.cat(cands)
            cands = [fps_shard_step(slabs[i], temps[i], gathered, i * nl,
                                    t, t == npoint - 1, outs[i])
                     for i in range(w)]
        return outs


def _fps_emulated_cuda(xyz, w: int, nl: int, npoint: int) -> torch.Tensor:
    _kernels.require(xyz, "xyz", torch.float32, 3, 3)
    b = xyz.shape[0]
    out = torch.zeros((w, b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0 or npoint == 0:
        return out
    # the largest cluster whose w x B clusters are all resident at once,
    # else the largest one that holds w of them (the rows then queue)
    fits = []
    for cluster in (c for c in (16, 8, 4, 2) if c <= loop_plan(nl)[0]):
        cluster, points = loop_plan(nl, cluster)
        with _kernels.on_device(xyz):
            most = loop_max_clusters(cluster, nl, points)
        if most >= w:
            fits.append((most >= w * b, cluster, points, most))
    if not fits:
        raise RuntimeError(f"fps_emulated: the clusters of {w} ranks cannot "
                           f"all be resident on this card")
    _, cluster, points, most = max(fits, key=lambda f: (f[0], f[1]))
    nc = min(b, most // w)
    words = exchange_words(b, w)
    buf = torch.zeros(w * words, dtype=torch.int64, device=xyz.device)
    peers = torch.tensor([buf.data_ptr() + 8 * words * r for r in range(w)],
                         dtype=torch.int64, device=xyz.device)
    _launch_loop(xyz, npoint, out, nl=nl, w=w, rank0=0, ranks_here=w, nc=nc,
                 cluster=cluster, points=points, peers=peers, seq=1)
    return out


def ball_query_emulated(radius: float, nsample: int, xyz: torch.Tensor,
                        new_xyz: torch.Tensor, w: int,
                        merge=ball_query_merge) -> torch.Tensor:
    """:func:`ball_query_sharded` over ``w`` ranks emulated in one process
    (the all-gather a stack), with ``merge`` (:func:`ball_query_merge` or
    its plain version) -> (B, M, nsample) int32 global indices."""
    with torch.no_grad():
        nl = xyz.shape[1] // w
        parts = [ball_query_with_count(
            radius, nsample, xyz[:, i * nl:(i + 1) * nl].contiguous(),
            new_xyz) for i in range(w)]
        return merge(torch.stack([p[0] for p in parts]),
                     torch.stack([p[1] for p in parts]), nl, nsample)


# --------------------------------------------------------- owned rows


def gather_owned_plain(points: torch.Tensor, gidx: torch.Tensor,
                       offset: int) -> torch.Tensor:
    """Plain PyTorch owned-rows gather: points (B, Nl, C), gidx (B, R)
    global -> (B, R, C), zeros where another rank owns the index."""
    b, nl, c = points.shape
    local = gidx.long() - offset
    own = (local >= 0) & (local < nl)
    rows = torch.gather(points, 1, torch.where(own, local, 0)[..., None]
                        .expand(-1, -1, c))
    return torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def gather_owned(points: torch.Tensor, gidx: torch.Tensor,
                 offset: int) -> torch.Tensor:
    """The rows of this rank's slab at global indices (see
    :func:`gather_owned_plain`): the ``gather_owned`` kernel for CUDA
    tensors, the plain version for CPU ones. No autograd (see
    :func:`group_points_sharded`)."""
    if not _kernels.cuda_or_cpu(points):
        return gather_owned_plain(points, gidx, offset)
    points = points.contiguous()
    _kernels.require(points, "points", torch.float32, 3)
    _kernels.require(gidx, "gidx", torch.int32, 2)
    b, nl, c = points.shape
    r = gidx.shape[1]
    out = torch.empty((b, r, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    with _kernels.on_device(points):
        rc = _kernels.function("point_parallel", "vlp3d_gather_owned")(
            points.data_ptr(), gidx.data_ptr(), b, nl, r, c, offset,
            out.data_ptr(), _kernels.stream_ptr(points))
        if rc != 0:
            _kernels.check(rc, "gather owned kernel")
    _kernels.launches["gather_owned"] += 1
    return out


class _OwnedRows(torch.autograd.Function):
    """The owned rows summed over the point group. Every rank computes the
    same loss from the replicated sum, so the backward scatters the output
    gradient, unsummed, into the rows this rank owns."""

    @staticmethod
    def forward(ctx, points, gidx, point):
        offset = point.rank * points.shape[1]
        ctx.save_for_backward(gidx)
        ctx.offset, ctx.n = offset, points.shape[1]
        return _sum(gather_owned(points, gidx, offset), point)

    @staticmethod
    def backward(ctx, grad):
        (gidx,) = ctx.saved_tensors
        local = (gidx - ctx.offset).to(torch.int32)
        grad = grad.contiguous()
        if grad.is_cuda:
            dpoints = _group_points_grad_cuda(grad, local.contiguous(), ctx.n)
        else:
            dpoints = group_points_grad_plain(grad, local, ctx.n)
        return dpoints, None, None


def group_points_sharded(points: torch.Tensor, gidx: torch.Tensor,
                         point: ModelGroup = LOCAL_POINTS) -> torch.Tensor:
    """out[b, ..., c] = global_points[b, gidx[b, ...], c] for a table
    sharded over ``point`` (points (B, Nl, C), gidx (B, M) or (B, M, K)
    global) -> gidx.shape + (C,), the same on every rank; differentiable
    in ``points``."""
    b = gidx.shape[0]
    flat = gidx.reshape(b, -1).to(torch.int32).contiguous()
    points = points.float()
    if torch.is_grad_enabled() and points.requires_grad:
        out = _OwnedRows.apply(points, flat, point)
    else:
        out = _sum(gather_owned(points, flat, point.rank * points.shape[1]),
                   point)
    return out.reshape(*gidx.shape, points.shape[-1])


gather_points_sharded = group_points_sharded
"""out[b, m, c] = global_points[b, gidx[b, m], c] for a sharded table (the
K = 1 form of :func:`group_points_sharded`)."""


# ---------------------------------------------------------- the front


def query_and_group_sharded(radius: float, nsample: int, xyz, new_xyz,
                            features=None, *, use_xyz: bool = True,
                            normalize_xyz: bool = False,
                            point: ModelGroup = LOCAL_POINTS):
    """Point-sharded ``query_and_group`` (xyz and features sharded, the
    centres and outputs replicated) -> (grouped (B, M, nsample, 3[+C]),
    grouped_xyz (B, M, nsample, 3))."""
    idx = ball_query_sharded(radius, nsample, xyz, new_xyz, point)
    grouped_xyz = group_points_sharded(xyz, idx, point) - new_xyz[:, :, None]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        if not use_xyz:
            raise ValueError("need features when use_xyz=False")
        return grouped_xyz, grouped_xyz
    grouped_feats = group_points_sharded(features, idx, point)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1), grouped_xyz
    return grouped_feats, grouped_xyz


def large_scene_front(point: ModelGroup, npoint: int, radius: float,
                      nsample: int, *, use_xyz: bool = True,
                      normalize_xyz: bool = True,
                      fps_route: str | None = None):
    """The point-sharded SA front end: ``run(xyz (B, Nl, 3), features
    (B, Nl, C) | None) -> (new_xyz (B, npoint, 3), grouped (B, npoint,
    nsample, 3[+C]), fps_inds (B, npoint))`` on this rank's slab of each
    of this data rank's scenes; every output is the same on every rank of
    ``point`` and equals the dense SA1 inputs on the whole cloud.
    ``fps_route`` forces the FPS's route (see :func:`fps_sharded`)."""

    def run(xyz, features=None):
        fps_idx = fps_sharded(xyz, npoint, point, route=fps_route)
        new_xyz = gather_points_sharded(xyz, fps_idx, point)
        grouped, _ = query_and_group_sharded(
            radius, nsample, xyz, new_xyz, features, use_xyz=use_xyz,
            normalize_xyz=normalize_xyz, point=point)
        return new_xyz, grouped, fps_idx

    return run


def apply_backbone_large_scene(backbone, point_clouds: torch.Tensor,
                               point: ModelGroup = LOCAL_POINTS) -> dict:
    """The backbone on a scene sharded over ``point``: point_clouds (B,
    Nl, 3 + C) this rank's slab. SA1's FPS, ball query and grouping run
    point-sharded (:func:`large_scene_front`), the rest of the backbone on
    their small outputs with the same parameters as a dense forward
    (``sa1_precomputed``); returns the dense forward's dict."""
    sa1 = backbone.sa1
    front = large_scene_front(point, sa1.npoint, sa1.radius, sa1.nsample)
    features = point_clouds[..., 3:] if point_clouds.shape[-1] > 3 else None
    return backbone(point_clouds,
                    sa1_precomputed=front(point_clouds[..., :3], features))

