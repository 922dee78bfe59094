#!/usr/bin/env python3
"""Smoke run of vlp3d_torch on one CUDA card: grounding inference and the
joint train step.

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; imports no JAX and
nothing of the vlp3d package. Phases, each fatal on failure:

1. card, power limit, torch / CUDA / nvcc versions;
2. build every kernel source under vlp3d_torch/csrc (one nvcc each, in
   parallel) and print ptxas register / shared-memory use;
3. build the full-width model (Config() with use_con=False,
   no_caption=True: 132 feature channels, SA 2048/1024/512/256, 256
   proposals, BERT-base text mode over 6 layers) from a seed, with random
   BatchNorm statistics, and run one warm-up forward at B=8, N=40960;
4. hold each kernel against its plain PyTorch version at the shapes the
   main path gives it (FPS x5, ball query x5 with and without counts,
   three-NN x2, from that forward's own tensors), plus zero-padded rows
   and empty balls; time kernel, plain version and, for three-NN,
   torch.cdist + topk with CUDA events. FPS besides: at every site the
   one-block kernel it replaced (time and indices), every other shape
   of the points-in-registers kernel that holds the row (blocks a row x
   points a thread: indices equal, times printed as sweep_ms), us a
   step, and the serial bound for the SMs a row has; then the edge
   cases, each through the wrapper's choice and through forced one-block
   and cluster shapes, fatal unless the index difference is 0: ties
   across blocks (duplicated halves, 7 distinct points), blocks with no
   valid point, an all-zero row, a row with one valid point, N = 40000 /
   1000 / 33, npoint = 1, npoint above the number of valid points, B =
   1 / 3 / 9 / 16, a 65536-point row (cluster) and a 262144-point row
   (one block, global scratch); plans the card must refuse raise and
   leave no error behind; how many clusters the card runs at once; host
   us a call of each wrapper (1000 unsynchronised calls);
5. with every launch count at 0, serve three requests through
   GroundingPredictor (one batch; a list of two; occupancy 3 through
   run_padded), read the counts (FPS 5, ball query 5, three-NN 2, row
   gather 13 per forward, no backward), check the outputs, compare one
   forward against the same forward with the plain ops on the card
   (pred_ref equal, cluster_ref within 1e-4), and trace one request with
   torch.profiler (device time by kernel, device-busy share);
6. the train path: the full-width model with use_con=True from a seed,
   (two nudges: small vote offsets, ~0.7 m boxes, so that every loss is
   live), AdamW with its two learning-rate groups on the cosine schedule, one
   make_batch(istrain=1) batch at B=8, N=40960 on the card. One recorded
   forward + backward gives every call site of the row gather its own
   tensors (C = 3, 64, 128, 135, 256; the multiview site is a sliced
   view; the folded SA sites pass their centre term as the subtrahend):
   the forward kernel is held against torch.gather (fatal unless the
   difference is 0), with the site's subtrahend or a random one against
   gather - sub (fatal unless 0), and the scatter-add backward kernel
   against index_add_ (fatal above GRAD_RTOL of the absolute sum meeting
   in a row), also on all-equal neighbourhoods and on C = 3 and C = 135
   rows with K = 64, with times for kernel, plain version, library call
   and, where a subtrahend is fused, the two-op form; host us a call at
   a K = 1 site beside index_select's. Then,
   with every count at 0, train steps on that batch: one at epoch 60
   (OCC/OSC positive, the reference weight switched), 8 at epoch 0, one
   more at epoch 60; the counts of one
   step must be FPS 5, ball query 5, three-NN 2, row gather 13, its
   backward 7; every loss finite, the vote and objectness losses falling
   over the repeated steps; the same forward + backward with the plain
   ops on the card compared with the kernels' (loss within 1e-5
   relative, gradients within 1e-4 of their largest entry); step ms,
   peak memory and a torch.profiler trace of one step by kernel name;
7. print {"kernels": [...]} with every kernel of both paths (the CUDA
   functions behind each in kernel_functions, host_us beside the times),
   the card's name and power limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
SMS = 132
# fp32 operations a distance test costs: 3 sub, 3 mul, 2 add, 1 min/cmp
OPS_PER_TEST = 9
B, N = 8, 40960
CLUSTER_REF_TOL = 1e-4
INTERP_TOL = 1e-5
DIST_TOL = 1e-6
# kernel step against plain-op step on the card: the forward is the same
# arithmetic on the same indices, the backward differs in the order the
# scatter-add sums colliding rows
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # of the gradient tensor's largest entry
TRAIN_STEPS_EPOCH0 = 8
# kernel launches of one forward, and of one train step's backward
PER_FORWARD = {"fps": 5, "ball_query": 5, "three_nn": 2, "group_points": 13,
               "group_points_grad": 0}
PER_STEP = dict(PER_FORWARD, group_points_grad=7)


def fail(msg: str):
    raise RuntimeError(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def index_err(torch, got, want) -> float:
    """Largest absolute difference of two integer tensors of one shape
    (a shape mismatch is infinite)."""
    if got.shape != want.shape:
        return float("inf")
    if got.numel() == 0:
        return 0.0
    return float((got.long() - want.long()).abs().max().item())


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_ops():
    """Route every kernel wrapper to its plain version (for the plain-op
    reference forward and backward on the card); restored on exit."""
    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    bq = importlib.import_module("vlp3d_torch.ops.ball_query")
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    saved = (smp._fps_cuda, bq._ball_query_cuda, itp._three_nn_cuda,
             grp._gather_rows)

    def bq_plain(radius, nsample, xyz, new_xyz, with_count):
        idx, cnt = bq.ball_query_plain(radius, nsample, xyz, new_xyz)
        return idx, (cnt if with_count else None)

    smp._fps_cuda = smp.fps_plain
    bq._ball_query_cuda = bq_plain
    itp._three_nn_cuda = itp.three_nn_plain
    grp._gather_rows = grp.group_points_plain
    try:
        yield
    finally:
        (smp._fps_cuda, bq._ball_query_cuda, itp._three_nn_cuda,
         grp._gather_rows) = saved


def fps_variants(n: int):
    """Every (blocks a row, points a thread) of the points-in-registers
    FPS kernel that holds a row of n points within the threads its
    register budget allows (the limits of vlp3d_torch/csrc/fps.cu),
    leaving out those whose threads would mostly hold padding."""
    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    for blocks in ((8, 16) if n > 4096 else (1, 2, 4)):
        share = -(-n // blocks)
        for points, limit in smp._REGS_THREADS.items():
            threads = 32 * -(-share // (32 * points))
            if threads <= limit and (points == 2 or share > 16 * points):
                yield blocks, points


def check_fps_edges(torch, cloud):
    """Phase 4, FPS where trouble is likely: every case through the
    wrapper's own choice of kernel and, for short rows, again through a
    cluster, indices equal to the plain version's (fatal otherwise)."""
    from vlp3d_torch import ops
    from vlp3d_torch.ops import _kernels
    from vlp3d_torch.ops.sampling import fps_plain

    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    cloud = cloud.contiguous()
    dev = cloud.device
    cases = []

    def case(name, xyz, npoint, plans=(None,)):
        xyz = xyz.contiguous()
        want = fps_plain(xyz, npoint)
        for plan in plans:
            got = (ops.furthest_point_sample(xyz, npoint) if plan is None
                   else smp._fps_cuda(xyz, npoint, plan))
            torch.cuda.synchronize()
            err = index_err(torch, got, want)
            if err != 0:
                fail(f"fps edge case {name} (plan {plan}): indices differ "
                     f"from the plain version by up to {err}")
        cases.append(name)
        return want

    n = cloud.shape[1]
    short = cloud[:, :2048]
    both = (None, (16, 8), (8, 16), (16, 32))
    small = (None, (1, 32), (1, 8), (4, 8), (16, 2))
    # ties across blocks: the second half repeats the first
    dup = cloud.clone()
    dup[:, n // 2:] = dup[:, :n // 2]
    case("duplicated halves, N=40960", dup, 256, both)
    dup = short.clone()
    dup[:, 1024:] = dup[:, :1024]
    case("duplicated halves, N=2048", dup, 256, small)
    few = cloud[:, :7].repeat(1, 6000, 1)[:, :n]
    case("7 distinct points, N=40960", few, 64, both)
    case("7 distinct points, N=1022", few[:, :1022], 64, small)
    # blocks whose whole share is invalid, rows with none or one valid point
    tail = cloud.clone()
    tail[:, n // 4:] = 0.0
    tail[1] = 0.0
    tail[2] = 0.0
    tail[2, 31000] = 1.5
    want = case("zero tail of 3N/4, an all-zero row, a row with one valid "
                "point, N=40960", tail, 128, both)
    if (want[1] != 0).any() or (want[2, 1:] != 31000).any():
        fail("fps edge case: the plain version itself is off")
    tail = short.clone()
    tail[:, 300:] = 0.0
    tail[1] = 0.0
    tail[2] = 0.0
    tail[2, 2047] = 1.5
    case("zero tail, all-zero row, one valid point, N=2048", tail, 128, small)
    # N that no block x thread x point grid divides, npoint at its ends
    case("N=40000", cloud[:, :40000], 128, both)
    case("N=1000", cloud[:, :1000], 128, small)
    case("N=33", cloud[:, :33], 20, (None, (1, 4), (4, 2)))
    case("npoint=1", cloud, 1, both)
    case("npoint=1, N=512", cloud[:, :512], 1, small)
    sparse = cloud[:, :33].clone()
    sparse[:, 10:] = 0.0
    case("npoint 20 > 10 valid points", sparse, 20, (None, (4, 2)))
    # more clusters than the card runs at once must queue
    for b in (1, 3, 9, 16):
        xyz = cloud[torch.arange(b, device=dev) % cloud.shape[0]].clone()
        xyz += torch.arange(b, device=dev)[:, None, None] * 0.01
        case(f"B={b}, N=40960", xyz, 64, both)
        case(f"B={b}, N=1024", xyz[:, :1024], 64, small)
    # rows too long for a cluster: the one-block kernel, global scratch
    big = torch.rand(2, 1 << 18, 3, device=dev) * 6
    if smp._fps_plan(big.shape[1]) is not None:
        fail("a 262144-point row should take the global-scratch kernel")
    case("N=262144 (global scratch)", big, 32)
    case("N=65536 (cluster)", big[:, :1 << 16], 32, (None, "global"))
    # a launch the card refuses raises; nothing else is tried
    for plan in ((32, 8), (1, 3), (1, 2)):
        try:
            smp._fps_cuda(cloud, 8, plan)
        except RuntimeError:
            continue
        fail(f"fps: plan {plan} should have been refused")
    torch.cuda.synchronize()
    ops.furthest_point_sample(cloud, 8)  # the refusals left no error behind
    torch.cuda.synchronize()
    occ = {f"{c}x{p}": _kernels.function("fps", "vlp3d_fps_max_clusters")(
        c, n, p) for c, p in fps_variants(n)}
    print(f"[4] fps: {len(cases)} edge cases equal to plain: "
          + "; ".join(cases))
    print(f"[4] fps: clusters of the N={n} kernel the card runs at once "
          f"(blocks x points a thread: clusters): {json.dumps(occ)}; refused plans "
          "raise")


def check_kernels(torch, config, out):
    """Phase 4: every kernel against its plain version at main-path shapes."""
    from vlp3d_torch import ops
    from vlp3d_torch.ops.ball_query import ball_query_plain
    from vlp3d_torch.ops.host_time import host_us
    from vlp3d_torch.ops.interpolate import three_nn_plain
    from vlp3d_torch.ops.sampling import fps_plain

    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    cfg = config.model
    xyz_in = [out["point_clouds_xyz"], out["sa1_xyz"], out["sa2_xyz"],
              out["sa3_xyz"], out["vote_xyz"]]
    centers = [out["sa1_xyz"], out["sa2_xyz"], out["sa3_xyz"],
               out["sa4_xyz"], out["aggregated_vote_xyz"]]
    # the vote aggregation SA: FPS num_proposal of the votes, r=0.3, k=16
    calls = list(zip(("sa1", "sa2", "sa3", "sa4", "proposal"),
                     tuple(cfg.sa_npoints) + (cfg.num_proposal,),
                     tuple(cfg.sa_radii) + (0.3,),
                     tuple(cfg.sa_nsamples) + (16,)))
    rows = {"fps": [], "ball_query": [], "three_nn": []}

    for (site, npoint, radius, nsample), xyz, ctr in zip(calls, xyz_in,
                                                         centers):
        xyz = xyz.contiguous()
        b, n, _ = xyz.shape
        got = ops.furthest_point_sample(xyz, npoint)
        want = fps_plain(xyz, npoint)
        fps_err = index_err(torch, got, want)
        if fps_err != 0:
            fail(f"fps {site}: kernel indices differ from the plain version "
                 f"by up to {fps_err}")
        k_ms = cuda_ms(torch, lambda: ops.furthest_point_sample(xyz, npoint),
                       10)
        p_ms = cuda_ms(torch, lambda: fps_plain(xyz, npoint), 2, warmup=0)
        # the kernel this one replaced (one 1024-thread block a row,
        # distances in shared memory), timed in the same run
        if index_err(torch, smp._fps_cuda(xyz, npoint, "shared"), want) != 0:
            fail(f"fps {site}: the one-block kernel differs from plain")
        old_ms = cuda_ms(torch, lambda: smp._fps_cuda(xyz, npoint, "shared"),
                         5)
        # every other shape of the points-in-registers kernel that holds
        # this row: each must give the same indices; the wrapper's choice
        # (_fps_plan) is the fastest or within a few percent of it
        plan = smp._fps_plan(n)
        sweep = {}
        for cand in fps_variants(n):
            if index_err(torch, smp._fps_cuda(xyz, npoint, cand), want) != 0:
                fail(f"fps {site}: plan {cand} differs from plain")
            sweep["%dx%d" % cand] = cuda_ms(
                torch, lambda: smp._fps_cuda(xyz, npoint, cand), 3, warmup=1)
        nbytes = b * n * 12 + b * npoint * 4
        nops = (npoint - 1) * b * n * OPS_PER_TEST
        bms, by = bound_ms(nbytes, nops)
        # npoint - 1 dependent steps on the fp32 rate of the SMs one row
        # has: one for the one-block kernels, one a block of a cluster
        serial_1 = (npoint - 1) * n * OPS_PER_TEST / (FP32_FLOPS / SMS) * 1e3
        rows["fps"].append(dict(
            site=site, shape=[b, n, npoint], plan=list(plan),
            threads=32 * -(-(-(-n // plan[0])) // (32 * plan[1])), ms=k_ms,
            us_per_step=k_ms * 1e3 / (npoint - 1), one_block_kernel_ms=old_ms,
            one_block_us_per_step=old_ms * 1e3 / (npoint - 1),
            plain_ms=p_ms, bound_ms=bms, bound_by=by,
            serial_one_sm_ms=serial_1, serial_ms=serial_1 / plan[0],
            max_abs_err=fps_err, sweep_ms=sweep))

        ctr = ctr.contiguous()
        m = ctr.shape[1]
        idx = ops.ball_query(radius, nsample, xyz, ctr)
        idx_c, cnt_c = ops.ball_query_with_count(radius, nsample, xyz, ctr)
        pidx, pcnt = ball_query_plain(radius, nsample, xyz, ctr)
        bq_err = max(index_err(torch, idx, pidx),
                     index_err(torch, idx_c, pidx),
                     index_err(torch, cnt_c, pcnt))
        if bq_err != 0:
            fail(f"ball query {site}: kernel indices or counts differ from "
                 f"the plain version by up to {bq_err}")
        k_ms = cuda_ms(torch, lambda: ops.ball_query(radius, nsample, xyz,
                                                     ctr), 20)
        kc_ms = cuda_ms(torch, lambda: ops.ball_query_with_count(
            radius, nsample, xyz, ctr), 20)
        p_ms = cuda_ms(torch, lambda: ball_query_plain(radius, nsample, xyz,
                                                       ctr), 2, warmup=1)
        # the early-exit scan of this data: up to the nsample-th hit
        full = pcnt >= nsample
        scanned = torch.where(full, pidx[..., -1].long() + 1, n).sum().item()
        nbytes = b * n * 12 + b * m * 12 + b * m * nsample * 4
        bms, by = bound_ms(nbytes, scanned * OPS_PER_TEST)
        rows["ball_query"].append(dict(
            site=site, shape=[b, n, m, radius, nsample], ms=k_ms,
            with_count_ms=kc_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
            points_scanned=scanned, max_abs_err=bq_err,
            mean_count=pcnt.float().mean().item()))

    for site, unknown, known, feats in (
        ("fp1", out["sa3_xyz"], out["sa4_xyz"], out["sa4_features"]),
        ("fp2", out["sa2_xyz"], out["sa3_xyz"], out["sa3_features"]),
    ):
        unknown, known = unknown.contiguous(), known.contiguous()
        b, n, _ = unknown.shape
        m = known.shape[1]
        d, i = ops.three_nn(unknown, known)
        pd, pi = three_nn_plain(unknown, known)
        interp = ops.interpolate_features(unknown, known, feats)
        with plain_ops():
            pinterp = ops.interpolate_features(unknown, known, feats)
        torch.cuda.synchronize()
        if not torch.equal(i, pi):
            fail(f"three_nn {site}: kernel indices differ")
        d_err = (d - pd).abs().max().item()
        f_err = (interp - pinterp).abs().max().item()
        if d_err > DIST_TOL or f_err > INTERP_TOL:
            fail(f"three_nn {site}: dist2 err {d_err}, interp err {f_err}")
        k_ms = cuda_ms(torch, lambda: ops.three_nn(unknown, known), 50)
        p_ms = cuda_ms(torch, lambda: three_nn_plain(unknown, known), 10)
        lib_ms = cuda_ms(torch, lambda: torch.topk(
            torch.cdist(unknown, known), 3, dim=-1, largest=False), 10)
        nbytes = b * (n + m) * 12 + b * n * 3 * 8
        bms, by = bound_ms(nbytes, b * n * m * OPS_PER_TEST)
        rows["three_nn"].append(dict(
            site=site, shape=[b, n, m], ms=k_ms, plain_ms=p_ms,
            library_ms=lib_ms, bound_ms=bms, bound_by=by,
            max_abs_err=d_err, interp_max_abs_err=f_err))

    # edge cases: zero-padded points and an all-zero row, empty balls
    xyz = out["point_clouds_xyz"].clone()
    n, npoint = xyz.shape[1], cfg.sa_npoints[0]
    xyz[0] = 0.0
    xyz[:, -n // 40:] = 0.0
    got = ops.furthest_point_sample(xyz, npoint)
    if not torch.equal(got, fps_plain(xyz, npoint)) or (got[0] != 0).any():
        fail("fps: zero-padded rows differ from the plain version")
    ctr = out["sa1_xyz"].clone()
    empty = ctr.shape[1] // 20
    ctr[:, :empty] = 100.0
    radius, nsample = cfg.sa_radii[0], cfg.sa_nsamples[0]
    idx, cnt = ops.ball_query_with_count(radius, nsample, xyz, ctr)
    pidx, pcnt = ball_query_plain(radius, nsample, xyz, ctr)
    if not (torch.equal(idx, pidx) and torch.equal(cnt, pcnt)
            and (idx[:, :empty] == 0).all()):
        fail("ball query: empty balls differ from the plain version")
    torch.cuda.synchronize()
    print("[4] edge cases equal to plain: zero-padded rows, an all-zero row, "
          "empty balls")
    check_fps_edges(torch, out["point_clouds_xyz"])

    # host time of one wrapper call, on arguments small enough that the
    # device keeps up with the host
    tiny = out["sa4_xyz"][:1, :64].contiguous()
    ctr = tiny[:, :8].contiguous()
    us = {"fps": host_us(lambda: ops.furthest_point_sample(tiny, 2)),
          "ball_query": host_us(lambda: ops.ball_query(
              0.3, 4, tiny, ctr)),
          "three_nn": host_us(lambda: ops.three_nn(tiny, ctr))}
    print(f"[4] host us a call on {list(tiny.shape)}: {json.dumps(us)}")
    for name, rs in rows.items():
        for r in rs:
            r["host_us"] = us[name]
            print(f"[4] {name} {json.dumps(r)}")
    return rows


def profile_call(torch, fn, tag: str, what: str, top: int = 15):
    """Trace one call of fn with torch.profiler; print the device time by
    kernel name and the device-busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies): an operator's own entry,
    # or an annotated range such as Optimizer.step, repeats the time of
    # the kernels launched inside it
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        print(f"[{tag}] profile: the trace holds no device time (not "
              "measured)")
        return
    rows = [dict(op=e.key[:90], calls=e.count, device_ms=dev_us(e) / 1e3)
            for e in events[:top] if dev_us(e) > 0]
    print(f"[{tag}] profile of one {what}: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of wall; idle "
          f"share {1 - busy_ms / wall_ms:.3f}), {sum(e.count for e in events)}"
          " device kernels and copies")
    for r in rows:
        print(f"[{tag}]   {r['device_ms']:9.3f} ms  x{r['calls']:<5d} "
              f"{r['op']}")


def kernel_line(rows, serving, train):
    """The {"kernels": [...]} line. ``rows`` holds the per-call-site checks
    of each kernel; ``serving`` / ``train`` the launch counts of the two
    main-path runs."""
    sources = {
        "fps": ("vlp3d_torch/csrc/fps.cu", "vlp3d/ops/sampling.py:60"),
        "ball_query": ("vlp3d_torch/csrc/ball_query.cu",
                       "vlp3d/ops/ball_query.py:33"),
        "three_nn": ("vlp3d_torch/csrc/three_nn.cu",
                     "vlp3d/ops/interpolate.py:16"),
        "group_points": ("vlp3d_torch/csrc/grouping.cu",
                         "vlp3d/ops/grouping.py:117"),
        "group_points_grad": ("vlp3d_torch/csrc/grouping.cu",
                              "vlp3d/ops/grouping.py:135"),
    }
    functions = {
        "fps": ["fps_regs_kernel<P, false>", "fps_regs_kernel<P, true>",
                "fps_kernel"],
        "ball_query": ["ball_query_kernel"],
        "three_nn": ["three_nn_kernel"],
        "group_points": ["group_points_vec_kernel",
                         "group_points_stream_kernel"],
        "group_points_grad": ["group_points_grad_kernel"],
    }
    kernels = []
    for name, rs in rows.items():
        # one forward's (for the gather's backward: one train step's)
        # calls of this kernel, summed over its call sites
        rs = [r for r in rs if r.get("on_path", True)]
        ops_bound = sum(r["bound_ms"] for r in rs if r["bound_by"] ==
                        "operations")
        bytes_bound = sum(r["bound_ms"] for r in rs if r["bound_by"] ==
                          "bytes")
        lib = [r.get("library_ms") for r in rs]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": serving[name] + train[name],
            "launches_serving": serving[name],
            "launches_train": train[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if ops_bound >= bytes_bound else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "host_us": rs[0]["host_us"],
            "kernel_functions": functions[name],
        })
        if name == "fps":
            steps = sum(r["shape"][2] - 1 for r in rs)
            kernels[-1].update(
                serial_ms=sum(r["serial_ms"] for r in rs),
                serial_one_sm_ms=sum(r["serial_one_sm_ms"] for r in rs),
                us_per_step=kernels[-1]["ms"] * 1e3 / steps,
                one_block_kernel_ms=sum(r["one_block_kernel_ms"] for r in rs))
    return {"kernels": kernels}


def record_gather_sites(torch, run):
    """Run ``run()`` with the row gather wrapped so that every call leaves
    its table, its indices and (after a backward) the gradient of its
    output. Returns the list of call sites in call order."""
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    sites, orig = [], grp._gather_rows

    def recording(points, idx, sub=None):
        out = orig(points, idx, sub)
        site = {"points": points.detach(),
                "idx": idx.to(torch.int32).contiguous(),
                "sub": None if sub is None else sub.detach().contiguous(),
                "grad": None, "differentiable": out.requires_grad}
        if out.requires_grad:
            out.register_hook(
                lambda g, site=site: site.__setitem__("grad", g.detach()))
        sites.append(site)
        return out

    grp._gather_rows = recording
    try:
        run()
    finally:
        grp._gather_rows = orig
    return sites


def check_group_site(torch, label, points, idx, grad, on_path, reps=20,
                     sub=None):
    """One call site of the row gather: the forward kernel against
    torch.gather (exact), with and without a subtrahend, and with ``grad``
    the backward kernel against index_add_; times of kernel, plain
    version and library call. ``sub`` is what the site itself passes; a
    (B, M, K) site without one is also checked against a random one."""
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    b, n, c = points.shape
    idx2 = idx.reshape(b, -1)
    r = idx2.shape[1]
    got = grp._group_points_cuda(points, idx)
    want = grp.group_points_plain(points, idx)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if err != 0 or got.shape != want.shape:
        fail(f"group_points {label}: kernel differs from torch.gather by {err}")
    if idx.dim() == 3:
        s = sub if sub is not None else torch.randn(
            b, idx.shape[1], c, device=points.device)
        got_s = grp._group_points_cuda(points, idx, s)
        torch.cuda.synchronize()
        sub_err = (got_s - (want - s[:, :, None, :])).abs().max().item()
        if sub_err != 0:
            fail(f"group_points {label}: with a subtrahend the kernel "
                 f"differs from gather - sub by {sub_err}")
        err = max(err, sub_err)
        del got_s, s
    del want
    offs = torch.arange(b, device=idx.device, dtype=torch.int64)[:, None] * n
    flat = (idx2.long() + offs).reshape(-1)
    table = points.contiguous().reshape(b * n, c)
    touched = torch.unique(flat).numel()
    nbytes = touched * c * 4 + idx.numel() * 4 + got.numel() * 4
    if sub is not None:
        nbytes += sub.numel() * 4
    bms, by = bound_ms(nbytes, 0 if sub is None else got.numel())
    shape = [b, n, c, r]
    del got
    fwd = dict(
        site=label, shape=shape, on_path=on_path, max_abs_err=err,
        fused_sub=sub is not None,
        ms=cuda_ms(torch, lambda: grp._group_points_cuda(points, idx, sub),
                   reps),
        plain_ms=cuda_ms(torch, lambda: grp.group_points_plain(
            points, idx, sub), reps),
        library_ms=cuda_ms(torch, lambda: torch.index_select(table, 0, flat),
                           reps),
        bound_ms=bms, bound_by=by, rows_touched=touched)
    if sub is not None:
        # the two-op form this call replaces: gather, then subtract
        fwd["two_op_ms"] = cuda_ms(torch, lambda: grp._group_points_cuda(
            points, idx) - sub[:, :, None, :], reps)
        fwd["library_two_call_ms"] = cuda_ms(
            torch, lambda: torch.index_select(table, 0, flat).view(
                *idx.shape, c) - sub[:, :, None, :], reps)
    print(f"[6] group_points {json.dumps(fwd)}")
    if grad is None:
        return fwd, None
    idx = idx2
    grad = grad.reshape(b, r, c).contiguous()
    got = grp._group_points_grad_cuda(grad, idx, n)
    want = grp.group_points_grad_plain(grad, idx, n)
    scale = grp.group_points_grad_plain(grad.abs(), idx, n)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    rel = (diff / scale.clamp_min(1e-30)).max().item()
    if not bool((diff <= grp.GRAD_RTOL * scale + 1e-30).all()):
        fail(f"group_points_grad {label}: kernel differs from index_add_ by "
             f"{err} ({rel} of the absolute sum in the row; tolerance "
             f"{grp.GRAD_RTOL})")
    nbytes = grad.numel() * 4 + idx.numel() * 4 + b * n * c * 4
    bms, by = bound_ms(nbytes, grad.numel())
    flat_grad = grad.reshape(b * r, c)
    acc = torch.zeros((b * n, c), device=grad.device)
    bwd = dict(
        site=label, shape=shape, on_path=on_path, max_abs_err=err,
        max_rel_err=rel,
        ms=cuda_ms(torch, lambda: grp._group_points_grad_cuda(grad, idx, n),
                   reps),
        plain_ms=cuda_ms(torch, lambda: grp.group_points_grad_plain(
            grad, idx, n), reps),
        library_ms=cuda_ms(torch, lambda: acc.zero_().index_add_(
            0, flat, flat_grad), reps),
        bound_ms=bms, bound_by=by,
        max_rows_in_one=int(torch.bincount(flat).max().item()))
    print(f"[6] group_points_grad {json.dumps(bwd)}")
    return fwd, bwd


def check_grouping(torch, model, config, batch):
    """Phase 6, kernels: the row gather and its backward at every call
    site of one train step, from the step's own tensors."""
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.ops.host_time import host_us

    def train_pass():
        out = model(batch, train=True)
        loss, _ = compute_joint_loss(config, out, batch)
        loss.backward()
        model.zero_grad(set_to_none=True)

    names = ["sa1 xyz", "sa1 rows (train: raw 3+C)", "sa2 xyz", "sa2 rows",
             "sa3 xyz", "sa3 rows", "sa4 xyz", "sa4 rows", "fp1 3-nn rows",
             "fp2 3-nn rows", "proposal xyz", "proposal rows",
             "relation multiview"]
    sites = record_gather_sites(torch, train_pass)
    if len(sites) != len(names):
        fail(f"a train forward made {len(sites)} row gathers, expected "
             f"{len(names)}")
    with_grad = [nm for nm, st in zip(names, sites) if st["differentiable"]]
    want_grad = ["sa2 rows", "sa3 rows", "sa4 rows", "fp1 3-nn rows",
                 "fp2 3-nn rows", "proposal xyz", "proposal rows"]
    if with_grad != want_grad:
        fail(f"row gathers with a backward: {with_grad}, expected {want_grad}")
    rows = {"group_points": [], "group_points_grad": []}

    def add(label, st, on_path=True, reps=20):
        fwd, bwd = check_group_site(torch, label, st["points"], st["idx"],
                                    st["grad"], on_path, reps,
                                    sub=st.get("sub"))
        rows["group_points"].append(fwd)
        if bwd is not None:
            rows["group_points_grad"].append(bwd)

    for nm, st in zip(names, sites):
        add(nm, st)
    # host time of a call, at a K = 1 site: the wrapper against the one
    # library call that computes the same rows
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    st = sites[names.index("sa4 xyz")]
    pts, ix = st["points"], st["idx"]
    b, n, c = pts.shape
    table = pts.contiguous().reshape(b * n, c)
    flat = (ix.long() + torch.arange(b, device=ix.device)[:, None] * n
            ).reshape(-1)
    us = {"gather_points": host_us(lambda: grp.gather_points(pts, ix)),
          "index_select": host_us(lambda: torch.index_select(
              table, 0, flat))}
    st = sites[names.index("proposal xyz")]
    g, ix2, n2 = st["grad"].contiguous(), st["idx"], st["points"].shape[1]
    us["group_points_grad"] = host_us(
        lambda: grp._group_points_grad_cuda(g, ix2, n2))
    print(f"[6] host us a call at K = 1 sites {list(pts.shape)}, "
          f"{list(g.shape)}: {json.dumps(us)}")
    for r in rows["group_points"]:
        r["host_us"] = us["gather_points"]
    for r in rows["group_points_grad"]:
        r["host_us"] = us["group_points_grad"]
    sa2 = dict(sites[3])
    sa1_idx = sites[1]["idx"]
    del sites

    # the inference form of SA1 (folded first layer: 64 channels gathered)
    eval_sites = record_gather_sites(torch, lambda: model(batch, train=False,
                                                          is_eval=True))
    add("sa1 rows (inference: folded 64)", eval_sites[1], on_path=False)
    del eval_sites

    # all-equal neighbourhoods (the empty-ball padding): K rows into one
    sa2["idx"] = sa2["idx"][:, :, :1].expand_as(sa2["idx"]).contiguous()
    add("sa2 rows, all K equal", sa2, on_path=False)
    # C = 3 with K = 64 and a backward, C = 135 with a backward, and
    # C = 135 with a subtrahend (rows that are no multiple of 16 bytes)
    for label, c, with_sub in (("C=3 K=64", 3, False),
                               ("C=135 K=64", 135, False),
                               ("C=135 K=64 with sub", 135, True)):
        pts = torch.randn(batch["point_clouds"].shape[0], N, c,
                          device=sa1_idx.device)
        st = {"points": pts, "idx": sa1_idx, "grad": None}
        if with_sub:
            st["sub"] = torch.randn(sa1_idx.shape[:2] + (c,),
                                    device=sa1_idx.device)
        else:
            st["grad"] = torch.randn(sa1_idx.shape + (c,),
                                     device=sa1_idx.device)
        add(label, st, on_path=False, reps=5)
        del st, pts
    torch.cuda.synchronize()
    return rows


def loss_and_grads(torch, model, config, batch, names, seed):
    """One train forward + backward with dropout drawn from ``seed``;
    returns (loss, {name: gradient}) and leaves no gradient behind."""
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.layers import set_dropout_generator

    gen = torch.Generator(device=batch["point_clouds"].device)
    gen.manual_seed(seed)
    set_dropout_generator(model, gen)
    out = model(batch, train=True)
    loss, _ = compute_joint_loss(config, out, batch)
    loss.backward()
    grads = {n: model.get_parameter(n).grad.detach().clone() for n in names}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def step_phases(torch, model, config, optimizer, batch, gen, reps: int = 3):
    """One train step taken apart, with a synchronise after each phase:
    host-clock ms of forward, loss, backward and optimizer update (their
    sum exceeds an unsynchronised step, which overlaps host and device)."""
    import numpy as np

    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.layers import set_dropout_generator

    set_dropout_generator(model, gen)
    phases = {"forward": [], "loss": [], "backward": [], "optimizer": []}

    def lap(name, t0):
        torch.cuda.synchronize()
        phases[name].append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model(batch, train=True)
        t = lap("forward", t)
        loss, _ = compute_joint_loss(config, out, batch)
        t = lap("loss", t)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        t = lap("backward", t)
        optimizer.step()
        lap("optimizer", t)
        del out, loss
    med = {k: float(np.median(v)) for k, v in phases.items()}
    print(f"[6] one step by phase, synchronised after each (median of "
          f"{reps}): {json.dumps(med)}; sum {sum(med.values()):.3f} ms")


def drive_train(torch, batch_size, num_points, smi):
    """Phase 6; returns (per-call kernel rows, train-path launch counts)."""
    import numpy as np

    from vlp3d_torch import ops
    from vlp3d_torch.config import Config, ModelConfig
    from vlp3d_torch.data.synthetic import make_batch
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.train import (
        batch_to_device,
        make_optimizer,
        make_train_step,
    )
    from vlp3d_torch.train.schedules import cosine_lr

    config = Config(model=ModelConfig(use_con=True, no_caption=True))
    t0 = time.perf_counter()
    model = JointNet(config)
    device = next(model.parameters()).device
    # two nudges to the seeded weights so that every loss is live from
    # the first step: votes stay near their seeds (half of which lie on
    # objects) and boxes start ~0.7 m wide, so some proposals lie within
    # 0.3 m of a GT center and overlap a referred box by more than 0.25
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.05)
        model.vgen.conv3.bias.mul_(0.05)
        model.proposal.proposal.box_predictor.bias.fill_(-1.0)
    optimizer = make_optimizer(
        model, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
        steps_per_epoch=100)
    train_step = make_train_step(model, config, optimizer)
    n_train = sum(p.numel() for g in optimizer.param_groups
                  for p in g["params"])
    print(f"[6] train model built in {time.perf_counter() - t0:.1f} s: "
          f"{n_train} trained parameters of "
          f"{sum(p.numel() for p in model.parameters())}, groups "
          f"{[(g['name'], len(g['params']), g['base_lr']) for g in optimizer.param_groups]}")
    host = make_batch(config, batch_size=batch_size, num_points=num_points,
                      seed=7, epoch=0, istrain=1)
    batch = batch_to_device(host, device)
    late = dict(batch, epoch=torch.tensor(60, device=device))

    # kernels at the step's call sites
    torch.cuda.reset_peak_memory_stats()
    rows = check_grouping(torch, model, config, batch)

    # the same forward + backward with the plain ops on the card
    probe = ["backbone_net.sa2.mlp_module.layer0.conv.weight",
             "backbone_net.sa1.mlp_module.layer0.conv.weight",
             "backbone_net.fp2.mlp.layer0.conv.weight",
             "vgen.conv3.weight",
             "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
             "relation.features_concat.0.weight", "match.match.0.weight"]
    loss_k, grads_k = loss_and_grads(torch, model, config, batch, probe, 11)
    with plain_ops():
        t0 = time.perf_counter()
        loss_p, grads_p = loss_and_grads(torch, model, config, batch, probe,
                                         11)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst = 0.0
    for n in probe:
        scale = grads_p[n].abs().max().item()
        worst = max(worst, (grads_k[n] - grads_p[n]).abs().max().item()
                    / max(scale, 1e-30))
    print(f"[6] kernel forward+backward against plain ops on the card "
          f"({plain_s * 1e3:.3f} ms): loss {loss_k.item()} vs "
          f"{loss_p.item()} (relative {loss_rel}), largest gradient "
          f"difference {worst} of the tensor's largest entry over "
          f"{len(probe)} tensors")
    if loss_rel > STEP_LOSS_RTOL or worst > STEP_GRAD_TOL:
        fail("the kernel step differs from the plain-op step")
    del grads_k, grads_p

    # the main path: train steps, with every count at 0 before
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # one step at epoch 60 first: the seeded objectness head still
    # accepts about half of the proposals, so OCC and OSC see positives
    # (once it has learnt that ~99.5% are background, its argmax mask is
    # empty and both are 0); then the repeated steps at epoch 0, then
    # epoch 60 again
    schedule = [(60, late)] + [(0, batch)] * TRAIN_STEPS_EPOCH0 + [(60, late)]
    history, times = [], []
    for i, (_, b) in enumerate(schedule):
        t0 = time.perf_counter()
        history.append(train_step(b, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            one = dict(ops.launches)
            print(f"[6] launches of one train step: {one}")
            if one != PER_STEP:
                fail(f"launch counts of one step {one} != {PER_STEP}")
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = len(history)
    if launches != {k: v * steps for k, v in PER_STEP.items()}:
        fail(f"launch counts over {steps} steps: {launches}")
    history = [{k: v.item() for k, v in m.items()} for m in history]
    for i, ((epoch, _), m) in enumerate(zip(schedule, history)):
        print(f"[6] step {i} (epoch {epoch}): {times[i] * 1e3:.3f} ms "
              + json.dumps({k: m[k] for k in (
                  "loss", "vote_loss", "objectness_loss", "box_loss",
                  "ref_loss", "diou_loss", "lang_loss", "lang_con_loss",
                  "iou_con_loss", "pos_ratio", "max_iou_rate_0.25")}))
        for k, v in m.items():
            if not np.isfinite(v):
                fail(f"step {i}: non-finite {k}")
    if not (history[0]["lang_con_loss"] > 0 and history[0]["iou_con_loss"] > 0):
        fail("OCC/OSC gave no positive loss at epoch 60")
    # the vote and objectness losses must fall over the repeated steps.
    # The total need not: the box and reference losses come and go with
    # the proposals that land on GT boxes, and the language loss sits
    # behind a dropout of 0.5 on 64 sentences
    early = history[1:1 + TRAIN_STEPS_EPOCH0]
    for key in ("vote_loss", "objectness_loss"):
        series = [m[key] for m in early]
        if not min(series[2:]) < series[0]:
            fail(f"{key} does not fall over {len(series)} steps: {series}")
    if any(m["con_loss"] != 0.0 for m in early):
        fail("the contrast losses are not gated off before epoch 50")
    lrs = {g["name"]: g["lr"] for g in optimizer.param_groups}
    steady = float(np.median(times[1:])) * 1e3
    print(f"[6] train step at B={batch_size}, N={num_points}: first "
          f"{times[0] * 1e3:.3f} ms, median of the next {steps - 1} "
          f"{steady:.3f} ms, {batch_size / steady * 1e3:.3f} scenes/s; peak "
          f"memory {peak / 2**30:.3f} GiB; learning rates {lrs} ({smi})")
    step_phases(torch, model, config, optimizer, batch, gen)
    profile_call(torch, lambda: train_step(batch, gen), "6", "train step",
                 top=25)
    return rows, launches


def drive(torch, config, batch_size, num_points, smi):
    """Phases 3-5; returns (per-call kernel rows, main-path launch counts)."""
    import numpy as np

    from vlp3d_torch import ops
    from vlp3d_torch.data.synthetic import make_batch
    from vlp3d_torch.serving import STREAM_KEYS, GroundingPredictor

    # 3. the model from a seed and one warm-up forward
    t0 = time.perf_counter()
    pred = GroundingPredictor(config, batch_size=batch_size)
    print(f"[3] model built and seeded in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in pred.model.parameters())} parameters)")
    scenes = [make_batch(config, batch_size=batch_size, num_points=num_points, seed=s,
                         istrain=0) for s in range(4)]
    scenes = [{k: s[k] for k in STREAM_KEYS} for s in scenes]
    dev0 = pred._to_device(scenes[0])
    with torch.no_grad():
        warm = pred.model(dev0)
    torch.cuda.synchronize()
    warm["point_clouds_xyz"] = dev0["point_clouds"][..., :3]

    # 4. kernels against their plain versions
    rows = check_kernels(torch, config, warm)
    del warm

    # 5. the main path: three requests, launch counts, plain-op forward
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    timings = []
    t0 = time.perf_counter()
    r1 = pred([scenes[0]])
    timings.append(("call x1", batch_size, time.perf_counter() - t0))
    t0 = time.perf_counter()
    r2 = pred([scenes[1], scenes[2]])
    timings.append(("call x2", 2 * batch_size, time.perf_counter() - t0))
    occ = {k: v[:3] for k, v in scenes[3].items()}
    t0 = time.perf_counter()
    r3 = pred.run_padded(occ)
    timings.append(("run_padded occ3", 3, time.perf_counter() - t0))
    launches = dict(ops.launches)
    forwards = 4
    want = {name: n * forwards for name, n in PER_FORWARD.items()}
    print(f"[5] launches over {forwards} forwards: {launches}")
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    peak = torch.cuda.max_memory_allocated()
    k = config.model.num_proposal
    for res in r1 + r2 + [r3]:
        for key, v in res.items():
            if not np.isfinite(v).all():
                fail(f"non-finite {key}")
        pr = res["pred_ref"]
        if pr.shape != (batch_size, config.model.lang_num_max) or pr.min() < 0 \
                or pr.max() >= k:
            fail(f"pred_ref out of range: {pr.shape} {pr.min()} {pr.max()}")
    if not (r3["pred_ref"][3:] == r3["pred_ref"][0]).all():
        fail("run_padded: padded rows do not repeat row 0")
    for name, scenes_n, sec in timings:
        print(f"[5] request {name}: {sec * 1e3:.3f} ms, "
              f"{scenes_n / sec:.3f} scenes/s ({smi})")
    # steady state: the same single-batch request again
    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred([scenes[0]])
        steady.append(time.perf_counter() - t0)
    steady_ms = float(np.median(steady)) * 1e3
    print(f"[5] steady single-batch request: median {steady_ms:.3f} ms of 5, "
          f"{batch_size / steady_ms * 1e3:.3f} scenes/s; peak memory "
          f"{peak / 2**30:.3f} GiB ({smi})")
    with plain_ops():
        t0 = time.perf_counter()
        rp = pred([scenes[0]])[0]
        plain_s = time.perf_counter() - t0
    err = float(np.abs(rp["cluster_ref"] - r1[0]["cluster_ref"]).max())
    if not np.array_equal(rp["pred_ref"], r1[0]["pred_ref"]):
        fail("pred_ref of the kernel forward differs from the plain forward")
    if err > CLUSTER_REF_TOL:
        fail(f"cluster_ref differs from the plain forward by {err}")
    print(f"[5] plain-op forward on the card: {plain_s * 1e3:.3f} ms; "
          f"pred_ref equal, cluster_ref max abs err {err}")
    profile_call(torch, lambda: pred([scenes[0]]), "5", "request")
    return rows, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one",
              file=sys.stderr)
        return 1
    try:
        import vlp3d_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the vlp3d_torch package is missing ({e}); run "
              "from the root of the repository", file=sys.stderr)
        return 1

    from vlp3d_torch.config import Config, ModelConfig
    from vlp3d_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card and versions
    smi = smi_line()
    nvcc_v = subprocess.run([_kernels._nvcc(), "--version"],
                            capture_output=True, text=True, check=True,
                            timeout=60).stdout.strip().splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    print(f"[1] {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc '{nvcc_v}' python {sys.version.split()[0]} device {kind}")

    # 2. build
    t0 = time.perf_counter()
    ptxas = _kernels.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"[2] built {len(ptxas)} kernel libraries in {build_s:.1f} s")
    for name, log in ptxas.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2] {name}: {line.strip()}")

    # 3-5. the full-width model: Config() grounding defaults, B=8, N=40960
    config = Config(model=ModelConfig(use_con=False, no_caption=True))
    rows, serving = drive(torch, config, B, N, smi)
    torch.cuda.empty_cache()

    # 6. the joint train step at the same width
    train_rows, train = drive_train(torch, B, N, smi)
    rows.update(train_rows)
    for name in rows:
        if train[name] == 0 or (serving[name] == 0
                                and PER_FORWARD[name] > 0):
            fail(f"kernel {name} was not launched on a main path")

    # 7. results
    line = kernel_line(rows, serving, train)
    print(json.dumps(line))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
