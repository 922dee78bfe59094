#!/usr/bin/env python3
"""Smoke run of the vlp3d_torch grounding path on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; imports no JAX and
nothing of the vlp3d package. Phases, each fatal on failure:

1. card, power limit, torch / CUDA / nvcc versions;
2. build every kernel under vlp3d_torch/csrc (one nvcc each, in
   parallel) and print ptxas register / shared-memory use;
3. build the full-width model (Config() with use_con=False,
   no_caption=True: 132 feature channels, SA 2048/1024/512/256, 256
   proposals, BERT-base text mode over 6 layers) from a seed, with random
   BatchNorm statistics, and run one warm-up forward at B=8, N=40960;
4. hold each kernel against its plain PyTorch version at the shapes the
   main path gives it (FPS x5, ball query x5 with and without counts,
   three-NN x2, from that forward's own tensors), plus zero-padded rows,
   empty balls and the global-memory FPS path; time kernel, plain
   version and, for three-NN, torch.cdist + topk with CUDA events;
5. with every launch count at 0, serve three requests through
   GroundingPredictor (one batch; a list of two; occupancy 3 through
   run_padded), read the counts (FPS 5, ball query 5, three-NN 2 per
   forward), check the outputs, compare one forward against the same
   forward with the plain ops on the card (pred_ref equal, cluster_ref
   within 1e-4), and trace one request with torch.profiler (device time
   by kernel, device-busy share);
6. print {"kernels": [...]}, the card's name and power limit, and last
   {"ok": true, "device": {...}}.
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
    """Route the three kernel wrappers to their plain versions (for the
    plain-op reference forward on the card); restored on exit."""
    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    bq = importlib.import_module("vlp3d_torch.ops.ball_query")
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    saved = (smp._fps_cuda, bq._ball_query_cuda, itp._three_nn_cuda)

    def bq_plain(radius, nsample, xyz, new_xyz, with_count):
        idx, cnt = bq.ball_query_plain(radius, nsample, xyz, new_xyz)
        return idx, (cnt if with_count else None)

    smp._fps_cuda = smp.fps_plain
    bq._ball_query_cuda = bq_plain
    itp._three_nn_cuda = itp.three_nn_plain
    try:
        yield
    finally:
        smp._fps_cuda, bq._ball_query_cuda, itp._three_nn_cuda = saved


def check_kernels(torch, config, out):
    """Phase 4: every kernel against its plain version at main-path shapes."""
    from vlp3d_torch import ops
    from vlp3d_torch.ops.ball_query import ball_query_plain
    from vlp3d_torch.ops.interpolate import three_nn_plain
    from vlp3d_torch.ops.sampling import fps_plain

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
        nbytes = b * n * 12 + b * npoint * 4
        nops = (npoint - 1) * b * n * OPS_PER_TEST
        bms, by = bound_ms(nbytes, nops)
        # one block per row: npoint serial steps on one SM's fp32 rate
        serial = (npoint - 1) * n * OPS_PER_TEST / (FP32_FLOPS / SMS) * 1e3
        rows["fps"].append(dict(site=site, shape=[b, n, npoint], ms=k_ms,
                                plain_ms=p_ms, bound_ms=bms, bound_by=by,
                                serial_one_sm_ms=serial, max_abs_err=fps_err))

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

    # edge cases: zero-padded points and an all-zero row, empty balls,
    # and distances too many for shared memory (global scratch)
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
    big = torch.rand(2, 1 << 16, 3, device=xyz.device) * 6
    if not torch.equal(ops.furthest_point_sample(big, 64),
                       fps_plain(big, 64)):
        fail("fps: global-memory path differs from the plain version")
    torch.cuda.synchronize()
    print("[4] edge cases equal to plain: zero-padded rows, an all-zero row, "
          "empty balls, 65536-point FPS in global memory")

    for name, rs in rows.items():
        for r in rs:
            print(f"[4] {name} {json.dumps(r)}")
    return rows


def profile_request(torch, pred, scene, top: int = 15):
    """Trace one single-batch request with torch.profiler; print the device
    time by operator and the device-busy share of the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred([scene])  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred([scene])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies): an operator's own entry
    # repeats the time of the kernels it launched
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        print("[5] profile: the trace holds no device time (not measured)")
        return
    rows = [dict(op=e.key[:90], calls=e.count, device_ms=dev_us(e) / 1e3)
            for e in events[:top] if dev_us(e) > 0]
    print(f"[5] profile of one request: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of wall; idle share "
          f"{1 - busy_ms / wall_ms:.3f})")
    for r in rows:
        print(f"[5]   {r['device_ms']:9.3f} ms  x{r['calls']:<5d} {r['op']}")


def kernel_line(rows, launches):
    sources = {
        "fps": ("vlp3d_torch/csrc/fps.cu", "vlp3d/ops/sampling.py:60"),
        "ball_query": ("vlp3d_torch/csrc/ball_query.cu",
                       "vlp3d/ops/ball_query.py:33"),
        "three_nn": ("vlp3d_torch/csrc/three_nn.cu",
                     "vlp3d/ops/interpolate.py:16"),
    }
    kernels = []
    for name, rs in rows.items():
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
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            # one forward's calls of this kernel, summed over call sites
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if ops_bound >= bytes_bound else "bytes",
            "library_ms": None if None in lib else sum(lib),
        })
    return {"kernels": kernels}


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
    want = {"fps": 5 * forwards, "ball_query": 5 * forwards,
            "three_nn": 2 * forwards}
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
    profile_request(torch, pred, scenes[0])
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
    rows, launches = drive(torch, config, B, N, smi)

    # 6. results
    line = kernel_line(rows, launches)
    print(json.dumps(line))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
