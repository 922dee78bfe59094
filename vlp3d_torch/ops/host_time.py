"""Host time of one call of each kernel wrapper, on one CUDA card.

    python -m vlp3d_torch.ops.host_time [--profile]

A train step makes thousands of launches and waits on the host, so the
microseconds a wrapper spends before its launch are part of every step.
This times each public op over 1000 unsynchronised calls on arguments
small enough that the device keeps up (the host clock then reads the
wrapper, not the kernel), next to ``torch.index_select``, the one library
call that computes a K = 1 gather. It uses the public ops only, so it
also runs against another checkout of the package (put that checkout
first on ``PYTHONPATH`` and run this file by path). ``--profile`` adds a
cProfile of ``gather_points``, sorted by own time.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import subprocess
import sys
import time

import torch

from vlp3d_torch import ops


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds of one call of fn: the host clock over ``calls``
    calls that nothing synchronises."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("host_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    xyz = (torch.rand(8, 512, 3, generator=g) * 4).to(dev)
    idx = torch.randint(0, 512, (8, 256), generator=g,
                        dtype=torch.int32).to(dev)
    idx3 = torch.randint(0, 512, (8, 256, 16), generator=g,
                         dtype=torch.int32).to(dev)
    feats = torch.randn(8, 512, 128, generator=g).to(dev)
    learn = feats.clone().requires_grad_(True)
    tiny = xyz[:1, :64].contiguous()
    ctr = tiny[:, :8].contiguous()
    ctr_feats = torch.randn(1, 8, 256, generator=g).to(dev)
    table = xyz.reshape(-1, 3)
    flat = (idx.long() + torch.arange(8, device=dev)[:, None] * 512).reshape(-1)
    cases = {
        "gather_points (8, 512, 3) K=1": lambda: ops.gather_points(xyz, idx),
        "index_select, same rows": lambda: torch.index_select(table, 0, flat),
        "group_points (8, 512, 128) K=16": lambda: ops.group_points(feats,
                                                                    idx3),
        "group_points, table needs a gradient": lambda: ops.group_points(
            learn, idx3),
        "furthest_point_sample (1, 64, 3) -> 2":
            lambda: ops.furthest_point_sample(tiny, 2),
        "ball_query (1, 64, 3) x 8": lambda: ops.ball_query(0.3, 4, tiny, ctr),
        "three_nn (1, 64, 3) x 8": lambda: ops.three_nn(tiny, ctr),
        "interpolate_features (1, 64, 3) x 8, C=256":
            lambda: ops.interpolate_features(tiny, ctr, ctr_feats),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {name: host_us(fn) for name, fn in cases.items()}
    print(json.dumps({"host_us": out, "package": ops.__file__, "card": smi}))
    if "--profile" in sys.argv[1:]:
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(5000):
            ops.gather_points(xyz, idx)
        prof.disable()
        torch.cuda.synchronize()
        pstats.Stats(prof).sort_stats("tottime").print_stats(18)
    return 0


if __name__ == "__main__":
    sys.exit(main())
