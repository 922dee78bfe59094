"""Build and load the hand-written CUDA kernels under ``vlp3d_torch/csrc``.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
its own shared library at first use; all sources compile at once, one
``nvcc`` process each. A library's file name carries a hash of its source,
of the headers under ``csrc`` (``fps_regs.cuh``, which ``fps.cu`` and
``point_parallel.cu`` share) and of ``NVCC_FLAGS``, so a change to any of
them builds it anew. Libraries go
to ``$VLP3D_TORCH_BUILD_DIR`` when that is set, else to
``build/vlp3d_torch/`` one level above the package: the repository's
ignored ``build/`` in a source checkout (an installed copy should set the
variable). Libraries load with ``ctypes``: pointers and the stream go over as ``c_void_p``, and every C
entry point returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception.

``launches`` counts the launches of each kernel (a source may hold more
than one: ``grouping.cu`` has the gather, its scatter-add backward and the
three-NN interpolation's backward; ``point_parallel.cu`` the point-axis
FPS loop, the ball-query merge and the owned-rows gather; ``voxelize.cu``
dynamic and hard voxelization; ``iou3d.cu`` the rotated BEV overlap / IoU
and NMS),
so a run can show that its main path went through the kernels.

A wrapper's host time is part of every call (a train step makes
thousands of launches and waits on the host), so what a call needs is
resolved once: :func:`function` caches each C entry point,
:func:`stream_ptr` reads the current stream's handle without building a
``torch.cuda.Stream``, and :func:`on_device` is a device guard only when
the tensor's device is not the current one.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "VLP3D_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[2] / "build" / "vlp3d_torch"))
SOURCES = ("fps", "ball_query", "three_nn", "grouping", "point_parallel",
           "voxelize", "iou3d")
# kernels with a launch counter; each wrapper adds one where it launches
KERNELS = ("fps", "ball_query", "three_nn", "group_points",
           "group_points_grad", "three_interpolate_grad", "fps_shard_loop",
           "ball_query_merge", "gather_owned", "dynamic_voxelize",
           "hard_voxelize", "boxes_iou_bev", "nms_bev")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # index parity: no FMA contraction of d2 (the sources also spell
    # it with __fmul_rn/__fadd_rn)
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong, ctypes.c_ulonglong)
# C entry points of each source: symbol -> argument types (all return int)
SIGNATURES = {
    "fps": {
        "vlp3d_fps": [_P, _I, _I, _I, _P, _P, _P],
        "vlp3d_fps_regs": [_P, _I, _I, _I, _P, _I, _I, _P],
        "vlp3d_fps_max_clusters": [_I, _I, _I],
    },
    "ball_query": {
        "vlp3d_ball_query": [_P, _P, _I, _I, _I, _F, _I, _P, _P, _P],
        "vlp3d_ball_query_tile": [_P, _P, _I, _I, _I, _F, _I, _P, _P, _I,
                                  _I, _I, _P],
    },
    "three_nn": {
        "vlp3d_three_nn": [_P, _P, _I, _I, _I, _P, _P, _P],
        "vlp3d_three_nn_team": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                                _P, _P, _P, _P],
    },
    "grouping": {
        "vlp3d_group_points": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _P,
                               _P],
        "vlp3d_group_points_grad": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
        "vlp3d_group_points_grad_sorted": [_P, _P, _I, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _P, _P],
        "vlp3d_three_interpolate_grad": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _I, _P, _P],
    },
    "point_parallel": {
        "vlp3d_fps_shard_loop": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _U, _F, _P, _P, _P],
        "vlp3d_fps_shard_loop_max_clusters": [_I, _I, _I],
        "vlp3d_pci_bus_id": [_I, _P, _I],
        "vlp3d_ipc_handle": [_P, _P],
        "vlp3d_ipc_open": [_P, _P],
        "vlp3d_ball_query_merge": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
        "vlp3d_gather_owned": [_P, _P, _I, _I, _L, _I, _I, _P, _P],
    },
    "voxelize": {
        "vlp3d_dynamic_voxelize": [_P, _L, _I, _F, _F, _F, _F, _F, _F, _I,
                                   _I, _I, _P, _P],
        "vlp3d_hard_voxelize": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                _P, _P, _P, _P, _P, _P, _P],
    },
    "iou3d": {
        "vlp3d_iou_bev": [_P, _P, _I, _I, _I, _P, _P, _P],
        "vlp3d_nms_bev": [_P, _P, _I, _F, _P, _P, _P, _P],
    },
}

launches = {name: 0 for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}
_lock = threading.Lock()
_SAME_DEVICE = contextlib.nullcontext()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    """The library of source ``name``, named by a hash of the source's
    contents, the shared headers' and the compiler flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> dict[str, str]:
    """Compile every missing kernel library in parallel (every one when
    ``force``); return each compiled source's ptxas report (registers,
    shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src, lib = CSRC / f"{name}.cu", lib_path(name)
        if not force and lib.exists():
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built on first use."""
    with _lock:
        if name not in _libs:
            build()
            lib = ctypes.CDLL(str(lib_path(name)))
            for symbol, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def function(source: str, symbol: str):
    """C entry point ``symbol`` of kernel source ``source``; the library
    is built and loaded at the first request, the lookup is cached."""
    fn = _functions.get((source, symbol))
    if fn is None:
        fn = _functions[(source, symbol)] = getattr(library(source), symbol)
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream of ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t: torch.Tensor):
    """Context that makes ``t``'s device current: nothing to enter when it
    already is."""
    if t.device.index == torch._C._cuda_getDevice():
        return _SAME_DEVICE
    return torch.cuda.device(t.device)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            last: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given form."""
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_or_cpu(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel path), False for a CPU tensor
    (plain path); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
