"""Native host-side loader kernels (C, loaded with ctypes).

The port's own copy of ``vlp3d/native``: ``loader.c`` is the same C code,
built with the same flags (``-O3 -ffp-contract=off``: the fused gather
and augmentation must round exactly like the numpy augment chain, with
no a*b+c contraction). The library is compiled with ``cc`` at first use
into the kernels' build directory (``$VLP3D_TORCH_BUILD_DIR``, else the
repository's ``build/vlp3d_torch/``), named by a hash of the source and
the flags, as ``ops/_kernels.py`` names the CUDA libraries.

:func:`build` raises when no compiler builds it; :func:`native_available`
is False then, and the dataset takes its numpy path (the parity tests
run both). A run that must have the native path (``chip_smoke.py``)
calls :func:`build` itself, so a failed build fails it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from vlp3d_torch.ops._kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "loader.c"
CC_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-pthread")

_LIB = None
_TRIED = False
_lock = threading.Lock()


def lib_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(CC_FLAGS).encode())
    return BUILD_DIR / f"libloader.{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile loader.c unless its library exists; raise with the
    compilers' output when none of cc, gcc, clang builds it."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libloader.{os.getpid()}.{threading.get_ident()}.tmp.so"
    errors = []
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, text=True)
        except OSError as e:
            errors.append(f"{cc}: {e}")
            continue
        except subprocess.CalledProcessError as e:
            errors.append(f"{cc} (rc {e.returncode}): {e.stderr}")
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError("the native loader library did not build:\n"
                       + "\n".join(errors))


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _lock:
        if _TRIED:
            return _LIB
        try:
            path = build()
        except RuntimeError:
            _TRIED = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.compute_votes.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.gather_rows_i64.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gather_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.gather_augment_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_float, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_float,
        ]
        lib.compute_votes_tiled.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.vlp3d_buf_acquire.argtypes = [ctypes.c_size_t]
        lib.vlp3d_buf_acquire.restype = ctypes.c_void_p
        lib.vlp3d_buf_release.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.vlp3d_buf_release.restype = None
        _LIB = lib
        _TRIED = True
        return _LIB


def native_available() -> bool:
    return _load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def compute_votes(
    points: np.ndarray,  # (N, >=3) f32, xyz first
    instance_labels: np.ndarray,  # (N,) int
    semantic_ok: np.ndarray,  # (N,) bool: label in the detection set
):
    """Single-pass GT vote regeneration. Returns (votes (N,3) f32,
    mask (N,) f32)."""
    lib = _load()
    n = points.shape[0]
    points = np.ascontiguousarray(points, np.float32)
    instance_labels = np.ascontiguousarray(instance_labels, np.int64)
    sem_ok = np.ascontiguousarray(semantic_ok, np.uint8)
    votes = np.zeros((n, 3), np.float32)
    mask = np.zeros((n,), np.float32)
    lib.compute_votes(_f32p(points), points.shape[1], n,
                      _i64p(instance_labels), _u8p(sem_ok), _f32p(votes),
                      _f32p(mask))
    return votes, mask


def gather_augment_rows(
    scene_pc: np.ndarray,  # (N_raw, C_raw) f32 C-contiguous
    choices: np.ndarray,  # (n,) int64
    out: np.ndarray,  # (n, C_out >= C_raw) f32, a batch-buffer slot view
    *,
    params=None,  # augment.AugmentParams or None (no augmentation)
    use_height: bool = False,
    floor_height: float = 0.0,
) -> None:
    """Fused sample-gather + augment + height channel, one C pass.

    Bit-identical to a plain row gather, then the numpy augment chain
    (:func:`vlp3d_torch.data.augment.apply_augment_points`) on the
    xyz / col-3 columns, then the height write (loader.c:
    gather_augment_rows holds the rounding contract)."""
    lib = _load()
    assert scene_pc.dtype == np.float32 and scene_pc.flags.c_contiguous
    assert out.dtype == np.float32 and out.strides[1] == 4
    choices = np.ascontiguousarray(choices, np.int64)
    if params is not None:
        rot = np.ascontiguousarray(params.rot, np.float64)
        scale = np.ascontiguousarray(params.scale, np.float64)
        trans = np.ascontiguousarray(params.trans, np.float64)
        s22 = np.float32(float(params.scale[2, 2]))
        flip0, flip1 = int(params.flip0), int(params.flip1)
        aug = 1
    else:
        rot = scale = np.zeros((3, 3), np.float64)
        trans = np.zeros((3,), np.float64)
        s22 = np.float32(0)
        flip0 = flip1 = aug = 0
    lib.gather_augment_rows(
        _f32p(scene_pc), scene_pc.shape[1], _i64p(choices),
        choices.shape[0], scene_pc.shape[1], _f32p(out),
        out.strides[0] // 4, out.shape[1], aug, flip0, flip1,
        _f64p(rot), _f64p(scale), s22, _f64p(trans),
        int(use_height), np.float32(floor_height),
    )


def gather_i64(src: np.ndarray, choices: np.ndarray, out: np.ndarray) -> None:
    lib = _load()
    src = np.ascontiguousarray(src, np.int64)
    choices = np.ascontiguousarray(choices, np.int64)
    assert out.dtype == np.int64 and out.flags.c_contiguous
    lib.gather_rows_i64(_i64p(src), _i64p(choices), choices.shape[0],
                        _i64p(out))


def gather_u8(src: np.ndarray, choices: np.ndarray) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(src, np.uint8)
    choices = np.ascontiguousarray(choices, np.int64)
    out = np.empty(choices.shape[0], np.uint8)
    lib.gather_u8(_u8p(src), _i64p(choices), choices.shape[0], _u8p(out))
    return out


class _NativeBuffer:
    """A recycled mmap buffer from the C free list. numpy arrays built on
    it keep it alive through their base chain; when the last view dies the
    buffer returns to the pool, even if a zero-copy consumer
    (``torch.from_numpy``) held a reference past the loader's loop."""

    def __init__(self, size: int):
        lib = _load()
        self._size = size
        self._addr = lib.vlp3d_buf_acquire(size)
        if not self._addr:
            raise MemoryError(f"vlp3d_buf_acquire({size}) failed")

    @property
    def __array_interface__(self):
        return {
            "version": 3,
            "typestr": "|u1",
            "shape": (self._size,),
            "data": (self._addr, False),
        }

    def __del__(self):
        lib = _LIB
        addr = getattr(self, "_addr", None)
        if lib is not None and addr:
            try:
                lib.vlp3d_buf_release(ctypes.c_void_p(addr), self._size)
            except Exception:
                pass  # interpreter shutdown


def alloc_array(shape, dtype) -> np.ndarray:
    """np.empty backed by the recycled native buffer pool, for the large
    per-batch arrays whose fresh-allocation page faults dominate loader
    time (loader.c)."""
    dtype = np.dtype(dtype)
    size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    buf = _NativeBuffer(max(size, 1))
    a = np.asarray(buf)
    return a[:size].view(dtype).reshape(shape)


def compute_votes_tiled(
    points: np.ndarray,  # (n, C) f32, xyz first; row stride = C (a slot view)
    instance_labels: np.ndarray,  # (n,) int64
    semantic_ok: np.ndarray,  # (n,) uint8
    votes_out: np.ndarray,  # (n, 9) f32, a batch-buffer slot
    mask_out: np.ndarray,  # (n,) int64, a batch-buffer slot
) -> None:
    """compute_votes + the x3 vote tiling + int64 mask, written in place
    (dataset.py:669-679 semantics; loader.c)."""
    lib = _load()
    assert points.dtype == np.float32 and points.strides[1] == 4
    assert votes_out.dtype == np.float32 and votes_out.strides[1] == 4
    assert mask_out.dtype == np.int64 and mask_out.flags.c_contiguous
    instance_labels = np.ascontiguousarray(instance_labels, np.int64)
    semantic_ok = np.ascontiguousarray(semantic_ok, np.uint8)
    lib.compute_votes_tiled(
        _f32p(points), points.strides[0] // 4, points.shape[0],
        _i64p(instance_labels), _u8p(semantic_ok), _f32p(votes_out),
        votes_out.strides[0] // 4, _i64p(mask_out),
    )
