"""Zero-dependency TensorBoard scalar event writer.

The port's own copy of ``vlp3d/utils/tb_writer.py``. It stands in for
the reference's tensorboardX dual train/val writers
(lib/joint/solver_3dvlp.py:214-221, 485-529) with no dependency: TB
event files are TFRecords (length + masked-crc32c framing) of
hand-encoded `Event` protobufs, and scalar summaries need only 3 proto
message types, written here directly in protobuf wire format.

Readable by standard TensorBoard (`tensorboard --logdir ...`).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encode
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value & (1 << 64) - 1)


def _scalar_event(tag: str, value: float, step: int, wall: float) -> bytes:
    # Summary.Value{tag=1, simple_value=2}
    sval = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, sval)  # Summary{value=1 repeated}
    # Event{wall_time=1, step=2, summary=5}
    return (
        _field_double(1, wall)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _version_event(wall: float) -> bytes:
    # Event{wall_time=1, file_version=3}
    return _field_double(1, wall) + _field_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Minimal TB writer: `add_scalar(tag, value, step)` + `flush`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._logdir = logdir
        fname = "events.out.tfevents.%d.%s" % (
            int(time.time()),
            socket.gethostname(),
        )
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_record(_version_event(time.time()))
        # scalar history for export_scalars_to_json (tensorboardX parity:
        # the reference exports all_scalars.json at _finish,
        # solver_3dvlp.py:1242-1245)
        self._history: dict = {}

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        wall = time.time()
        self._write_record(_scalar_event(tag, float(value), int(step), wall))
        self._history.setdefault(tag, []).append(
            [wall, int(step), float(value)]
        )

    def add_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(prefix + k, v, step)

    def flush(self) -> None:
        self._f.flush()

    def export_scalars_to_json(self, path: str | None = None) -> str:
        """Dump the full scalar history as tensorboardX-style
        {tag: [[wall_time, step, value], ...]} json (the reference's
        all_scalars.json export, solver_3dvlp.py:1242-1245)."""
        import json

        path = path or os.path.join(self._logdir, "all_scalars.json")
        with open(path, "w") as f:
            json.dump(self._history, f)
        return path

    def close(self) -> None:
        self._f.close()
