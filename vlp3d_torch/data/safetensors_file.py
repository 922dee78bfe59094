"""A reader of the ``.safetensors`` format that needs no ``safetensors``
package: the card's machine has none, and an HF BERT directory may hold
only ``model.safetensors``.

The format: an 8-byte little-endian header length N, N bytes of a JSON
header mapping each tensor's name to its ``dtype``, ``shape`` and
``data_offsets`` [begin, end) (bytes from the end of the header; an
optional ``__metadata__`` entry is skipped), then the tensors' raw
little-endian bytes.
"""

from __future__ import annotations

import json
import struct

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict:
    """{name: CPU tensor} of a ``.safetensors`` file, in the header's
    order. Raises ValueError, naming the tensor, for a dtype not in
    :data:`DTYPES`, a byte count that is not the shape's, an offset past
    the end of the file (a truncated file) or two tensors whose bytes
    overlap."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: {len(raw)} bytes, no header length")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header of {n} bytes past the end of the "
                         f"{len(raw)}-byte file")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    data = memoryview(raw)[8 + n:]
    entries = [(k, v) for k, v in header.items() if k != "__metadata__"]
    spans = []
    for name, meta in entries:
        dtype = DTYPES.get(meta.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{meta.get('dtype')!r}, not one of "
                             f"{sorted(DTYPES)}")
        begin, end = (int(x) for x in meta["data_offsets"])
        shape = [int(s) for s in meta["shape"]]
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end or end - begin != numel * itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans [{begin}, "
                             f"{end}) for {numel} x {itemsize} bytes")
        if end > len(data):
            raise ValueError(f"{path}: tensor {name!r} ends at byte {end} "
                             f"of a {len(data)}-byte buffer (truncated)")
        spans.append((begin, end, name, dtype, shape))
    last_end, last_name = 0, None
    for begin, end, name, _, _ in sorted(spans):
        if begin < last_end:
            raise ValueError(f"{path}: tensor {name!r} overlaps "
                             f"{last_name!r}")
        if end > begin:
            last_end, last_name = end, name
    out = {}
    for begin, end, name, dtype, shape in spans:
        buf = bytearray(data[begin:end])
        out[name] = (torch.frombuffer(buf, dtype=dtype).reshape(shape)
                     if buf else torch.empty(shape, dtype=dtype))
    return out
