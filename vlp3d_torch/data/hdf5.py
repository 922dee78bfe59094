"""The multiview hdf5 without h5py: a writer and a reader of the file
format's oldest layout.

``enet_feats_maxpool.hdf5`` holds one 2-D float32 dataset a scene in the
root group. Not every machine that runs the port has ``h5py``, so
:class:`DatasetWriter` writes that file itself, in the layout h5py
writes by default (HDF5 superblock version 0; the root group a symbol
table: a local heap of names, a version-1 B-tree with one leaf, one
symbol-table node; version-1 object headers; contiguous data), readable
by h5py and the HDF5 library. :func:`read_datasets` reads the files
:class:`DatasetWriter` writes, and no other layout, as memory-mapped
numpy arrays.

Every number is little-endian; offsets and lengths are 8 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
FREE_NULL = 1  # a local heap without a free block (the library's marker)
INTERNAL_K = 16  # the group B-tree's internal node K (the library default)
# message types of a version-1 object header
DATASPACE, DATATYPE, FILL, LAYOUT, CONTINUATION, SYMBOL_TABLE = (
    0x1, 0x3, 0x5, 0x8, 0x10, 0x11)


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _object_header(messages) -> bytes:
    """A version-1 object header of (type, data) messages, each padded
    to 8 bytes."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), 0) + _pad8(d)
                    for t, d in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _float32_type() -> bytes:
    """IEEE float32, little-endian: class 1 (floating point), version 1;
    sign bit 31, mantissa normalised (implied leading 1); bit offset 0,
    precision 32, exponent at 23 of 8 bits, mantissa at 0 of 23 bits,
    bias 127."""
    return (bytes([0x11, 0x20, 0x1F, 0x00]) + struct.pack("<I", 4)
            + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))


class DatasetWriter:
    """A new file at ``path`` whose root group gets one float32 dataset a
    call of :meth:`add`: each array's bytes are written as it comes (a
    scene's features need not wait for the others), the names, object
    headers and the superblock when the writer closes."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(bytes(96))  # the superblock, written on close
        self._entries = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add(self, name: str, array) -> None:
        if not name or "/" in name or "\0" in name or name in self._entries:
            raise ValueError(f"dataset name {name!r}")
        arr = np.ascontiguousarray(array, dtype="<f4")
        self._f.write(bytes(-self._f.tell() % 8))
        self._entries[name] = (arr.shape, self._f.tell(), arr.nbytes)
        self._f.write(arr.tobytes())

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            self._f.write(bytes(-self._f.tell() % 8))
            self._f.write(self._metadata(self._f.tell()))
            end = self._f.tell()
            self._f.seek(0)
            self._f.write(self._superblock(end))
        finally:
            self._f.close()

    def _metadata(self, base: int) -> bytes:
        """The dataset object headers, the root group's object header,
        local heap, B-tree and symbol-table node, laid out from ``base``."""
        names = sorted(self._entries)
        # the local heap's data segment: the empty name at 0, then each
        heap = bytearray(b"\0" * 8)
        offsets = []
        for n in names:
            offsets.append(len(heap))
            heap += _pad8(n.encode() + b"\0")
        self._leaf_k = max(4, -(-len(names) // 2))  # one node holds all
        out = bytearray()
        headers = []
        for n in names:
            shape, at, nbytes = self._entries[n]
            dims = b"".join(struct.pack("<Q", d) for d in shape)
            headers.append(base + len(out))
            out += _object_header([
                (DATASPACE, struct.pack("<BBBB4x", 1, len(shape), 0, 0)
                 + dims),
                (DATATYPE, _float32_type()),
                # version 2: late allocation, fill if set, the default (0)
                (FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0)),
                (LAYOUT, struct.pack("<BBQQ", 3, 1, at, nbytes))])
        self._heap = base + len(out)
        heap_data = self._heap + 32
        self._btree = heap_data + len(heap)
        snod = self._btree + 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8
        self._root = snod + 8 + 2 * self._leaf_k * 40
        out += (b"HEAP" + bytes(4)
                + struct.pack("<QQQ", len(heap), FREE_NULL, heap_data) + heap)
        btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF)
                 + struct.pack("<QQQ", 0, snod, offsets[-1] if names else 0))
        out += btree + bytes(snod - self._btree - len(btree))
        entries = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
            struct.pack("<QQII16x", off, at, 0, 0)
            for off, at in zip(offsets, headers))
        out += entries + bytes(self._root - snod - len(entries))
        out += _object_header([(SYMBOL_TABLE, struct.pack(
            "<QQ", self._btree, self._heap))])
        return bytes(out)

    def _superblock(self, end: int) -> bytes:
        return (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", self._leaf_k, INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, UNDEF, end, UNDEF)
                + struct.pack("<QQII", 0, self._root, 1, 0)
                + struct.pack("<QQ", self._btree, self._heap))


def read_datasets(path: str) -> dict:
    """{name: array} of the root group of a file :class:`DatasetWriter`
    wrote, and of no other layout: superblock 0, a symbol-table root group
    whose B-tree is one leaf over one symbol-table node, version-1 object
    headers without continuation blocks, contiguous little-endian float32
    data. Each array is a read-only view of one ``np.memmap`` of the
    file, so a dataset's bytes are read only when it is used."""
    with open(path, "rb") as f:
        def read(at, n):
            f.seek(at)
            b = f.read(n)
            if len(b) != n:
                raise ValueError(f"{path}: {n} bytes at {at} past the end")
            return b

        sb = read(0, 96)
        if sb[:8] != SIGNATURE or sb[8] != 0:
            raise ValueError(f"{path}: not an hdf5 file with superblock 0")
        if sb[13:15] != b"\x08\x08":
            raise ValueError(f"{path}: offsets and lengths are not 8 bytes")
        btree, heap = struct.unpack_from("<QQ", sb, 80)
        h = read(heap, 32)
        if h[:4] != b"HEAP":
            raise ValueError(f"{path}: no local heap at {heap}")
        heap_size, _, heap_data = struct.unpack_from("<QQQ", h, 8)
        names = read(heap_data, heap_size)
        node = read(btree, 40)
        if node[:4] != b"TREE":
            raise ValueError(f"{path}: no B-tree node at {btree}")
        level, used = node[5], struct.unpack_from("<H", node, 6)[0]
        if level or used != 1:
            raise ValueError(f"{path}: a group B-tree of {used} children at "
                             f"level {level}, not the one leaf "
                             "DatasetWriter writes")
        snod = struct.unpack_from("<Q", node, 32)[0]
        head = read(snod, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"{path}: no symbol-table node at {snod}")
        count = struct.unpack_from("<H", head, 6)[0]
        entries = read(snod + 8, 40 * count)
        located = {}
        for j in range(count):
            off, header = struct.unpack_from("<QQ", entries, 40 * j)
            name = names[off:names.index(b"\0", off)].decode()
            located[name] = _dataset(read, header, path)
    if not located:
        return {}
    mm = np.memmap(path, np.uint8, mode="r")
    return {name: mm[at:at + 4 * int(np.prod(shape))].view("<f4")
            .reshape(shape) for name, (shape, at) in located.items()}


def _dataset(read, header, path):
    """(shape, data offset) of the float32 dataset whose object header
    is at ``header``."""
    version, _, n, _, size = struct.unpack_from("<BBHII", read(header, 16))
    if version != 1:
        raise ValueError(f"{path}: object header version {version} at "
                         f"{header}")
    body = read(header + 16, size)
    shape = layout = None
    pos = 0
    for _ in range(n):
        t, s = struct.unpack_from("<HH", body, pos)
        d = body[pos + 8:pos + 8 + s]
        pos += 8 + s
        if t == CONTINUATION:
            raise ValueError(f"{path}: object header at {header} continues "
                             "elsewhere, which DatasetWriter never writes")
        if t == DATASPACE:
            shape = struct.unpack_from(f"<{d[1]}Q", d, 8)
        elif t == DATATYPE and d[:20] != _float32_type():
            raise ValueError(f"{path}: object at {header} is not "
                             "little-endian float32")
        elif t == LAYOUT:
            if d[0] != 3 or d[1] != 1:
                raise ValueError(f"{path}: layout {d[0]}/{d[1]} is not "
                                 "version 3 contiguous")
            layout = struct.unpack_from("<Q", d, 2)[0]
    if shape is None or layout is None:
        raise ValueError(f"{path}: object at {header} is not a dataset")
    return shape, layout
