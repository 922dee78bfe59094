"""The multiview hdf5 without h5py: a writer of the file format's oldest
layout and a reader of the layouts h5py writes.

``enet_feats_maxpool.hdf5`` holds one 2-D float32 dataset a scene in the
root group. Not every machine that runs the port has ``h5py``, so
:class:`DatasetWriter` writes that file itself, in the layout h5py
writes by default (HDF5 superblock version 0; the root group a symbol
table: a local heap of names, a version-1 B-tree with one leaf, one
symbol-table node; version-1 object headers; contiguous data), readable
by h5py and the HDF5 library. :func:`read_datasets` reads those files
and the ones h5py writes, with its default layout or with
``libver="latest"``, as memory-mapped numpy arrays.

Every number is little-endian; offsets and lengths are 8 bytes.
"""

from __future__ import annotations

import bisect
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
    """{name: array} of the float32 datasets in the root group of an
    hdf5 file, sorted by name, each a read-only view of one
    ``np.memmap`` of the file (a dataset's bytes are read only when it
    is used).

    It reads the layouts h5py writes for such a file:

    - h5py's default: superblock 0 or 1, the root group a symbol table
      (a version-1 B-tree of any number of levels over symbol-table
      nodes, names in a local heap), version-1 object headers and their
      continuation blocks;
    - ``libver="latest"``: superblock 2 or 3, version-2 (``OHDR``)
      object headers and their ``OCHK`` continuation chunks; the root
      group's links are link messages in its header (compact storage)
      or, past eight links, objects of a fractal heap (dense storage),
      found through the link-name index (a version-2 B-tree of heap IDs)
      and read from the heap's direct blocks under its root direct or
      indirect block.

    A dataset must be stored contiguously as little-endian IEEE float32;
    any other layout (chunked, compressed, compact, external) or type
    raises ``ValueError`` naming the dataset. Checksums (superblock 2/3,
    ``OHDR``, ``OCHK``, the heap's and the B-tree's blocks) are not
    checked: every structure is found by its signature and offsets, and
    a read past the end of the file raises."""
    with open(path, "rb") as f:
        hdf = _File(f, path)
        links = hdf.root_links()
        located = {name: hdf.dataset(name, links[name])
                   for name in sorted(links)}
    mm = np.memmap(path, np.uint8, mode="r")
    return {name: (mm[at:at + nbytes].view("<f4").reshape(shape) if nbytes
                   else np.zeros(shape, "<f4"))
            for name, (shape, at, nbytes) in located.items()}


# message types of object headers beyond the writer's own
LINK_INFO, LINK, EXTERNAL, FILTERS = 0x2, 0x6, 0x7, 0xB
_LAYOUTS = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}


def _uint(b: bytes, at: int, size: int) -> int:
    return int.from_bytes(b[at:at + size], "little")


def _limit_enc_size(n: int) -> int:
    """Bytes of a count up to ``n`` in a version-2 B-tree node (the
    library's H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


class _File:
    """The structures of one open hdf5 file that lead from the
    superblock to the root group's datasets."""

    def __init__(self, f, path: str):
        self.f, self.path = f, path

    def read(self, at: int, n: int) -> bytes:
        if at == UNDEF:
            raise ValueError(f"{self.path}: an undefined address")
        self.f.seek(at)
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError(f"{self.path}: {n} bytes at {at} past the end")
        return b

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def expect(self, at: int, signature: bytes, n: int) -> bytes:
        b = self.read(at, n)
        if b[:4] != signature:
            self.fail(f"no {signature.decode()} at {at}")
        return b

    # the superblock and object headers

    def root_links(self) -> dict:
        """{name: object header address} of the root group's links."""
        sb = self.read(0, 48)
        if sb[:8] != SIGNATURE:
            self.fail("not an hdf5 file (no signature at 0)")
        version = sb[8]
        if version in (0, 1):
            sizes = sb[13:15]
            # superblock 1 adds the indexed-storage K and 2 reserved bytes
            root = 64 + 4 * version
        elif version in (2, 3):
            sizes, root = sb[9:11], 36
        else:
            self.fail(f"superblock version {version}")
        if sizes != b"\x08\x08":
            self.fail("offsets and lengths are not 8 bytes")
        root = struct.unpack_from("<Q", self.read(root, 8))[0]
        return self.group_links(root, "/")

    def messages(self, at: int, what: str) -> list:
        """[(type, data)] of the object header at ``at``, version 1 or
        2, continuation blocks included."""
        if self.read(at, 4) == b"OHDR":
            return self._messages_v2(at, what)
        version, _, n, _, size = struct.unpack_from("<BBHII",
                                                    self.read(at, 16))
        if version != 1:
            self.fail(f"{what}: object header version {version} at {at}")
        out, chunks = [], [(at + 16, size)]
        while chunks:
            start, size = chunks.pop(0)
            body, pos = self.read(start, size), 0
            while pos + 8 <= size:
                t, s = struct.unpack_from("<HH", body, pos)
                d = body[pos + 8:pos + 8 + s]
                pos += 8 + s
                if t == CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", d))
                elif t:
                    out.append((t, d))
        return out

    def _messages_v2(self, at: int, what: str) -> list:
        head = self.read(at, 6 + 16 + 4 + 8)
        if head[4] != 2:
            self.fail(f"{what}: OHDR version {head[4]} at {at}")
        flags, pos = head[5], 6
        if flags & 0x20:
            pos += 16  # access, modification, change and birth times
        if flags & 0x10:
            pos += 4  # attribute phase-change values
        width = 1 << (flags & 3)
        size = _uint(head, pos, width)
        # type (1), size (2), flags (1), creation order (2) if tracked
        prefix = 6 if flags & 0x4 else 4
        out, chunks = [], [(at + pos + width, size)]
        while chunks:
            start, size = chunks.pop(0)
            body, pos = self.read(start, size), 0
            while pos + prefix <= size:
                t, s = body[pos], struct.unpack_from("<H", body, pos + 1)[0]
                d = body[pos + prefix:pos + prefix + s]
                pos += prefix + s
                if t == CONTINUATION:
                    addr, length = struct.unpack_from("<QQ", d)
                    self.expect(addr, b"OCHK", 4)
                    # the chunk's signature and checksum around its messages
                    chunks.append((addr + 4, length - 8))
                elif t:
                    out.append((t, d))
        return out

    # groups

    def group_links(self, at: int, what: str) -> dict:
        msgs = self.messages(at, what)
        links = {}
        for t, d in msgs:
            if t == SYMBOL_TABLE:
                btree, heap = struct.unpack_from("<QQ", d)
                links.update(self._symbol_table(btree, heap))
            elif t == LINK:
                name, addr = self._link(d)
                links[name] = addr
            elif t == LINK_INFO:  # after the creation index, if tracked
                heap, names = struct.unpack_from("<QQ", d,
                                                 10 if d[1] & 1 else 2)
                if heap != UNDEF:
                    links.update(self._dense_links(heap, names))
        return links

    def _symbol_table(self, btree: int, heap: int) -> dict:
        """Links of an old-style group: its version-1 B-tree (any
        number of levels) down to the symbol-table nodes."""
        h = self.expect(heap, b"HEAP", 32)
        size, _, data = struct.unpack_from("<QQQ", h, 8)
        names = self.read(data, size)
        links, nodes = {}, [btree]
        while nodes:
            node = nodes.pop()
            head = self.expect(node, b"TREE", 24)
            if head[4] != 0:
                self.fail(f"B-tree node at {node} is not a group node")
            level, used = head[5], struct.unpack_from("<H", head, 6)[0]
            # key 0, child 0, key 1, child 1, ..., key `used`
            body = self.read(node + 24, 16 * used + 8)
            children = [struct.unpack_from("<Q", body, 16 * i + 8)[0]
                        for i in range(used)]
            if level:
                nodes.extend(children)
                continue
            for snod in children:
                count = struct.unpack_from(
                    "<H", self.expect(snod, b"SNOD", 8), 6)[0]
                entries = self.read(snod + 8, 40 * count)
                for j in range(count):
                    off, header, cache = struct.unpack_from(
                        "<QQI", entries, 40 * j)
                    name = names[off:names.index(b"\0", off)].decode()
                    if cache == 2:
                        self.fail(f"{name}: a soft link, not a hard link")
                    links[name] = header
        return links

    def _link(self, d: bytes) -> tuple:
        """(name, object header address) of a link message."""
        if d[0] != 1:
            self.fail(f"link message version {d[0]}")
        flags, pos, kind = d[1], 2, 0
        if flags & 0x8:
            kind, pos = d[pos], pos + 1
        if flags & 0x4:
            pos += 8  # creation order
        if flags & 0x10:
            pos += 1  # name character set
        width = 1 << (flags & 3)
        length = _uint(d, pos, width)
        pos += width
        name = d[pos:pos + length].decode()
        if kind != 0:
            self.fail(f"{name}: a link of type {kind}, not a hard link")
        return name, struct.unpack_from("<Q", d, pos + length)[0]

    def _dense_links(self, heap: int, btree: int) -> dict:
        """Links of a new-style group in dense storage: each heap ID in
        the link-name index (a version-2 B-tree) located in the fractal
        heap's direct blocks."""
        h = self.expect(heap, b"FRHP", 142)
        id_len, filter_len = struct.unpack_from("<HH", h, 5)
        if filter_len:
            self.fail(f"fractal heap at {heap} has I/O filters")
        width = struct.unpack_from("<H", h, 110)[0]
        start, max_direct = struct.unpack_from("<QQ", h, 112)
        max_bits = struct.unpack_from("<H", h, 128)[0]
        root = struct.unpack_from("<Q", h, 132)[0]
        rows = struct.unpack_from("<H", h, 140)[0]
        max_managed = struct.unpack_from("<I", h, 10)[0]
        off_size = (max_bits + 7) // 8
        len_size = min((max_direct.bit_length() - 1 + 7) // 8,
                       _limit_enc_size(max_managed))
        # direct blocks: (offset in the heap's space, file address)
        blocks = []
        if root != UNDEF:
            self._heap_blocks(root, rows, blocks, width, start, max_direct,
                              off_size)
        blocks.sort()
        starts = [b[0] for b in blocks]
        links = {}
        for rec in self._btree2_records(btree, id_len):
            kind = (rec[4] >> 4) & 0x3
            if kind != 0:
                self.fail(f"link stored as a {('huge', 'tiny')[kind - 1]}"
                          " heap object")
            off = _uint(rec, 5, off_size)
            length = _uint(rec, 5 + off_size, len_size)
            i = bisect.bisect_right(starts, off) - 1
            if i < 0:
                self.fail(f"heap offset {off} before every direct block")
            name, addr = self._link(self.read(
                blocks[i][1] + off - starts[i], length))
            links[name] = addr
        return links

    def _heap_blocks(self, at, rows, blocks, width, start, max_direct,
                     off_size) -> None:
        if rows == 0:  # the root is a direct block
            head = self.expect(at, b"FHDB", 13 + off_size)
            blocks.append((_uint(head, 13, off_size), at))
            return
        self.expect(at, b"FHIB", 13 + off_size)
        entries = self.read(at + 13 + off_size, 8 * rows * width)
        direct_rows = (max_direct.bit_length() - start.bit_length()) + 2
        for r in range(rows):
            for c in range(width):
                child = struct.unpack_from("<Q", entries,
                                           8 * (r * width + c))[0]
                if child == UNDEF:
                    continue
                if r < direct_rows:
                    self._heap_blocks(child, 0, blocks, width, start,
                                      max_direct, off_size)
                else:
                    size = start << (r - 1)
                    child_rows = (size.bit_length()
                                  - (start * width).bit_length()) + 1
                    self._heap_blocks(child, child_rows, blocks, width,
                                      start, max_direct, off_size)

    def _btree2_records(self, at: int, id_len: int) -> list:
        """Every record of the version-2 B-tree at ``at`` (records sit
        in internal nodes and leaves)."""
        h = self.expect(at, b"BTHD", 38)
        node_size, rec_size, depth = struct.unpack_from("<IHH", h, 6)
        root, root_nrec, total = struct.unpack_from("<QHQ", h, 16)
        # the library's node_info: most records of a node at each depth,
        # and the bytes of the counts an internal node keeps of its
        # children (H5B2__hdr_init)
        max_nrec = [(node_size - 10) // rec_size]
        cum_max = [max_nrec[0]]
        nrec_size = _limit_enc_size(max_nrec[0])
        cum_size = [0]
        for d in range(1, depth + 1):
            ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
            cum_max.append((max_nrec[d] + 1) * cum_max[d - 1] + max_nrec[d])
            cum_size.append(_limit_enc_size(cum_max[d]))
        out = []
        nodes = [(root, root_nrec, depth)] if root != UNDEF else []
        while nodes:
            node, nrec, d = nodes.pop()
            sig = b"BTIN" if d else b"BTLF"
            body = self.expect(node, sig, node_size)
            out.extend(body[6 + rec_size * i:6 + rec_size * (i + 1)]
                       for i in range(nrec))
            if not d:
                continue
            pos = 6 + rec_size * nrec
            for _ in range(nrec + 1):
                child = struct.unpack_from("<Q", body, pos)[0]
                child_nrec = _uint(body, pos + 8, nrec_size)
                pos += 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
                nodes.append((child, child_nrec, d - 1))
        if len(out) != total:
            self.fail(f"link-name index at {at} holds {len(out)} of its "
                      f"{total} records")
        if any(len(r) != 4 + id_len for r in out):
            self.fail(f"link-name index at {at}: records of {rec_size} "
                      f"bytes, not 4 + {id_len}")
        return out

    # datasets

    def dataset(self, name: str, at: int) -> tuple:
        """(shape, data offset, bytes) of the contiguous float32 dataset
        ``name`` whose object header is at ``at``."""
        msgs = dict(self.messages(at, name))
        if DATASPACE not in msgs or LAYOUT not in msgs:
            self.fail(f"{name} is not a dataset")
        d = msgs[LAYOUT]
        if d[0] not in (3, 4):
            self.fail(f"dataset {name}: layout message version {d[0]}")
        if d[1] != 1:
            self.fail(f"dataset {name}: {_LAYOUTS.get(d[1], d[1])} layout"
                      + (", compressed" if FILTERS in msgs else "")
                      + ", not contiguous")
        if EXTERNAL in msgs:
            self.fail(f"dataset {name}: stored in external files")
        self._check_float32(name, msgs.get(DATATYPE, b"\xff" + bytes(19)))
        d = msgs[DATASPACE]
        if d[0] == 2 and d[3] == 2:
            self.fail(f"dataset {name}: a null dataspace")
        if d[0] not in (1, 2):
            self.fail(f"dataset {name}: dataspace version {d[0]}")
        shape = struct.unpack_from(f"<{d[1]}Q", d, 8 if d[0] == 1 else 4)
        addr, size = struct.unpack_from("<QQ", msgs[LAYOUT], 2)
        nbytes = 4 * int(np.prod(shape, dtype=np.int64))
        if size != nbytes:
            self.fail(f"dataset {name}: {size} bytes stored for shape "
                      f"{shape}")
        if nbytes and addr == UNDEF:
            self.fail(f"dataset {name}: no storage allocated")
        return tuple(int(x) for x in shape), addr, nbytes

    def _check_float32(self, name: str, d: bytes) -> None:
        cls, bits = d[0] & 0x0F, d[1:4]
        size = struct.unpack_from("<I", d, 4)[0]
        props = d[8:20] if cls == 1 else b""
        if cls != 1 or size != 4:
            kind = {0: "integer", 1: "float", 3: "string", 6: "compound"}
            self.fail(f"dataset {name}: a {size}-byte "
                      f"{kind.get(cls, f'class {cls}')} type, not float32")
        if bits[0] & 0x41:
            self.fail(f"dataset {name}: big-endian float32")
        if props != _float32_type()[8:20]:
            self.fail(f"dataset {name}: float of another bit layout")
