"""A small HDF5 reader and writer on the standard library (struct + zlib)
and numpy.

The port reads the TUM-VIE and EDS event streams (H5 files) without h5py,
which the card's Python does not have.  The reader takes the subset of the
format that h5py 3.x writes with its default `libver` ('earliest'):

  - superblock version 0 or 1;
  - version-1 object headers, with continuation blocks;
  - symbol-table groups: a version-1 B-tree of type 0, symbol table nodes
    and a local heap;
  - dataspaces (scalar and simple), little-endian fixed-point datatypes of
    1, 2, 4 or 8 bytes (signed and unsigned) and IEEE float32 / float64,
    the fill value;
  - data layout version 3 in its three classes: compact, contiguous, and
    chunked with a version-1 B-tree of type 1;
  - the filters deflate (1), shuffle (2) and fletcher32 (3; the checksum is
    stripped, not verified).

Anything else raises NotImplementedError naming the structure: superblock
2 or 3 and version-2 object headers (libver='latest', creation-order
groups), layout versions other than 3, other filters (lzf 32000, blosc
32001, ...), big-endian or other datatypes, shared messages, external
storage, objects that are neither a symbol-table group nor a dataset.

A dataset read touches only what it covers: `ds[lo:hi]` of a contiguous
dataset reads those rows' bytes at their address, and of a chunked one the
chunks the rows overlap.  Indexing supports `[()]`, `[i]` (negative too),
`[lo:hi:step]` (step >= 1) along the first axis, and `np.asarray(ds)`.

`write_datasets` writes superblock 0, symbol-table groups and contiguous
datasets (scalar or simple dataspace) that h5py reads back equal.
"""

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_TYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
# object header message types
_NIL, _DATASPACE, _DATATYPE, _FILL = 0x0, 0x1, 0x3, 0x5
_EXTERNAL, _LAYOUT, _FILTERS = 0x7, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11


def _uint(data, pos, size):
    return int.from_bytes(data[pos:pos + size], "little")


class File:
    """A read-only HDF5 file: `f["a/b"]`, `"a/b" in f`, `f.keys()`."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._root = _open_object(self, self._read_superblock(), "/")
            if not isinstance(self._root, Group):
                raise ValueError(f"{path}: the root object is not a group")
        except BaseException:
            self._f.close()
            raise

    def _read_superblock(self):
        sb = self._f.read(24)
        if sb[:8] != _SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file written without a user block")
        version = sb[8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{self.path}: HDF5 superblock version {version} (files written with "
                "libver='latest' or a newer format); the reader supports superblock 0 and 1")
        self.so, self.sl = sb[13], sb[14]  # sizes of offsets and of lengths
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise NotImplementedError(f"{self.path}: offsets of {self.so} / lengths of "
                                      f"{self.sl} bytes")
        self.undef = (1 << 8 * self.so) - 1  # the undefined address
        # base, free-space, end-of-file and driver addresses, then the root
        # group's symbol table entry: its object header is the entry's second field
        root_entry = self.read(24 + (4 if version == 1 else 0) + 4 * self.so, 2 * self.so)
        return self.offset(root_entry, self.so)

    def read(self, addr, n):
        """n bytes at a file address."""
        self._f.seek(addr)
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated (wanted {n} bytes at {addr})")
        return data

    def read_into(self, addr, buf):
        self._f.seek(addr)
        if self._f.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: truncated (wanted {len(buf)} bytes at {addr})")

    def offset(self, data, pos):
        return _uint(data, pos, self.so)

    def length(self, data, pos):
        return _uint(data, pos, self.sl)

    def __getitem__(self, path):
        return self._root[path]

    def __contains__(self, path):
        return path in self._root

    def keys(self):
        return self._root.keys()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _messages(f, addr):
    """[(type, flags, data)] of the object header at addr (version 1),
    continuation blocks included."""
    head = f.read(addr, 16)
    if head[:4] == b"OHDR":
        raise NotImplementedError(f"{f.path}: version-2 object headers (libver='latest')")
    if head[0] != 1:
        raise NotImplementedError(f"{f.path}: object header version {head[0]}")
    blocks = [(addr + 16, struct.unpack_from("<I", head, 8)[0])]
    out = []
    while blocks:
        start, size = blocks.pop(0)
        data = f.read(start, size)
        pos = 0
        while pos + 8 <= size:
            mtype, msize, flags = struct.unpack_from("<HHB", data, pos)
            body = data[pos + 8:pos + 8 + msize]
            pos += 8 + msize
            if mtype == _CONTINUATION:
                blocks.append((f.offset(body, 0), f.length(body, f.so)))
            elif mtype != _NIL:
                out.append((mtype, flags, body))
    return out


def _open_object(f, addr, name):
    msgs = _messages(f, addr)
    types = {m[0] for m in msgs}
    if _SYMBOL_TABLE in types:
        return Group(f, name, msgs)
    if _LAYOUT in types:
        return Dataset(f, name, msgs)
    raise NotImplementedError(f"{f.path}: {name}: an object with header messages "
                              f"{sorted(types)} (neither a group nor a dataset)")


class Group:
    """A symbol-table group: names -> objects."""

    def __init__(self, f, name, msgs):
        self.file, self.name = f, name
        body = next(b for t, _, b in msgs if t == _SYMBOL_TABLE)
        btree, heap = f.offset(body, 0), f.offset(body, f.so)
        h = f.read(heap, 8 + 2 * f.sl + f.so)
        if h[:4] != b"HEAP":
            raise ValueError(f"{f.path}: no local heap at {heap}")
        heap_data = f.read(f.offset(h, 8 + 2 * f.sl), f.length(h, 8))
        self._links = {}
        for snod in self._leaves(btree):
            self._read_snod(snod, heap_data)

    def _leaves(self, addr):
        """The symbol table node addresses under a group B-tree node."""
        f = self.file
        head = f.read(addr, 8 + 2 * f.so)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{f.path}: no group B-tree node at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = f.read(addr + 8 + 2 * f.so, used * (f.sl + f.so) + f.sl)
        children = [f.offset(body, f.sl + i * (f.sl + f.so)) for i in range(used)]
        if level == 0:
            return children
        return [leaf for c in children for leaf in self._leaves(c)]

    def _read_snod(self, addr, heap_data):
        f = self.file
        head = f.read(addr, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"{f.path}: no symbol table node at {addr}")
        count = struct.unpack_from("<H", head, 6)[0]
        esize = 2 * f.so + 24
        data = f.read(addr + 8, count * esize)
        for i in range(count):
            e = i * esize
            at = f.offset(data, e)
            name = heap_data[at:heap_data.index(b"\0", at)].decode()
            self._links[name] = f.offset(data, e + f.so)

    def keys(self):
        return list(self._links)

    def _resolve(self, path):
        parts = [p for p in path.split("/") if p]
        obj = self
        for i, part in enumerate(parts):
            if not isinstance(obj, Group) or part not in obj._links:
                raise KeyError(f"{path!r} is not in {self.file.path}")
            full = self.name.rstrip("/") + "/" + "/".join(parts[:i + 1])
            obj = _open_object(self.file, obj._links[part], full)
        return obj

    def __getitem__(self, path):
        return self._resolve(path)

    def __contains__(self, path):
        try:
            self._resolve(path)
        except KeyError:
            return False
        return True


def _dataspace(body, f, where):
    """The shape of a version-1 dataspace (rank 0: a scalar)."""
    if body[0] != 1:
        raise NotImplementedError(f"{where}: dataspace version {body[0]}")
    return tuple(f.length(body, 8 + i * f.sl) for i in range(body[1]))


def _datatype(body, where):
    cls, bits, size = body[0] & 0x0F, body[1], struct.unpack_from("<I", body, 4)[0]
    if cls == 0:  # fixed-point
        if bits & 1:
            raise NotImplementedError(f"{where}: a big-endian integer datatype")
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise NotImplementedError(f"{where}: an integer of {size} bytes with "
                                      f"{precision} bits at offset {offset}")
        return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:  # floating-point
        if bits & 0x41:
            raise NotImplementedError(f"{where}: a big-endian or VAX float datatype")
        layout = struct.unpack_from("<HHBBBBI", body, 8)
        ieee = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
        if ieee.get(size) != layout:
            raise NotImplementedError(f"{where}: a float of {size} bytes laid out as {layout}")
        return np.dtype(f"<f{size}")
    raise NotImplementedError(f"{where}: datatype class {cls} "
                              f"({_TYPE_CLASSES.get(cls, 'unknown')})")


def _fill_value(body, dtype, where):
    """The fill value of a version-2 fill value message (zero when none is
    defined)."""
    if body[0] != 2:
        raise NotImplementedError(f"{where}: fill value message version {body[0]}")
    size = struct.unpack_from("<I", body, 4)[0] if body[3] else 0
    return np.frombuffer(body[8:8 + size], dtype)[0] if size == dtype.itemsize else dtype.type(0)


def _filters(body, where):
    """[(filter id, client data)] of a version-1 filter pipeline message."""
    if body[0] != 1:
        raise NotImplementedError(f"{where}: filter pipeline version {body[0]}")
    pos, out = 8, []
    for _ in range(body[1]):
        fid, name_len, _flags, nvals = struct.unpack_from("<HHHH", body, pos)
        pos += 8 + (name_len + 7) // 8 * 8  # the name, padded to 8 bytes
        values = struct.unpack_from(f"<{nvals}I", body, pos)
        pos += 4 * nvals + 4 * (nvals % 2)
        if fid not in (1, 2, 3):
            raise NotImplementedError(f"{where}: HDF5 filter {fid} "
                                      f"({_FILTER_NAMES.get(fid, 'unknown')}); the reader "
                                      "undoes deflate (1), shuffle (2) and fletcher32 (3)")
        out.append((fid, values))
    return out


class Dataset:
    """A dataset: `.shape`, `.dtype`, `[()]`, `[i]`, `[lo:hi]`, `np.asarray(ds)`."""

    def __init__(self, f, name, msgs):
        self.file, self.name = f, name
        where = f"{f.path}: {name}"
        by_type = {}
        for mtype, flags, body in msgs:
            if flags & 2 and mtype in (_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _FILTERS):
                raise NotImplementedError(f"{where}: a shared (committed) header message "
                                          f"of type {mtype}")
            by_type.setdefault(mtype, body)
        if _EXTERNAL in by_type:
            raise NotImplementedError(f"{where}: external storage")
        self.shape = _dataspace(by_type[_DATASPACE], f, where)
        self.dtype = _datatype(by_type[_DATATYPE], where)
        self._fill = (_fill_value(by_type[_FILL], self.dtype, where) if _FILL in by_type
                      else self.dtype.type(0))
        self._filters = _filters(by_type[_FILTERS], where) if _FILTERS in by_type else []
        layout = by_type[_LAYOUT]
        if layout[0] != 3:
            raise NotImplementedError(f"{where}: data layout version {layout[0]} (version 4 "
                                      "is libver='latest'); the reader supports version 3")
        self._layout = layout[1]
        if self._layout == 0:  # compact: the data is in the message
            n = struct.unpack_from("<H", layout, 2)[0]
            self._compact = np.frombuffer(layout[4:4 + n], self.dtype).reshape(self.shape)
        elif self._layout == 1:  # contiguous
            self._addr = f.offset(layout, 2)
        elif self._layout == 2:  # chunked
            self._btree = f.offset(layout, 3)
            # the chunk's dimensions, then the element size
            self._chunk = struct.unpack_from(f"<{layout[2]}I", layout, 3 + f.so)
            self._index = None
        else:
            raise NotImplementedError(f"{where}: layout class {self._layout}")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of a scalar dataset")
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self[()])
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)) and self.shape:
            n = self.shape[0]
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {int(key)} is out of range for {self.name} of {n} rows")
            return self._rows(i, i + 1)[0]
        if isinstance(key, slice) and self.shape:
            start, stop, step = key.indices(self.shape[0])
            if step < 1:
                raise ValueError(f"{self.name}: a slice step must be >= 1, got {step}")
            return self._rows(start, max(start, stop))[::step]
        if isinstance(key, tuple) and key == () or key is Ellipsis:
            return self._rows(0, self.shape[0]) if self.shape else self._all()[()]
        if not self.shape:
            raise IndexError(f"{self.name}: a scalar dataset takes [()] only, not {key!r}")
        raise TypeError(f"{self.name}: index with (), an int or a slice (the first axis of a "
                        f"non-scalar dataset), not {key!r}")

    def _all(self):
        """The whole of a scalar dataset (compact or contiguous: HDF5 chunks
        no scalar) as a 0-d array."""
        if self._layout == 0:
            return self._compact.copy()
        return self._contiguous(0, 1).reshape(())

    def _rows(self, lo, hi):
        """Rows [lo, hi) along the first axis."""
        if self._layout == 0:
            return self._compact[lo:hi].copy()
        if self._layout == 1:
            return self._contiguous(lo, hi)
        return self._chunked(lo, hi)

    def _row_items(self):
        return math.prod(self.shape[1:]) if self.shape else 1

    def _contiguous(self, lo, hi):
        per_row = self._row_items()
        shape = ((hi - lo),) + self.shape[1:] if self.shape else (1,)
        if self._addr == self.file.undef or hi <= lo:  # never written
            return np.full(shape, self._fill, self.dtype)
        buf = bytearray((hi - lo) * per_row * self.dtype.itemsize)
        self.file.read_into(self._addr + lo * per_row * self.dtype.itemsize, buf)
        return np.frombuffer(buf, self.dtype).reshape(shape)

    def _chunk_index(self):
        """(offsets [n, rank] int64, sizes, filter masks, addresses) of every
        chunk, walked from the chunk B-tree once."""
        if self._index is None:
            rank = len(self._chunk)
            found = []
            if self._btree != self.file.undef:
                self._walk(self._btree, rank, found)
            found.sort()
            offs = np.asarray([c[0] for c in found], np.int64).reshape(-1, rank - 1)
            self._index = (offs, [c[1] for c in found], [c[2] for c in found],
                           [c[3] for c in found])
        return self._index

    def _walk(self, addr, rank, found):
        f = self.file
        head = f.read(addr, 8 + 2 * f.so)
        if head[:4] != b"TREE" or head[4] != 1:
            raise ValueError(f"{f.path}: {self.name}: no chunk B-tree node at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        ksize = 8 + 8 * rank  # chunk size, filter mask, rank + 1 offsets of 8 bytes
        body = f.read(addr + 8 + 2 * f.so, used * (ksize + f.so) + ksize)
        for i in range(used):
            k = i * (ksize + f.so)
            child = f.offset(body, k + ksize)
            if level > 0:
                self._walk(child, rank, found)
                continue
            size, mask = struct.unpack_from("<II", body, k)
            offsets = struct.unpack_from(f"<{rank - 1}Q", body, k + 8)
            found.append((offsets, size, mask, child))

    def _decode_chunk(self, addr, size, mask):
        raw = self.file.read(addr, size)
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue  # this filter was skipped for this chunk
            fid, values = self._filters[i]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                width = values[0] if values else self.dtype.itemsize
                a = np.frombuffer(raw, np.uint8)
                n = len(a) // width
                raw = a[:n * width].reshape(width, n).T.tobytes() + a[n * width:].tobytes()
            else:  # fletcher32: a 4-byte checksum after the data
                raw = raw[:-4]
        dims = self._chunk[:-1]
        return np.frombuffer(raw, self.dtype, count=math.prod(dims)).reshape(dims)

    def _chunked(self, lo, hi):
        dims = self._chunk[:-1]  # the last chunk dimension is the element size
        out = np.full((hi - lo,) + self.shape[1:], self._fill, self.dtype)
        if hi <= lo:
            return out
        offs, sizes, masks, addrs = self._chunk_index()
        hit = np.nonzero((offs[:, 0] < hi) & (offs[:, 0] + dims[0] > lo))[0] if len(offs) else []
        for j in hit:
            chunk = self._decode_chunk(addrs[j], sizes[j], masks[j])
            o = offs[j]
            r0, r1 = max(lo, o[0]), min(hi, o[0] + dims[0])
            dst = [slice(r0 - lo, r1 - lo)]
            src = [slice(r0 - o[0], r1 - o[0])]
            for d in range(1, len(dims)):
                end = min(self.shape[d], o[d] + dims[d])
                dst.append(slice(o[d], end))
                src.append(slice(0, end - o[d]))
            out[tuple(dst)] = chunk[tuple(src)]
        return out


# ----------------------------------------------------------------------------
# the writer


def _le(value):
    a = np.asarray(value)
    if a.dtype.kind not in "iuf" or (a.dtype.kind == "f" and a.dtype.itemsize not in (4, 8)):
        raise TypeError(f"write_datasets writes integers and float32 / float64, got {a.dtype}")
    return np.array(a, a.dtype.newbyteorder("<"), order="C")  # keeps a 0-d array 0-d


def _msg(mtype, body):
    body += b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages):
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_msg(dtype):
    size = dtype.itemsize
    if dtype.kind == "f":
        exp, man, bias = {4: (8, 23, 127), 8: (11, 52, 1023)}[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size, 0, 8 * size,
                           man, exp, 0, man, bias)
    return struct.pack("<BBBBIHH", 0x10, 8 if dtype.kind == "i" else 0, 0, 0, size, 0, 8 * size)


def write_datasets(path, datasets):
    """Write {"group/name": array or numpy scalar} to a new HDF5 file:
    superblock 0, symbol-table groups (made for every path prefix) and
    contiguous little-endian datasets, integers of 1-8 bytes or float32 /
    float64, a numpy scalar as a scalar dataspace."""
    if not datasets:
        raise ValueError("write_datasets needs at least one dataset")
    tree = {}
    for name, value in datasets.items():
        parts = [p for p in name.split("/") if p]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"{name}: {p} is a dataset, not a group")
        if not parts or parts[-1] in node:
            raise ValueError(f"dataset name {name!r} is empty or given twice")
        node[parts[-1]] = _le(value)

    def widest(node):
        subs = [widest(v) for v in node.values() if isinstance(v, dict)]
        return max([len(node)] + subs)

    leaf_k, internal_k = max(4, -(-widest(tree) // 2)), 16
    buf = bytearray(96)  # the superblock, filled in last

    def put(data):
        buf.extend(b"\0" * (-len(buf) % 8))
        addr = len(buf)
        buf.extend(data)
        return addr

    def dataset(a):
        addr = put(a.tobytes()) if a.size else _UNDEF
        space = struct.pack("<BBBB4x", 1, a.ndim, 0, 0) + struct.pack(f"<{a.ndim}Q", *a.shape)
        layout = struct.pack("<BBQQ", 3, 1, addr, a.nbytes)
        fill = struct.pack("<BBBB", 2, 1, 2, 0)  # early allocation, no fill value set
        return put(_object_header([_msg(_DATASPACE, space),
                                   _msg(_DATATYPE, _datatype_msg(a.dtype)),
                                   _msg(_FILL, fill), _msg(_LAYOUT, layout)]))

    def group(node):
        """(object header, B-tree, local heap) addresses of a group."""
        names = sorted(node, key=str.encode)
        entries, heap = [], bytearray(8)  # offset 0 holds the empty name
        for name in names:
            v = node[name]
            if isinstance(v, dict):
                header, btree, hp = group(v)
                scratch = struct.pack("<IIQQ", 1, 0, btree, hp)
            else:
                header, scratch = dataset(v), struct.pack("<II16x", 0, 0)
            entries.append(struct.pack("<QQ", len(heap), header) + scratch)
            heap += name.encode() + b"\0"
            heap += b"\0" * (-len(heap) % 8)
        snod = (b"SNOD" + struct.pack("<BBH", 1, 0, len(entries)) + b"".join(entries)
                + b"\0" * (40 * (2 * leaf_k - len(entries))))
        snod_addr = put(snod)
        heap_data = put(bytes(heap))
        # free-list head 1: no free block (HDF5's H5HL_FREE_NULL)
        heap_addr = put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        # one leaf: keys are heap offsets, the empty name and the last name
        btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
                 + struct.pack("<QQ", 0, snod_addr) + entries[-1][:8])
        btree += b"\0" * (24 + 2 * internal_k * 8 + (2 * internal_k + 1) * 8 - len(btree))
        btree_addr = put(btree)
        header = put(_object_header([_msg(_SYMBOL_TABLE, struct.pack("<QQ", btree_addr,
                                                                     heap_addr))]))
        return header, btree_addr, heap_addr

    root, btree, heap = group(tree)
    buf.extend(b"\0" * (-len(buf) % 8))
    buf[:96] = (_SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k,
                                         internal_k, 0)
                + struct.pack("<QQQQ", 0, _UNDEF, len(buf), _UNDEF)
                + struct.pack("<QQIIQQ", 0, root, 1, 0, btree, heap))
    with open(path, "wb") as f:
        f.write(buf)
    return path
