"""A small HDF5 reader and writer on the standard library (struct + zlib)
and numpy.

The port reads the TUM-VIE and EDS event streams (H5 files) without h5py,
which the card's Python does not have.  The reader takes what h5py 3.x
writes for numeric datasets at every `libver` ('earliest', 'v108', 'v110',
'latest'):

  - superblock versions 0-3 (2 and 3 with their checksum);
  - version-1 object headers with continuation blocks, and version-2 ones
    (OHDR / OCHK, their times, attribute phase and creation-order fields,
    each block's checksum verified);
  - groups with a symbol table (a version-1 B-tree of type 0, symbol table
    nodes and a local heap), and new-style groups: link messages in the
    header (compact), or a fractal heap (FRHP / FHIB / FHDB) indexed by a
    version-2 B-tree (BTHD / BTIN / BTLF, records of type 5 or 6) once a
    group is dense (more than 8 links, or creation order tracked);
  - dataspaces versions 1-2 (scalar, simple), fixed-point datatypes of 1, 2,
    4 or 8 bytes (signed, unsigned) and IEEE float32 / float64, little- or
    big-endian (a big-endian dataset reads as a big-endian array, as from
    h5py), fill value messages versions 1-3;
  - data layout version 3 (compact, contiguous, chunked with a version-1
    B-tree of type 1) and version 4: compact, contiguous and chunked with
    each chunk index h5py writes: single chunk, implicit, fixed array
    (FAHD / FADB, paged), extensible array (EAHD / EAIB / EASB / EADB, what
    `maxshape=(None,)` writes) and version-2 B-tree (records 10 / 11);
  - filter pipeline messages versions 1-2 with the filters deflate (1),
    shuffle (2), fletcher32 (3, the checksum verified: a mismatch raises,
    as in h5py), lzf (32000, h5py's own) and scale-offset (6) on integers.

Every checksummed structure is verified (Jenkins' lookup3, `lookup3`).
Anything else raises NotImplementedError naming the structure: szip, nbit,
scale-offset on floats and other filters (blosc 32001, ...), external
storage, shared messages, soft and external links, huge fractal-heap
objects, filtered fractal heaps, strings, compound, variable-length and the
other datatype classes, null dataspaces, virtual layouts, an extensible
array over a dimension other than the first, objects that are neither a
group nor a dataset.

A dataset read touches only what it covers: `ds[lo:hi]` of a contiguous
dataset reads those rows' bytes at their address, and of a chunked one the
chunks the rows overlap (the chunk index is read once).  Indexing supports
`[()]`, `[i]` (negative too), `[lo:hi:step]` (step >= 1) along the first
axis, and `np.asarray(ds)`.

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
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0x0, 0x1, 0x2, 0x3, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS = 0x6, 0x7, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
_M32 = 0xFFFFFFFF


def _uint(data, pos, size):
    return int.from_bytes(data[pos:pos + size], "little")


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data, initval=0):
    """Bob Jenkins' lookup3 hashlittle of bytes: HDF5's metadata checksum."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    full = (n - 1) // 12  # the last 1-12 bytes go to the final mix
    for x, y, z in struct.iter_unpack("<3I", data[:12 * full]):
        a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8)
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4)
        b = (b + a) & _M32
    x, y, z = struct.unpack("<3I", bytes(data[12 * full:]).ljust(12, b"\0"))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c = ((c ^ b) - _rot(b, 14)) & _M32
    a = ((a ^ c) - _rot(c, 11)) & _M32
    b = ((b ^ a) - _rot(a, 25)) & _M32
    c = ((c ^ b) - _rot(b, 16)) & _M32
    a = ((a ^ c) - _rot(c, 4)) & _M32
    b = ((b ^ a) - _rot(a, 14)) & _M32
    c = ((c ^ b) - _rot(b, 24)) & _M32
    return c


def _verify(data, where):
    """data ends with the lookup3 checksum of what precedes it."""
    if lookup3(data[:-4]) != _uint(data, len(data) - 4, 4):
        raise ValueError(f"{where}: checksum mismatch (a corrupted file)")


def fletcher32(data):
    """HDF5's Fletcher-32 of bytes (16-bit big-endian words, the sums
    folded every 360 words as H5_checksum_fletcher32 folds them)."""
    b = np.frombuffer(data, np.uint8)
    n = len(b) // 2
    words = (b[:2 * n:2].astype(np.int64) << 8) | b[1:2 * n:2]
    s1 = s2 = 0

    def fold(x):
        return (x & 0xFFFF) + (x >> 16)

    for s in range(0, n, 360):
        w = words[s:s + 360]
        s2 += len(w) * s1 + int((np.arange(len(w), 0, -1) * w).sum())
        s1 += int(w.sum())
        s1, s2 = fold(s1), fold(s2)
    if len(b) % 2:
        s1 += int(b[-1]) << 8
        s2 += s1
        s1, s2 = fold(s1), fold(s2)
    return (fold(s2) << 16) | fold(s1)


def _lzf_decode(src, where):
    """liblzf's decompression (h5py's lzf filter stores the raw stream)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:  # a literal run of ctrl + 1 bytes
            out += src[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += src[i]
            i += 1
        dist = ((ctrl & 0x1F) << 8) + src[i] + 1
        i += 1
        length += 2
        ref = len(out) - dist
        if ref < 0 or i > n:
            raise ValueError(f"{where}: corrupt lzf data")
        if dist >= length:
            out += out[ref:ref + length]
        else:  # the copy overlaps its own output: the last dist bytes repeat
            out += (out[ref:] * (length // dist + 1))[:length]
    return bytes(out)


def _scaleoffset_decode(raw, values, dtype, where):
    """HDF5's scale-offset filter on integers (H5Zscaleoffset.c): a
    21-byte header (minbits, the size and value of minval), then each
    element's minbits bits, most significant first, back to back; a
    value of all ones is the fill value when one is defined."""
    if values[3] != 0:
        raise NotImplementedError(f"{where}: the scale-offset filter on floats")
    nelm, size = values[2], values[4]
    minbits = _uint(raw, 0, 4)
    minval = _uint(raw, 5, min(8, raw[4]))
    body = raw[21:]
    wide = np.dtype(f"<u{size}")
    order = wide.newbyteorder(dtype.byteorder if dtype.byteorder in "<>" else "<")
    if minbits == 8 * size:  # stored whole, in the writer's (little-endian) order
        return np.frombuffer(body[:nelm * size], wide).astype(order).tobytes()
    vals = np.zeros(nelm, np.uint64)
    if minbits:
        bits = np.unpackbits(np.frombuffer(body, np.uint8))[:nelm * minbits]
        for col in bits.reshape(nelm, minbits).T:
            vals = (vals << np.uint64(1)) | col
    out = (vals + np.uint64(minval)).astype(wide)
    if values[7] == 1:  # a fill value is defined: all ones stand for it
        fill = np.frombuffer(np.asarray(values[8:], "<u4").tobytes()[:size], wide)[0]
        out[vals == np.uint64((1 << minbits) - 1)] = fill
    return out.astype(order).tobytes()


def _enc_size(n):
    """Bytes that hold n (HDF5's H5VM_limit_enc_size)."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


class File:
    """A read-only HDF5 file: `f["a/b"]`, `"a/b" in f`, `f.keys()`."""

    def __init__(self, path):
        self.path = path
        self.groups = {}  # object header address -> Group
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
        if version > 3:
            raise NotImplementedError(f"{self.path}: HDF5 superblock version {version}")
        self.so, self.sl = (sb[13], sb[14]) if version < 2 else (sb[9], sb[10])
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise NotImplementedError(f"{self.path}: offsets of {self.so} / lengths of "
                                      f"{self.sl} bytes")
        self.undef = (1 << 8 * self.so) - 1  # the undefined address
        if version >= 2:
            # base, extension, end-of-file and root object header addresses
            data = self.read(0, 12 + 4 * self.so + 4)
            _verify(data, f"{self.path}: superblock")
            return self.offset(data, 12 + 3 * self.so)
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
    """[(type, flags, data)] of the object header at addr, continuation
    blocks included."""
    head = f.read(addr, 16)
    if head[:4] == b"OHDR":
        return _messages_v2(f, addr)
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


def _messages_v2(f, addr):
    """The messages of a version-2 object header (OHDR, then OCHK
    continuation blocks), each block's checksum verified."""
    where = f"{f.path}: object header at {addr}"
    pre = f.read(addr, 6)
    if pre[4] != 2:
        raise NotImplementedError(f"{where}: OHDR version {pre[4]}")
    flags = pre[5]
    pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    size0 = _uint(f.read(addr + pos, width), 0, width)
    pos += width
    block = f.read(addr, pos + size0 + 4)
    _verify(block, where)
    head = 6 if flags & 0x04 else 4  # type, size, flags [, creation order]
    blocks = [(block, pos, pos + size0)]
    out = []
    while blocks:
        data, pos, end = blocks.pop(0)
        while pos + head <= end:  # what is left past the last message is a gap
            mtype, msize, mflags = data[pos], _uint(data, pos + 1, 2), data[pos + 3]
            body = data[pos + head:pos + head + msize]
            pos += head + msize
            if mtype == _CONTINUATION:
                caddr, clen = f.offset(body, 0), f.length(body, f.so)
                cont = f.read(caddr, clen)
                if cont[:4] != b"OCHK":
                    raise ValueError(f"{where}: no OCHK continuation block at {caddr}")
                _verify(cont, where)
                blocks.append((cont, 4, clen - 4))
            elif mtype != _NIL:
                out.append((mtype, mflags, body))
    return out


def _open_object(f, addr, name):
    group = f.groups.get(addr)
    if group is not None:  # a dense group's links are read once
        return group
    msgs = _messages(f, addr)
    types = {m[0] for m in msgs}
    if types & {_SYMBOL_TABLE, _LINK_INFO, _LINK}:
        f.groups[addr] = Group(f, name, msgs)
        return f.groups[addr]
    if _LAYOUT in types:
        return Dataset(f, name, msgs)
    raise NotImplementedError(f"{f.path}: {name}: an object with header messages "
                              f"{sorted(types)} (neither a group nor a dataset)")


def _link(f, body, where):
    """(name, object header address or None, link type) of a link message."""
    if body[0] != 1:
        raise NotImplementedError(f"{where}: link message version {body[0]}")
    flags, pos, ltype = body[1], 2, 0
    if flags & 0x08:
        ltype = body[pos]
        pos += 1
    pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    n = _uint(body, pos, width)
    pos += width
    name = body[pos:pos + n].decode("utf-8")
    return name, (f.offset(body, pos + n) if ltype == 0 else None), ltype


class _FractalHeap:
    """Managed and tiny objects of a fractal heap (a dense group's links)."""

    def __init__(self, f, addr, where):
        self.f, self.where = f, where
        so, sl = f.so, f.sl
        size = 22 + 12 * sl + 3 * so
        hdr = f.read(addr, size + 4)
        if hdr[:4] != b"FRHP" or hdr[4] != 0:
            raise ValueError(f"{where}: no fractal heap header at {addr}")
        self.id_len, filters = struct.unpack_from("<HH", hdr, 5)
        if filters:
            raise NotImplementedError(f"{where}: a fractal heap with I/O filters")
        self.flags, max_man = hdr[9], _uint(hdr, 10, 4)
        pos = 14 + 10 * sl + 2 * so
        self.width = _uint(hdr, pos, 2)
        self.start, max_direct = f.length(hdr, pos + 2), f.length(hdr, pos + 2 + sl)
        max_heap_bits = _uint(hdr, pos + 2 + 2 * sl, 2)
        self.root = f.offset(hdr, pos + 6 + 2 * sl)
        self.root_rows = _uint(hdr, pos + 6 + 2 * sl + so, 2)
        _verify(hdr, where)
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = _enc_size(min(max_direct, max_man))
        self.max_drows = max_direct.bit_length() - self.start.bit_length() + 2
        self._blocks = {}

    def object(self, hid):
        kind = (hid[0] >> 4) & 3
        if kind == 2:  # tiny: the object is in the id
            if self.id_len > 17:
                return hid[2:2 + (((hid[0] & 0x0F) << 8) | hid[1]) + 1]
            return hid[1:1 + (hid[0] & 0x0F) + 1]
        if kind != 0:
            raise NotImplementedError(f"{self.where}: a huge fractal-heap object")
        off = _uint(hid, 1, self.off_size)
        n = _uint(hid, 1 + self.off_size, self.len_size)
        if self.root_rows == 0:  # the root is a direct block
            return self._direct(self.root, self.start, off, n)
        return self._indirect(self.root, self.root_rows, off, n)

    def _row_size(self, r):
        return self.start << max(r - 1, 0)

    def _direct(self, addr, size, off, n):
        block = self._blocks.get(addr)
        if block is None:
            block = self.f.read(addr, size)
            if block[:4] != b"FHDB":
                raise ValueError(f"{self.where}: no fractal heap direct block at {addr}")
            if self.flags & 2:  # checksummed with the checksum field zeroed
                at = 5 + self.f.so + self.off_size
                if lookup3(block[:at] + b"\0" * 4 + block[at + 4:]) != _uint(block, at, 4):
                    raise ValueError(f"{self.where}: checksum mismatch (a corrupted file)")
            self._blocks[addr] = block
        pos = off - _uint(block, 5 + self.f.so, self.off_size)
        return block[pos:pos + n]

    def _indirect(self, addr, rows, off, n):
        so, W = self.f.so, self.width
        drows = min(rows, self.max_drows)
        head = 5 + so + self.off_size
        data = self.f.read(addr, head + rows * W * so + 4)
        if data[:4] != b"FHIB":
            raise ValueError(f"{self.where}: no fractal heap indirect block at {addr}")
        _verify(data, self.where)
        acc = _uint(data, 5 + so, self.off_size)
        for r in range(rows):
            rs = self._row_size(r)
            if off < acc + W * rs:
                child = self.f.offset(data, head + (r * W + (off - acc) // rs) * so)
                if r < drows:
                    return self._direct(child, rs, off, n)
                child_rows = rs.bit_length() - (self.start * W).bit_length() + 1
                return self._indirect(child, child_rows, off, n)
            acc += W * rs
        raise ValueError(f"{self.where}: heap offset {off} lies past its blocks")


def _btree2_records(f, addr, where):
    """(type, [record bytes]) of every record of a version-2 B-tree."""
    so, sl = f.so, f.sl
    hdr = f.read(addr, 16 + so + 2 + sl + 4)
    if hdr[:4] != b"BTHD" or hdr[4] != 0:
        raise ValueError(f"{where}: no version-2 B-tree header at {addr}")
    _verify(hdr, where)
    btype, node_size, rsize, depth = hdr[5], _uint(hdr, 6, 4), _uint(hdr, 10, 2), _uint(hdr, 12, 2)
    root, nroot = f.offset(hdr, 16), _uint(hdr, 16 + so, 2)
    # the child pointers' field widths (H5B2__hdr_init)
    leaf_max = (node_size - 10) // rsize
    nrec_size = _enc_size(leaf_max)
    cum_max, cum_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        ptr = so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec = (node_size - (10 + ptr)) // (rsize + ptr)
        cum_max.append((max_nrec + 1) * cum_max[d - 1] + max_nrec)
        cum_size.append(_enc_size(cum_max[d]))
    out = []

    def walk(node, nrec, d):
        if nrec == 0 or node == f.undef:
            return
        ptr = so + nrec_size + (cum_size[d - 1] if d > 1 else 0) if d else 0
        data = f.read(node, 6 + nrec * rsize + (nrec + 1) * ptr + 4 if d else
                      6 + nrec * rsize + 4)
        if data[:4] != (b"BTIN" if d else b"BTLF"):
            raise ValueError(f"{where}: no version-2 B-tree node at {node}")
        _verify(data, where)
        out.extend(data[6 + i * rsize:6 + (i + 1) * rsize] for i in range(nrec))
        for i in range(nrec + 1 if d else 0):
            p = 6 + nrec * rsize + i * ptr
            walk(f.offset(data, p), _uint(data, p + so, nrec_size), d - 1)

    walk(root, nroot, depth)
    return btype, out


class Group:
    """A group: names -> objects (a symbol table, or link messages and a
    dense link storage)."""

    def __init__(self, f, name, msgs):
        self.file, self.name = f, name
        self._links = {}
        table = [b for t, _, b in msgs if t == _SYMBOL_TABLE]
        if table:
            self._read_symbol_table(table[0])
            return
        where = f"{f.path}: {name}"
        for t, flags, body in msgs:
            if t in (_LINK, _LINK_INFO) and flags & 2:
                raise NotImplementedError(f"{where}: a shared (committed) link message")
            if t == _LINK:
                self._add(*_link(f, body, where))
        info = next((b for t, _, b in msgs if t == _LINK_INFO), None)
        if info is not None:
            pos = 2 + (8 if info[1] & 1 else 0)
            heap, names = f.offset(info, pos), f.offset(info, pos + f.so)
            if heap != f.undef:  # dense: the links in a fractal heap
                fh = _FractalHeap(f, heap, where)
                btype, records = _btree2_records(f, names, where)
                skip = {5: 4, 6: 8}.get(btype)
                if skip is None:
                    raise ValueError(f"{where}: a link name index of record type {btype}")
                for rec in records:
                    self._add(*_link(f, fh.object(rec[skip:skip + fh.id_len]), where))

    def _add(self, name, addr, ltype):
        self._links[name] = (addr, ltype)

    def _read_symbol_table(self, body):
        f = self.file
        btree, heap = f.offset(body, 0), f.offset(body, f.so)
        h = f.read(heap, 8 + 2 * f.sl + f.so)
        if h[:4] != b"HEAP":
            raise ValueError(f"{f.path}: no local heap at {heap}")
        heap_data = f.read(f.offset(h, 8 + 2 * f.sl), f.length(h, 8))
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
            self._add(name, f.offset(data, e + f.so), 0)

    def keys(self):
        return list(self._links)

    def _resolve(self, path):
        parts = [p for p in path.split("/") if p]
        obj = self
        for i, part in enumerate(parts):
            if not isinstance(obj, Group) or part not in obj._links:
                raise KeyError(f"{path!r} is not in {self.file.path}")
            full = self.name.rstrip("/") + "/" + "/".join(parts[:i + 1])
            addr, ltype = obj._links[part]
            if addr is None:
                raise NotImplementedError(f"{self.file.path}: {full} is a "
                                          f"{'soft' if ltype == 1 else 'external'} link")
            obj = _open_object(self.file, addr, full)
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
    """(shape, max shape) of a version-1 or -2 dataspace (rank 0: a
    scalar); an unlimited maximum is None."""
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise NotImplementedError(f"{where}: a null dataspace")
        pos = 4
    else:
        raise NotImplementedError(f"{where}: dataspace version {version}")
    shape = tuple(f.length(body, pos + i * f.sl) for i in range(rank))
    if not flags & 1:
        return shape, shape
    top = (1 << 8 * f.sl) - 1
    maxs = (f.length(body, pos + (rank + i) * f.sl) for i in range(rank))
    return shape, tuple(None if m == top else m for m in maxs)


def _datatype(body, where):
    cls, bits, size = body[0] & 0x0F, body[1], struct.unpack_from("<I", body, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise NotImplementedError(f"{where}: an integer of {size} bytes with "
                                      f"{precision} bits at offset {offset}")
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:  # floating-point
        if bits & 0x40:
            raise NotImplementedError(f"{where}: a VAX-ordered float datatype")
        layout = struct.unpack_from("<HHBBBBI", body, 8)
        ieee = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
        if ieee.get(size) != layout:
            raise NotImplementedError(f"{where}: a float of {size} bytes laid out as {layout}")
        return np.dtype(f"{order}f{size}")
    raise NotImplementedError(f"{where}: datatype class {cls} "
                              f"({_TYPE_CLASSES.get(cls, 'unknown')})")


def _fill_value(body, dtype, where):
    """The fill value of a fill value message, versions 1-3 (zero when none
    is defined)."""
    if body[0] in (1, 2):
        defined, pos = body[3] or body[0] == 1, 4
    elif body[0] == 3:
        defined, pos = body[1] & 0x20, 2
    else:
        raise NotImplementedError(f"{where}: fill value message version {body[0]}")
    size = struct.unpack_from("<I", body, pos)[0] if defined and len(body) >= pos + 4 else 0
    if size == dtype.itemsize:
        return np.frombuffer(body[pos + 4:pos + 4 + size], dtype)[0]
    return dtype.type(0)


_FILTERS_READ = (1, 2, 3, 6, 32000)


def _filters(body, where):
    """[(filter id, client data)] of a filter pipeline message, version 1
    or 2."""
    version = body[0]
    if version not in (1, 2):
        raise NotImplementedError(f"{where}: filter pipeline version {version}")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(body[1]):
        fid = _uint(body, pos, 2)
        if version == 1 or fid >= 256:
            name_len = _uint(body, pos + 2, 2)
            pos += 2
        else:
            name_len = 0
        nvals = _uint(body, pos + 4, 2)
        pos += 6
        pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
        values = struct.unpack_from(f"<{nvals}I", body, pos)
        pos += 4 * nvals + (4 * (nvals % 2) if version == 1 else 0)
        if fid not in _FILTERS_READ:
            raise NotImplementedError(
                f"{where}: HDF5 filter {fid} ({_FILTER_NAMES.get(fid, 'unknown')}); the reader "
                "undoes deflate (1), shuffle (2), fletcher32 (3), scaleoffset (6) on integers "
                "and lzf (32000)")
        out.append((fid, values))
    return out


class Dataset:
    """A dataset: `.shape`, `.dtype`, `[()]`, `[i]`, `[lo:hi]`, `np.asarray(ds)`."""

    def __init__(self, f, name, msgs):
        self.file, self.name = f, name
        where = self._where = f"{f.path}: {name}"
        by_type = {}
        for mtype, flags, body in msgs:
            if flags & 2 and mtype in (_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _FILTERS):
                raise NotImplementedError(f"{where}: a shared (committed) header message "
                                          f"of type {mtype}")
            by_type.setdefault(mtype, body)
        if _EXTERNAL in by_type:
            raise NotImplementedError(f"{where}: external storage")
        self.shape, self._maxshape = _dataspace(by_type[_DATASPACE], f, where)
        self.dtype = _datatype(by_type[_DATATYPE], where)
        self._fill = (_fill_value(by_type[_FILL], self.dtype, where) if _FILL in by_type
                      else self.dtype.type(0))
        self._filters = _filters(by_type[_FILTERS], where) if _FILTERS in by_type else []
        layout = by_type[_LAYOUT]
        if layout[0] not in (3, 4):
            raise NotImplementedError(f"{where}: data layout version {layout[0]}")
        self._layout = layout[1]
        if self._layout == 0:  # compact: the data is in the message
            n = struct.unpack_from("<H", layout, 2)[0]
            self._compact = np.frombuffer(layout[4:4 + n], self.dtype).reshape(self.shape)
        elif self._layout == 1:  # contiguous
            self._addr = f.offset(layout, 2)
        elif self._layout == 2 and layout[0] == 3:  # chunked, a version-1 B-tree
            self._btree = f.offset(layout, 3)
            # the chunk's dimensions, then the element size
            self._chunk = struct.unpack_from(f"<{layout[2]}I", layout, 3 + f.so)
            self._kind = "btree1"
        elif self._layout == 2:
            self._chunked_v4(layout)
        else:
            raise NotImplementedError(f"{where}: layout class {self._layout} (virtual)")
        self._index = None

    def _chunked_v4(self, layout):
        """A version-4 chunked layout: the chunk dimensions and the index."""
        f = self.file
        flags, ndim, enc = layout[2], layout[3], layout[4]
        self._chunk = tuple(_uint(layout, 5 + i * enc, enc) for i in range(ndim))
        pos = 5 + ndim * enc
        kind = layout[pos]
        pos += 1
        self._kind = {1: "single", 2: "implicit", 3: "farray", 4: "earray", 5: "btree2"}.get(kind)
        if self._kind is None:
            raise NotImplementedError(f"{self._where}: chunk index type {kind}")
        self._single = None
        if kind == 1 and flags & 2:  # a filtered single chunk: its size and mask
            self._single = (f.length(layout, pos), _uint(layout, pos + f.sl, 4))
            pos += f.sl + 4
        pos += {1: 0, 2: 0, 3: 1, 4: 5, 5: 6}[kind]
        self._idx_addr = f.offset(layout, pos)

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

    # ------------------------------------------------------------ chunk indexes

    def _chunk_bytes(self):
        return math.prod(self._chunk)  # the chunk's dimensions times the element size

    def _size_len(self):
        """Bytes of a filtered chunk's size in the version-4 indexes."""
        return min(8, 1 + ((self._chunk_bytes().bit_length() - 1) + 8) // 8)

    def _grid(self, dims):
        """Chunks along each axis over `dims` (None: unlimited)."""
        return [-(-(d if d is not None else s) // c)
                for d, s, c in zip(dims, self.shape, self._chunk[:-1])]

    def _scaled(self, idx, dims):
        """Row-major linear chunk indices -> element offsets [n, rank]."""
        grid = self._grid(dims)
        grid[0] = max(grid[0], int(np.max(idx, initial=0)) // max(math.prod(grid[1:]), 1) + 1)
        scaled = np.stack(np.unravel_index(np.asarray(idx, np.int64), grid), 1)
        return scaled * np.asarray(self._chunk[:-1], np.int64)

    def _entries(self, data, pos, count, filtered):
        """(addresses, sizes, masks) of `count` chunk entries at data[pos:]:
        an address, then for filtered chunks its size and filter mask."""
        so, sl = self.file.so, self._size_len()
        esize = so + (sl + 4 if filtered else 0)
        raw = np.frombuffer(data, np.uint8, count * esize, pos).reshape(count, esize)

        def field(a, b):
            return (raw[:, a:b].astype(np.uint64) << (8 * np.arange(b - a, dtype=np.uint64))
                    ).sum(1, dtype=np.uint64)

        addrs = field(0, so)
        if filtered:
            return addrs, field(so, so + sl), field(so + sl, so + sl + 4)
        return addrs, np.full(count, self._chunk_bytes(), np.uint64), np.zeros(count, np.uint64)

    def _chunk_index(self):
        """(offsets [n, rank] int64, sizes, filter masks, addresses) of every
        chunk written, read from the chunk index once."""
        if self._index is None:
            rank = len(self._chunk) - 1
            read = {"btree1": self._walk_btree1, "single": self._index_single,
                    "implicit": self._index_implicit, "farray": self._index_farray,
                    "earray": self._index_earray, "btree2": self._index_btree2}[self._kind]
            addr = self._btree if self._kind == "btree1" else self._idx_addr
            if addr == self.file.undef:
                found = []
            else:
                found = read(addr)
            found.sort()
            offs = np.asarray([c[0] for c in found], np.int64).reshape(-1, rank)
            self._index = (offs, [c[1] for c in found], [c[2] for c in found],
                           [c[3] for c in found])
        return self._index

    def _from_linear(self, idx, addrs, sizes, masks, dims):
        keep = addrs != np.uint64(self.file.undef)
        idx, addrs, sizes, masks = idx[keep], addrs[keep], sizes[keep], masks[keep]
        offs = self._scaled(idx, dims)
        return [(tuple(int(v) for v in o), int(s), int(m), int(a))
                for o, s, m, a in zip(offs, sizes, masks, addrs)]

    def _walk_btree1(self, addr):
        found = []
        self._walk(addr, len(self._chunk), found)
        return found

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

    def _index_single(self, addr):
        size, mask = self._single or (self._chunk_bytes(), 0)
        return [((0,) * (len(self._chunk) - 1), size, mask, addr)]

    def _index_implicit(self, addr):
        """Every chunk of the grid over the maximum shape, in order from addr."""
        n = math.prod(self._grid(self._maxshape))
        idx = np.arange(n, dtype=np.int64)
        addrs = np.uint64(addr) + idx.astype(np.uint64) * np.uint64(self._chunk_bytes())
        sizes = np.full(n, self._chunk_bytes(), np.uint64)
        return self._from_linear(idx, addrs, sizes, np.zeros(n, np.uint64), self._maxshape)

    def _index_farray(self, addr):
        f, where = self.file, self._where
        hdr = f.read(addr, 8 + f.sl + f.so + 4)
        if hdr[:4] != b"FAHD":
            raise ValueError(f"{where}: no fixed array header at {addr}")
        _verify(hdr, where)
        filtered, esize, page_bits = hdr[5] == 1, hdr[6], hdr[7]
        n, daddr = f.length(hdr, 8), f.offset(hdr, 8 + f.sl)
        if daddr == f.undef:
            return []
        page = 1 << page_bits
        head = 6 + f.so
        if n <= page:  # one block of elements
            data = f.read(daddr, head + n * esize + 4)
            if data[:4] != b"FADB":
                raise ValueError(f"{where}: no fixed array data block at {daddr}")
            _verify(data, where)
            parts = [(np.arange(n), self._entries(data, head, n, filtered))]
        else:  # paged: a bitmap of the pages written, then the pages
            npages = -(-n // page)
            bitmap_len = (npages + 7) // 8
            data = f.read(daddr, head + bitmap_len + 4)
            if data[:4] != b"FADB":
                raise ValueError(f"{where}: no fixed array data block at {daddr}")
            _verify(data, where)
            parts, at = [], daddr + head + bitmap_len + 4
            for p in range(npages):
                m = min(page, n - p * page)
                if data[head + p // 8] & (0x80 >> (p % 8)):
                    pdata = f.read(at, m * esize + 4)
                    _verify(pdata, where)
                    parts.append((p * page + np.arange(m), self._entries(pdata, 0, m, filtered)))
                at += page * esize + 4
        return self._linear_parts(parts, self._maxshape)

    def _linear_parts(self, parts, dims):
        found = []
        for idx, (addrs, sizes, masks) in parts:
            found += self._from_linear(np.asarray(idx, np.int64), addrs, sizes, masks, dims)
        return found

    def _index_earray(self, addr):
        """An extensible array's elements: the index block's own, its data
        blocks', and those of the super blocks it points to."""
        f, where, so = self.file, self._where, self.file.so
        if any(m is None for m in self._maxshape[1:]):
            raise NotImplementedError(f"{where}: an extensible-array chunk index over a "
                                      "dimension other than the first")
        hdr = f.read(addr, 12 + 6 * f.sl + so + 4)
        if hdr[:4] != b"EAHD":
            raise ValueError(f"{where}: no extensible array header at {addr}")
        _verify(hdr, where)
        filtered, esize = hdr[5] == 1, hdr[6]
        max_bits, idx_elmts, min_elmts, min_ptrs, page_bits = hdr[7:12]
        iaddr = f.offset(hdr, 12 + 6 * f.sl)
        if iaddr == f.undef:
            return []
        page = 1 << page_bits
        off_size = (max_bits + 7) // 8
        # super blocks: data blocks a block and elements a data block
        nsblks = 1 + max_bits - (min_elmts.bit_length() - 1)
        sb_ndblks = [1 << (u // 2) for u in range(nsblks)]
        sb_nelmts = [(1 << ((u + 1) // 2)) * min_elmts for u in range(nsblks)]
        sb_start = np.concatenate([[0], np.cumsum(np.multiply(sb_ndblks, sb_nelmts))])
        iblk_sblks = 2 * (min_ptrs.bit_length() - 1)
        ndblk_addrs = 2 * (min_ptrs - 1)
        nsblk_addrs = nsblks - iblk_sblks
        ib = f.read(iaddr, 6 + so + idx_elmts * esize + (ndblk_addrs + nsblk_addrs) * so + 4)
        if ib[:4] != b"EAIB":
            raise ValueError(f"{where}: no extensible array index block at {iaddr}")
        _verify(ib, where)
        parts = [(np.arange(idx_elmts), self._entries(ib, 6 + so, idx_elmts, filtered))]
        pos = 6 + so + idx_elmts * esize
        dblks = []  # (address, first element index, elements)
        u, k = 0, 0
        for j in range(ndblk_addrs):  # the data blocks of the first super blocks
            while k >= sb_ndblks[u]:
                u, k = u + 1, 0
            dblks.append((f.offset(ib, pos + j * so),
                          idx_elmts + int(sb_start[u]) + k * sb_nelmts[u], sb_nelmts[u], None))
            k += 1
        pos += ndblk_addrs * so
        for j in range(nsblk_addrs):
            saddr, u = f.offset(ib, pos + j * so), iblk_sblks + j
            if saddr == f.undef:
                continue
            nd, ne = sb_ndblks[u], sb_nelmts[u]
            npages = ne // page if ne > page else 0
            init = (npages + 7) // 8 if npages else 0
            sb = f.read(saddr, 6 + so + off_size + nd * init + nd * so + 4)
            if sb[:4] != b"EASB":
                raise ValueError(f"{where}: no extensible array super block at {saddr}")
            _verify(sb, where)
            at = 6 + so + off_size
            bitmap = sb[at:at + nd * init]  # one bit a page, data block by data block
            for d in range(nd):
                dblks.append((f.offset(sb, at + nd * init + d * so),
                              idx_elmts + int(sb_start[u]) + d * ne, ne,
                              (bitmap, d * npages) if npages else None))
        for daddr, first, ne, bitmap in dblks:
            if daddr == f.undef:
                continue
            head = 6 + so + off_size
            if bitmap is None:
                data = f.read(daddr, head + ne * esize + 4)
                if data[:4] != b"EADB":
                    raise ValueError(f"{where}: no extensible array data block at {daddr}")
                _verify(data, where)
                parts.append((first + np.arange(ne), self._entries(data, head, ne, filtered)))
                continue
            bitmap, bit0 = bitmap
            for p in range(ne // page):  # paged: pages follow the block's prefix
                if bitmap[(bit0 + p) // 8] & (0x80 >> ((bit0 + p) % 8)):
                    pdata = f.read(daddr + head + 4 + p * (page * esize + 4), page * esize + 4)
                    _verify(pdata, where)
                    parts.append((first + p * page + np.arange(page),
                                  self._entries(pdata, 0, page, filtered)))
        return self._linear_parts(parts, self._maxshape)

    def _index_btree2(self, addr):
        btype, records = _btree2_records(self.file, addr, self._where)
        so, rank = self.file.so, len(self._chunk) - 1
        found = []
        for rec in records:
            if btype == 10:
                size, mask, pos = self._chunk_bytes(), 0, so
            elif btype == 11:
                sl = self._size_len()
                size, mask, pos = _uint(rec, so, sl), _uint(rec, so + sl, 4), so + sl + 4
            else:
                raise ValueError(f"{self._where}: a chunk B-tree of record type {btype}")
            scaled = struct.unpack_from(f"<{rank}Q", rec, pos)
            found.append((tuple(s * c for s, c in zip(scaled, self._chunk)), size, mask,
                          self.file.offset(rec, 0)))
        return found

    # ------------------------------------------------------------ chunk data

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
            elif fid == 3:  # fletcher32: a 4-byte checksum after the data
                stored, want = _uint(raw, len(raw) - 4, 4), fletcher32(raw[:-4])
                # HDF5 also takes the checksum with its bytes swapped pairwise
                swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
                if stored not in (want, swapped):
                    raise ValueError(f"{self._where}: fletcher32 checksum mismatch in the "
                                     f"chunk at {addr} (a corrupted file)")
                raw = raw[:-4]
            elif fid == 32000:
                raw = _lzf_decode(raw, self._where)
            else:
                raw = _scaleoffset_decode(raw, values, self.dtype, self._where)
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
            o = offs[j]
            if any(o[d] >= self.shape[d] for d in range(1, len(dims))):
                continue  # a chunk of the grid past the shape
            chunk = self._decode_chunk(addrs[j], sizes[j], masks[j])
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
