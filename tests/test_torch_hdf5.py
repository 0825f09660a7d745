"""The port's HDF5 reader and writer (enerf_torch/utils/hdf5.py) against
h5py: files h5py writes at each `libver` ('earliest', 'v108', 'v110',
'latest': superblocks 0-3, version-1 and -2 object headers) read equal,
slice by slice: the event streams' dtypes and big-endian ones, scalars,
contiguous, compact and chunked data with deflate, shuffle, fletcher32,
lzf and scale-offset (values 7 bits and many bits wide; full-range ones,
which HDF5 cannot read back, against the data written), every chunk
index (version-1 B-trees of several levels, single chunk, implicit,
fixed arrays with pages, extensible arrays with super blocks, version-2
B-trees), continuation blocks, fill values,
symbol-table, compact and dense groups (fractal heaps, name and
creation-order indexes); a corrupted checksum and a corrupted fletcher32
raise; files the port writes read back equal through h5py; and what the
reader does not support raises, naming it."""

import h5py
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_tpu.data import h5events as jh5
from enerf_torch.data import h5events as th5
from enerf_torch.utils import hdf5

DTYPES = [np.uint16, np.int8, np.int64, np.float32, np.float64, np.uint8, np.int16,
          np.uint32, np.int32, np.uint64]
BIG_ENDIAN = [">i8", ">u2", ">f4", ">f8"]
LIBVERS = ["earliest", "v108", "v110", "latest"]


def _data(dtype, shape, seed=0, span="full"):
    """Random values of a dtype.  Integers: span "full" over the whole
    range; "narrow" in [3, 100) (7 bits a value under scale-offset);
    "wide" over a quarter of the range (2 bits short of the width: 14 for
    16-bit types, 62 or 63 for 64-bit ones).  HDF5's own scale-offset
    filter fails to read back full-range integers of any width, so h5py
    is the reference only for the other two."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.normal(size=shape).astype(dtype)
    if span == "narrow":
        return rng.integers(3, 100, size=shape).astype(dtype)
    info = np.iinfo(dtype)
    lo, hi = info.min, info.max
    if span == "wide":
        lo, hi = lo // 4, hi // 4
    return rng.integers(lo, hi, size=shape, dtype=dtype.newbyteorder("="),
                        endpoint=True).astype(dtype)


def _early_allocation():
    """A dataset creation property list with early allocation: HDF5's
    implicit chunk index (libver v110 and later) for unfiltered chunks."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _slices(n):
    """Row selections along the first axis: whole, single rows, spans
    across chunk boundaries, empty and stepped slices."""
    return [(), 0, -1, n // 2, slice(None), slice(3, 3), slice(n, n + 5), slice(1, n - 1),
            slice(7, 70), slice(60, 61), slice(-9, None), slice(None, None, 5),
            slice(2, n - 1, 7)]


def _assert_same(got, ref):
    assert type(got) is type(ref) or (isinstance(ref, np.ndarray) and isinstance(got, np.ndarray))
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


STORAGE = {
    "contiguous": {},
    "gzip": dict(chunks=(64,), compression="gzip"),
    "shuffle_gzip": dict(chunks=(64,), compression="gzip", shuffle=True),
    "fletcher32": dict(chunks=(50,), fletcher32=True),
    "shuffle_gzip_fletcher32": dict(chunks=(33,), compression="gzip", compression_opts=9,
                                    shuffle=True, fletcher32=True),
    "chunked_plain": dict(chunks=(16,)),
    # a fixed array index of more than one 1024-entry page from v110 on
    "paged": dict(chunks=(3,)),
    "lzf": dict(chunks=(100,), compression="lzf", shuffle=True),
    "scaleoffset": dict(chunks=(64,), scaleoffset=0),
    # the same with values many bits wide: multi-byte unpacking, either byte order
    "scaleoffset_wide": dict(chunks=(64,), scaleoffset=0),
    # an extensible array index from v110 on (an appending recorder's layout)
    "extensible_gzip": dict(chunks=(20,), maxshape=(None,), compression="gzip"),
    "extensible_lzf": dict(chunks=(64,), maxshape=(None,), compression="lzf"),
    "single_chunk": dict(chunks=(4000,)),
    "single_chunk_gzip": dict(chunks=(4000,), compression="gzip", fletcher32=True),
    "implicit": dict(chunks=(64,), dcpl="early"),
}


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("storage", list(STORAGE))
def test_reader_matches_h5py_on_1d_datasets(tmp_path, storage, libver):
    """Every dtype of the event streams (and the other integers, and
    big-endian ones) in every storage at every libver; 4,000 rows make the
    chunked datasets' version-1 B-trees two levels deep (more than 64
    chunks)."""
    path = str(tmp_path / "a.h5")
    dtypes = DTYPES + BIG_ENDIAN
    span = {"scaleoffset": "narrow", "scaleoffset_wide": "wide"}.get(storage, "full")
    if span != "full":  # scale-offset, on integers only
        dtypes = [dt for dt in dtypes if np.dtype(dt).kind != "f"]
    arrays = {f"d_{np.dtype(dt).str[1:]}_{i}": _data(dt, (4000,), i, span)
              for i, dt in enumerate(dtypes)}
    kw = dict(STORAGE[storage])
    if kw.get("dcpl") == "early":
        kw["dcpl"] = _early_allocation()
    with h5py.File(path, "w", libver=libver) as f:
        for name, a in arrays.items():
            f.create_dataset(name, data=a, **kw)
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert sorted(got.keys()) == sorted(ref.keys())
        for name in arrays:
            dg, dr = got[name], ref[name]
            assert dg.shape == dr.shape and dg.dtype == dr.dtype and len(dg) == 4000
            _assert_same(np.asarray(dg), np.asarray(dr))
            for key in _slices(4000):
                _assert_same(dg[key], dr[key])


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_scaleoffset_reads_full_range_integers(tmp_path, libver):
    """Integers over their whole range: scale-offset stores each chunk
    whole, in the writer's byte order (H5Zscaleoffset.c's full-precision
    case).  HDF5's own filter fails to read these back, so the reference
    is the data written."""
    path = str(tmp_path / "so.h5")
    arrays = {f"d_{np.dtype(dt).str[1:]}_{i}": _data(dt, (700,), i)
              for i, dt in enumerate(DTYPES + BIG_ENDIAN) if np.dtype(dt).kind != "f"}
    with h5py.File(path, "w", libver=libver) as f:
        for name, a in arrays.items():
            f.create_dataset(name, data=a, chunks=(64,), scaleoffset=0)
    with hdf5.File(path) as got:
        for name, a in arrays.items():
            _assert_same(got[name][()], a)
            _assert_same(got[name][5:300], a[5:300])


ND_STORAGE = ["contiguous", "compact", "chunked_gzip", "chunked_edges", "extensible_rows",
              "btree2", "btree2_lzf"]


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("storage", ND_STORAGE)
def test_reader_matches_h5py_on_nd_datasets(tmp_path, storage, libver):
    """A rectify map's shape ([H, W, 2] float32) and an int16 cube; chunks
    that do not divide the shape leave partial edge chunks; rows that can
    grow (an extensible array from v110 on) and every axis unlimited (a
    version-2 B-tree index from v110 on)."""
    path = str(tmp_path / "nd.h5")
    arrays = {"rectify_map": _data(np.float32, (37, 29, 2), 1),
              "cube": _data(np.int16, (40, 3, 5), 2)}
    with h5py.File(path, "w", libver=libver) as f:
        for name, a in arrays.items():
            kw = {}
            if storage == "compact":
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                kw["dcpl"] = dcpl
            elif storage == "chunked_gzip":
                kw = dict(chunks=(8,) + a.shape[1:], compression="gzip", shuffle=True)
            elif storage == "chunked_edges":
                kw = dict(chunks=(6, 4, 2) if name == "rectify_map" else (6, 2, 3),
                          compression="gzip")
            elif storage == "extensible_rows":
                kw = dict(chunks=(5,) + a.shape[1:], maxshape=(None,) + a.shape[1:],
                          compression="gzip")
            elif storage.startswith("btree2"):
                kw = dict(chunks=(6, 4, 2) if name == "rectify_map" else (6, 2, 3),
                          maxshape=(None,) * 3,
                          compression="lzf" if storage == "btree2_lzf" else None)
            f.create_dataset(name, data=a, **kw)
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        for name, a in arrays.items():
            _assert_same(got[name][()], ref[name][()])
            _assert_same(np.asarray(got[name]), a)
            for key in _slices(a.shape[0]):
                _assert_same(got[name][key], ref[name][key])


@pytest.mark.parametrize("libver", LIBVERS)
def test_reader_on_scalars_groups_continuations_and_fill_values(tmp_path, libver):
    """Scalar datasets of each kind (t_offset is an int64 scalar), nested
    groups, an object header that spills into continuation blocks (many
    attributes, which the reader skips), and chunks never written (the
    fill value)."""
    path = str(tmp_path / "misc.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("t_offset", data=np.int64(1_234_567_890_123))
        f.create_dataset("f32", data=np.float32(2.5))
        f.create_dataset("u8", data=np.uint8(200))
        g = f.create_group("a").create_group("b")
        d = g.create_dataset("x", data=np.arange(300, dtype=np.int64))
        for i in range(40):
            d.attrs[f"attribute_{i:02d}"] = np.arange(i + 1, dtype=np.float64)
        sparse = f.create_dataset("sparse", shape=(500,), dtype=np.int32, chunks=(64,),
                                  fillvalue=-7, compression="gzip")
        sparse[100:130] = np.arange(30)
        f.create_dataset("empty", data=np.zeros((0,), np.uint16))
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        for name in ("t_offset", "f32", "u8"):
            _assert_same(got[name][()], ref[name][()])
            assert got[name].shape == ()
        assert int(got["t_offset"][()]) == 1_234_567_890_123
        assert "a/b/x" in got and "/a/b" in got and "a/c" not in got and "t_offset/x" not in got
        assert got["a"].keys() == ["b"]
        _assert_same(got["a/b/x"][()], ref["a/b/x"][()])
        _assert_same(got["a"]["b/x"][250:], ref["a/b/x"][250:])
        for key in _slices(500):
            _assert_same(got["sparse"][key], ref["sparse"][key])
        _assert_same(got["empty"][()], ref["empty"][()])
        with pytest.raises(KeyError):
            got["nothing"]
        with pytest.raises(IndexError):
            got["a/b/x"][300]
        with pytest.raises(IndexError):
            got["t_offset"][0]


@pytest.mark.parametrize("libver", LIBVERS)
def test_reader_on_compact_and_dense_groups(tmp_path, libver):
    """Groups of 3 links (compact: link messages in the header from v108
    on), 40 links (dense: a fractal heap and its name index) and 1,500
    links (the heap's indirect blocks and a two-level name index), and
    groups that track creation order (the creation-order index), nested."""
    path = str(tmp_path / "groups.h5")
    sizes = {"small": 3, "dense": 40, "wide": 1500}
    with h5py.File(path, "w", libver=libver) as f:
        for gname, n in sizes.items():
            g = f.create_group(gname)
            for i in range(n):
                g.create_dataset(f"link_{i:04d}_{'x' * (i % 13)}", data=np.int32(i))
        for n in (2, 12):
            g = f.create_group(f"ordered_{n}", track_order=True)
            for i in range(n):
                sub = g.create_group(f"z{n - i:02d}", track_order=True)
                sub.create_dataset("v", data=np.arange(i + 1, dtype=np.uint16))
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert sorted(got.keys()) == sorted(ref.keys())
        for gname in list(sizes) + ["ordered_2", "ordered_12"]:
            assert sorted(got[gname].keys()) == sorted(ref[gname].keys())
            for name in ref[gname].keys():
                r = ref[gname][name]
                key = f"{gname}/{name}" + ("/v" if isinstance(r, h5py.Group) else "")
                _assert_same(got[key][()], ref[key][()])
        assert "wide/link_0007_xxxxxxx" in got and "wide/link_0007" not in got


def _corrupt(path, at):
    with open(path, "r+b") as fh:
        fh.seek(at)
        byte = fh.read(1)
        fh.seek(at)
        fh.write(bytes([byte[0] ^ 0x10]))


@pytest.mark.parametrize("case", ["checksum", "fletcher32"])
def test_corrupted_files_raise(tmp_path, case):
    """One flipped bit: in a dataset's version-2 object header (its lookup3
    checksum), or in a chunk under fletcher32 (its Fletcher-32); h5py
    refuses both too."""
    path = str(tmp_path / f"{case}.h5")
    data = np.arange(1000, dtype=np.int64)
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", data=data, chunks=(100,), fletcher32=True)
        chunk = d.id.get_chunk_info(3).byte_offset
    with hdf5.File(path) as f:
        _assert_same(f["x"][()], data)
    header = open(path, "rb").read().rindex(b"OHDR")  # the dataset's, after the root's
    _corrupt(path, header + 40 if case == "checksum" else chunk + 17)
    with pytest.raises((OSError, KeyError)):  # h5py: the header's checksum as a KeyError
        with h5py.File(path, "r") as f:
            f["x"][()]
    with pytest.raises(ValueError, match="checksum mismatch"):
        with hdf5.File(path) as f:
            f["x"][()]


@pytest.mark.parametrize("grouped,t_offset", [(False, None), (True, None), (False, 12_345),
                                              (True, 987_654_321)])
def test_event_files_both_ways(tmp_path, grouped, t_offset):
    """An event stream written by JAX's write_event_h5 (h5py) reads equal
    through the port's reader, and the port's write_event_h5 writes a file
    that h5py reads back equal, dataset by dataset."""
    rng = np.random.default_rng(3)
    n = 2000
    t_us = np.sort(rng.integers(0, 700_000, n))
    x, y = rng.integers(0, 1280, n), rng.integers(0, 720, n)
    p = rng.integers(0, 2, n)
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jh5.write_event_h5(jpath, x, y, t_us, p, t_offset=t_offset, grouped=grouped)
    th5.write_event_h5(tpath, x, y, t_us, p, t_offset=t_offset, grouped=grouped)
    names = [("events/" if grouped else "") + k for k in "xytp"] + ["ms_to_idx"]
    names += ["t_offset"] if t_offset is not None else []
    with h5py.File(jpath, "r") as ref, hdf5.File(jpath) as got, h5py.File(tpath, "r") as back:
        assert sorted(back.keys()) == sorted(ref.keys())
        for name in names:
            _assert_same(got[name][()], ref[name][()])
            _assert_same(back[name][()], ref[name][()])
            assert back[name].dtype == ref[name].dtype and back[name].shape == ref[name].shape


def test_writer_round_trips_through_h5py(tmp_path):
    """write_datasets: every supported dtype, scalars and N-d arrays,
    nested groups and a group wider than one symbol table node's default
    capacity (8 entries), read back equal by h5py and by the port."""
    path = str(tmp_path / "w.h5")
    data = {f"wide/d{i:02d}": _data(DTYPES[i % len(DTYPES)], (i + 1,), i) for i in range(20)}
    data.update({"rectify_map": _data(np.float32, (12, 10, 2)), "t_offset": np.int64(-5),
                 "deep/er/still/f64": np.float64(3.25), "empty": np.zeros((0, 3), np.int8),
                 "big_endian": np.arange(6, dtype=">i4")})
    hdf5.write_datasets(path, data)
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert sorted(ref["wide"].keys()) == sorted(k.split("/")[1] for k in data if "wide" in k)
        for name, a in data.items():
            want = np.asarray(a).astype(np.asarray(a).dtype.newbyteorder("<"))
            _assert_same(np.asarray(ref[name][()]), want)
            _assert_same(np.asarray(got[name][()]), want)
    with pytest.raises(TypeError):
        hdf5.write_datasets(str(tmp_path / "bad.h5"), {"b": np.ones(3, bool)})
    with pytest.raises(ValueError):
        hdf5.write_datasets(str(tmp_path / "bad.h5"), {"a": np.ones(3), "a/b": np.ones(3)})


@pytest.mark.parametrize("case", ["szip", "external", "string", "compound", "vlen_string"])
def test_unsupported_structures_raise_naming_them(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    match = {"szip": "filter 4 \\(szip\\)", "external": "external storage",
             "string": "class 3 \\(string\\)", "compound": "class 6 \\(compound\\)",
             "vlen_string": "class 9 \\(variable-length\\)"}[case]
    with h5py.File(path, "w", libver="latest") as f:
        if case == "szip":
            f.create_dataset("x", data=np.arange(1000), chunks=(100,), compression="szip")
        elif case == "external":
            f.create_dataset("x", shape=(10,), dtype="i8",
                             external=[(str(tmp_path / "x.bin"), 0, 80)])
        elif case == "string":
            f.create_dataset("x", data=np.bytes_("abc"))
        elif case == "compound":
            f.create_dataset("x", data=np.zeros(3, dtype=[("a", "<i4"), ("b", "<f8")]))
        else:
            f.create_dataset("x", data=np.array(["ab", "cde"], dtype=h5py.string_dtype()))
    with pytest.raises(NotImplementedError, match=match):
        with hdf5.File(path) as f:
            f["x"][()]
