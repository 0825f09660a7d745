"""The port's HDF5 reader and writer (enerf_torch/utils/hdf5.py) against
h5py: files h5py writes (flat and grouped, the event streams' dtypes,
scalars, contiguous, compact and chunked data with deflate, shuffle and
fletcher32, multi-level chunk B-trees, continuation blocks, fill values)
read equal, slice by slice; files the port writes read back equal through
h5py; and what the reader does not support raises, naming it."""

import h5py
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_tpu.data import h5events as jh5
from enerf_torch.data import h5events as th5
from enerf_torch.utils import hdf5

DTYPES = [np.uint16, np.int8, np.int64, np.float32, np.float64, np.uint8, np.int16,
          np.uint32, np.int32, np.uint64]


def _data(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)


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
}


@pytest.mark.parametrize("storage", list(STORAGE))
def test_reader_matches_h5py_on_1d_datasets(tmp_path, storage):
    """Every dtype of the event streams (and the other integers) in every
    storage; 4,000 rows make the chunked datasets' B-trees two levels deep
    (more than 64 chunks)."""
    path = str(tmp_path / "a.h5")
    arrays = {f"d_{np.dtype(dt).name}": _data(dt, (4000,), i) for i, dt in enumerate(DTYPES)}
    with h5py.File(path, "w") as f:
        for name, a in arrays.items():
            f.create_dataset(name, data=a, **STORAGE[storage])
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert sorted(got.keys()) == sorted(ref.keys())
        for name in arrays:
            dg, dr = got[name], ref[name]
            assert dg.shape == dr.shape and dg.dtype == dr.dtype and len(dg) == 4000
            _assert_same(np.asarray(dg), np.asarray(dr))
            for key in _slices(4000):
                _assert_same(dg[key], dr[key])


@pytest.mark.parametrize("storage", ["contiguous", "compact", "chunked_gzip", "chunked_edges"])
def test_reader_matches_h5py_on_nd_datasets(tmp_path, storage):
    """A rectify map's shape ([H, W, 2] float32) and an int16 cube; chunks
    that do not divide the shape leave partial edge chunks."""
    path = str(tmp_path / "nd.h5")
    arrays = {"rectify_map": _data(np.float32, (37, 29, 2), 1),
              "cube": _data(np.int16, (40, 3, 5), 2)}
    with h5py.File(path, "w") as f:
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
            f.create_dataset(name, data=a, **kw)
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        for name, a in arrays.items():
            _assert_same(got[name][()], ref[name][()])
            _assert_same(np.asarray(got[name]), a)
            for key in _slices(a.shape[0]):
                _assert_same(got[name][key], ref[name][key])


def test_reader_on_scalars_groups_continuations_and_fill_values(tmp_path):
    """Scalar datasets of each kind (t_offset is an int64 scalar), nested
    groups, an object header that spills into continuation blocks (many
    attributes, which the reader skips), and chunks never written (the
    fill value)."""
    path = str(tmp_path / "misc.h5")
    with h5py.File(path, "w") as f:
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


@pytest.mark.parametrize("case", ["lzf", "libver_latest", "big_endian", "string",
                                  "creation_order_group"])
def test_unsupported_structures_raise_naming_them(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    match = {"lzf": "filter 32000 \\(lzf\\)", "libver_latest": "superblock version 3",
             "big_endian": "big-endian", "string": "class 3 \\(string\\)",
             "creation_order_group": "version-2 object headers"}[case]
    with h5py.File(path, "w", libver="latest" if case == "libver_latest" else "earliest") as f:
        if case == "lzf":
            f.create_dataset("x", data=np.arange(100), compression="lzf")
        elif case == "big_endian":
            f.create_dataset("x", data=np.arange(10, dtype=">i8"))
        elif case == "string":
            f.create_dataset("x", data=np.bytes_("abc"))
        elif case == "creation_order_group":
            f.create_group("x", track_order=True)  # link messages in a v2 header
        else:
            f.create_dataset("x", data=np.arange(10))
    with pytest.raises(NotImplementedError, match=match):
        with hdf5.File(path) as f:
            f["x"][()]
