"""H5 event streams (the TUM-VIE / EDS formats): `EventSlicer`,
`compute_ms_to_idx` and the fixture writers.

Counterpart of enerf_tpu/data/h5events.py (reference
utils/event_utils.py:223-407), read and written with the port's own HDF5
code (utils/hdf5.py), since the card has no h5py.  A window is found from
the millisecond table (a conservative [floor, ceil] ms range), then
refined with searchsorted on the time-sorted stream, so that
t_start_us <= t < t_end_us; only the rows of that range are read.
"""

import math

import numpy as np

from enerf_torch.utils import hdf5


def compute_ms_to_idx(tss, ms_start=0, tick_ns=1_000_000):
    """Millisecond -> first-event-index table (event_utils.py:389-407).

    tss: sorted event timestamps; tick_ns: nanoseconds per table tick
    (1e6 for ns timestamps, 1e3 for the us timestamps of tumvie / eds).
    """
    tss = np.asarray(tss)
    ms_end = int(math.floor(tss.max() / tick_ns))
    assert ms_end >= ms_start
    ms_window = np.arange(ms_start, ms_end + 1, 1, dtype=np.uint64)
    return np.searchsorted(tss, ms_window * tick_ns, side="left").astype(np.int64)


class EventSlicer:
    """Window queries over an open H5 event stream (x, y, t, p and
    ms_to_idx, flat or under events/, with an optional t_offset)."""

    def __init__(self, h5f):
        self.h5f = h5f
        prefix = "events/" if "events/x" in h5f else ""
        self.events = {k: h5f[prefix + k] for k in ("p", "x", "y", "t")}
        self.ms_to_idx = np.asarray(h5f["ms_to_idx"], dtype="int64")
        self.t_offset = int(h5f["t_offset"][()]) if "t_offset" in h5f.keys() else 0
        self.t_final = int(self.events["t"][-1]) + self.t_offset

    def get_start_time_us(self):
        return self.t_offset

    def get_final_time_us(self):
        return self.t_final

    @staticmethod
    def get_conservative_window_ms(ts_start_us, ts_end_us):
        assert ts_end_us > ts_start_us
        return math.floor(ts_start_us / 1000), math.ceil(ts_end_us / 1000)

    def ms2idx(self, time_ms):
        assert time_ms >= 0
        if time_ms >= self.ms_to_idx.size:
            return None
        return int(self.ms_to_idx[time_ms])

    def get_events(self, t_start_us, t_end_us):
        """Events with t_start_us <= t < t_end_us, or None if out of range."""
        assert t_start_us < t_end_us
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset
        t_start_ms, t_end_ms = self.get_conservative_window_ms(t_start_us, t_end_us)
        t_start_ms = max(t_start_ms, 0)
        lo = self.ms2idx(t_start_ms)
        hi = self.ms2idx(t_end_ms)
        if hi is None and t_end_ms >= self.ms_to_idx.size:
            # a conservative end past the table: every remaining event (the
            # JAX package's robustness over the reference, which returns None)
            hi = int(self.events["t"].shape[0])
        if lo is None or hi is None:
            return None
        t_cons = np.asarray(self.events["t"][lo:hi])
        if t_cons.size == 0:
            return {k: np.asarray([]) for k in ("p", "x", "y", "t")}
        i0 = int(np.searchsorted(t_cons, t_start_us, side="left"))
        i1 = int(np.searchsorted(t_cons, t_end_us, side="left"))
        out = {"t": t_cons[i0:i1] + self.t_offset}
        for k in ("p", "x", "y"):
            out[k] = np.asarray(self.events[k][lo + i0:lo + i1])
            assert out[k].size == out["t"].size
        return out


def write_event_h5(path, x, y, t_us, p, t_offset=None, grouped=False):
    """An event stream in the tumvie / eds H5 layout: x, y uint16, t int64
    microseconds (sorted; EventSlicer adds t_offset to them), p int8, flat
    or under events/, ms_to_idx and an optional scalar t_offset."""
    t_us = np.asarray(t_us)
    assert np.all(np.diff(t_us) >= 0)
    g = "events/" if grouped else ""
    data = {g + "x": np.asarray(x, np.uint16), g + "y": np.asarray(y, np.uint16),
            g + "t": t_us.astype(np.int64), g + "p": np.asarray(p, np.int8),
            "ms_to_idx": compute_ms_to_idx(t_us, tick_ns=1000)}
    if t_offset is not None:
        data["t_offset"] = np.int64(t_offset)
    return hdf5.write_datasets(path, data)


def write_rectify_map(path, map_xy):
    """Rectify (undistortion) map H5: [H, W, 2] float32 target coords."""
    return hdf5.write_datasets(path, {"rectify_map": np.asarray(map_xy, np.float32)})


def load_rectify_map(path):
    with hdf5.File(path) as f:
        return np.asarray(f["rectify_map"])
