"""Inspect or repair an event H5: print its stats, rebuild ms_to_idx,
draw an event-accumulation image.

Counterpart of scripts/inspect_h5.py (reference
scripts/ms_to_idx_and_vis_h5.py + plot_h5.py), on the port's HDF5 reader
and writer and PNG writer (no h5py, no OpenCV):

  python -m enerf_torch.tools.inspect_h5 events.h5 [--fix_ms_to_idx] [--vis out.png] [--n_vis N]

prints the event count, the time span, x / y / p ranges and dtypes,
t_offset and whether ms_to_idx is present.  --fix_ms_to_idx rebuilds
ms_to_idx from t (microseconds): the port's HDF5 code cannot update a
file in place, so it writes the whole file anew (every dataset, the
grouped or flat layout, t_offset) to a temporary file beside it and moves
that over the original.  --vis draws the first --n_vis events (positive
red, negative blue, on white) into a PNG.
"""

import argparse
import os
import tempfile

import numpy as np

from enerf_torch.data.h5events import compute_ms_to_idx
from enerf_torch.utils import hdf5
from enerf_torch.utils.plotting import render_ev_accumulation
from enerf_torch.utils.png import write_png


def read_all(group, prefix=""):
    """{"a/b": array or numpy scalar} of every dataset under a group."""
    out = {}
    for name in group.keys():
        obj = group[name]
        if isinstance(obj, hdf5.Group):
            out.update(read_all(obj, prefix + name + "/"))
        else:
            value = np.asarray(obj[()])
            out[prefix + name] = value[()] if value.ndim == 0 else value
    return out


def rewrite(path, datasets):
    """Write `datasets` to a temporary file beside `path`, then move it
    over `path`."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)), suffix=".h5")
    os.close(fd)
    try:
        hdf5.write_datasets(tmp, datasets)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("h5", help="event h5 file")
    ap.add_argument("--fix_ms_to_idx", action="store_true")
    ap.add_argument("--vis", default=None, help="write accumulation png")
    ap.add_argument("--n_vis", type=int, default=200000)
    args = ap.parse_args(argv)

    new_idx = None
    with hdf5.File(args.h5) as f:
        prefix = "events/" if "events/x" in f else ""
        t = f[prefix + "t"]
        n = t.shape[0]
        print(f"{args.h5}: {n} events")
        print(f"  t: [{t[0]}, {t[-1]}] ({(int(t[-1]) - int(t[0])) / 1e6:.3f} s if us)")
        for k in ("x", "y", "p"):
            d = f[prefix + k]
            print(f"  {k}: min={d[:].min()} max={d[:].max()} dtype={d.dtype}")
        if "t_offset" in f.keys():
            print(f"  t_offset: {int(f['t_offset'][()])}")
        has_idx = "ms_to_idx" in f.keys()
        print(f"  ms_to_idx: {'present' if has_idx else 'MISSING'}")
        if args.fix_ms_to_idx:
            new_idx = compute_ms_to_idx(np.asarray(t), tick_ns=1000)
            datasets = read_all(f)
            datasets["ms_to_idx"] = new_idx
            print(f"  rebuilt ms_to_idx ({len(new_idx)} entries)")
        if args.vis:
            k = min(args.n_vis, n)
            xs = np.asarray(f[prefix + "x"][:k])
            ys = np.asarray(f[prefix + "y"][:k])
            # widen before the {0, 1} -> {-1, 1} remap: uint8 0 * 2 - 1 wraps
            ps = np.asarray(f[prefix + "p"][:k]).astype(np.int16)
            H, W = int(ys.max()) + 1, int(xs.max()) + 1
            img = render_ev_accumulation(xs, ys, ps * 2 - 1 if ps.min() >= 0 else ps, H, W)
            write_png(args.vis, img.numpy())
            print(f"  wrote {args.vis}")
    if new_idx is not None:
        rewrite(args.h5, datasets)


if __name__ == "__main__":
    main()
