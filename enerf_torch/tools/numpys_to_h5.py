"""Convert esim per-interval event .npy files into one H5 with ms_to_idx.

Counterpart of scripts/numpys_to_h5.py (reference scripts/numpys_to_h5.py),
written through the port's HDF5 writer (no h5py):

  python -m enerf_torch.tools.numpys_to_h5 --datadir DATA/seq [--out events.h5]

reads DATA/seq/events/*.npy (rows x, y, t_ns, polarity), sorts them by
time and writes x, y, t (microseconds), p (0 / 1) and ms_to_idx, with
t_offset 0 (default out: DATA/seq/events.h5).
"""

import argparse
import glob
import os

import numpy as np

from enerf_torch.data.h5events import write_event_h5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--datadir", required=True, help="dir containing events/*.npy")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.datadir, "events", "*.npy")))
    if not files:
        raise SystemExit(f"no event npys under {args.datadir}/events")
    evs = np.concatenate([np.load(f)[:, :4] for f in files])
    evs = evs[np.argsort(evs[:, 2], kind="stable")]
    t_us = evs[:, 2] / 1000.0  # esim stamps are ns; the H5 layout stores us
    p = evs[:, 3]
    p01 = (p > 0).astype(np.int8) if set(np.unique(p)) <= {-1.0, 1.0} else p.astype(np.int8)
    out = args.out or os.path.join(args.datadir, "events.h5")
    write_event_h5(out, evs[:, 0], evs[:, 1], t_us, p01, t_offset=0)
    print(f"wrote {len(evs)} events -> {out}")


if __name__ == "__main__":
    main()
