"""Convert raw .npy renders to PNGs, with min-max contrast-spread copies.

Counterpart of scripts/raw_to_png.py (reference scripts/raw_to_png.py), on
the port's PNG writer (no OpenCV):

  python -m enerf_torch.tools.raw_to_png --indir WS/validation/event_view [--start_from N]

writes each *.npy render (values in [0, 1], [H, W], [H, W, 1] or RGB
[H, W, 3]) as an 8-bit PNG into the sibling raw_pngs/, and its min-max
stretch into raw_pngs/contrast_spread/<name>_spread.png (useful for
event-only runs, whose intensity carries an arbitrary affine gauge).
"""

import argparse
import glob
import os

import numpy as np

from enerf_torch.utils.png import write_png


def main(argv=None):
    ap = argparse.ArgumentParser(description="raw npy renders -> pngs")
    ap.add_argument("--indir", required=True, help="dir containing *.npy raw renders")
    ap.add_argument("--start_from", type=int, default=0)
    args = ap.parse_args(argv)

    outdir = os.path.join(os.path.dirname(args.indir.rstrip("/")), "raw_pngs")
    outdirc = os.path.join(outdir, "contrast_spread")
    os.makedirs(outdirc, exist_ok=True)

    files = sorted(glob.glob(os.path.join(args.indir, "*.npy")))[args.start_from:]
    if not files:
        raise SystemExit(f"no .npy files in {args.indir}")
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        raw = np.load(path)
        if raw.ndim == 3 and raw.shape[-1] == 1:
            raw = raw[..., 0]
        write_png(os.path.join(outdir, name + ".png"),
                  np.rint(np.clip(raw * 255.0, 0, 255)).astype(np.uint8))
        lo, hi = float(raw.min()), float(raw.max())
        spread = np.rint((raw - lo) / max(hi - lo, 1e-12) * 255.0).astype(np.uint8)
        write_png(os.path.join(outdirc, name + "_spread.png"), spread)
    print(f"wrote {len(files)} pngs to {outdir}")


if __name__ == "__main__":
    main()
