"""A small PNG writer on the standard library (zlib + struct).

The port writes validation and test images without OpenCV: 8-bit
grayscale ([H, W] or [H, W, 1]) or RGB ([H, W, 3]) arrays, one IDAT chunk,
filter type 0 on every row.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img8):
    """uint8 [H, W], [H, W, 1] or [H, W, 3] -> PNG file bytes."""
    a = np.asarray(img8)
    if a.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        color = 0  # grayscale
    elif a.ndim == 3 and a.shape[-1] == 3:
        color = 2  # RGB
    else:
        raise ValueError(f"encode_png takes [H, W], [H, W, 1] or [H, W, 3], got {a.shape}")
    H, W = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path, img8):
    with open(path, "wb") as f:
        f.write(encode_png(img8))
