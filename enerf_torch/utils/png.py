"""A small PNG reader and writer on the standard library (zlib + struct),
and OpenCV's INTER_AREA downscale by an integer factor, in numpy.

The port reads and writes images without OpenCV, which the card's Python
does not have.  The writer takes 8- or 16-bit grayscale ([H, W] or
[H, W, 1]), RGB ([H, W, 3]) or RGBA ([H, W, 4]) arrays and writes one
IDAT chunk, filter type 0 on every row.  The reader returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)`
returns for non-interlaced gray, RGB, gray+alpha and RGBA files at 8 and
16 bits: gray as [H, W], colour as [H, W, 3] BGR, gray+alpha and RGBA as
[H, W, 4] BGRA (gray repeated), uint8 or uint16.  It undoes all five row
filters and raises, naming the file, on anything else (interlaced files,
palettes, bit depths below 8, transparency chunks, other formats).
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img8):
    """uint8 or uint16 [H, W], [H, W, 1], [H, W, 3] (RGB) or [H, W, 4]
    (RGBA) -> PNG file bytes."""
    a = np.asarray(img8)
    if a.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"encode_png takes uint8 or uint16, got {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        color = 0  # grayscale
    elif a.ndim == 3 and a.shape[-1] in (3, 4):
        color = 2 if a.shape[-1] == 3 else 6  # RGB / RGBA
    else:
        raise ValueError(f"encode_png takes [H, W], [H, W, 1], [H, W, 3] or [H, W, 4], "
                         f"got {a.shape}")
    H, W = a.shape[:2]
    depth = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).reshape(H, -1)
    rows = rows.view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path, img8):
    with open(path, "wb") as f:
        f.write(encode_png(img8))


def _unfilter_serial(kind, line, prev, bpp):
    """Average (3) or Paeth (4) on one row, byte by byte: each byte needs
    the decoded byte bpp to its left."""
    out = bytearray(line)
    n = len(out)
    if kind == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xFF
        return out
    for i in range(n):
        if i >= bpp:
            a, c = out[i - bpp], prev[i - bpp]
        else:
            a = c = 0
        b = prev[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(raw, H, stride, bpp, path):
    """Filtered scanlines ([H, 1 + stride] bytes) -> [H, stride] uint8."""
    if len(raw) < H * (stride + 1):
        raise ValueError(f"{path}: image data ends early ({len(raw)} of "
                         f"{H * (stride + 1)} bytes)")
    rows = np.frombuffer(raw, np.uint8, H * (stride + 1)).reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(H):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum, mod 256, along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_serial(kind, line.tobytes(), prev.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"{path}: row {r} has unknown filter type {kind}")
        out[r] = cur
        prev = out[r]
    return out


def decode_png(data, path="<bytes>"):
    """PNG file bytes -> the array cv2.imread(..., IMREAD_UNCHANGED) gives
    (see the module docstring); `path` names the file in errors."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"tRNS":
            raise ValueError(f"{path}: transparency chunks (tRNS) are not supported")
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    W, H, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} (palette) is not supported")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported (8 or 16)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), H, W * bpp, bpp, path)
    if depth == 16:
        img = pix.reshape(H, W * ch, 2).view(">u2")[..., 0].astype(np.uint16)
    else:
        img = pix
    img = img.reshape(H, W, ch)
    if ch == 1:
        return img[..., 0]
    if ch == 2:  # gray + alpha -> BGRA
        return np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]], axis=-1)
    return np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)  # RGB(A) -> BGR(A)


def read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _area_weights(src, dst):
    """[dst, src] weights of OpenCV's general INTER_AREA (computeResizeAreaTab):
    each output cell averages the source interval [d * s, (d + 1) * s)."""
    scale = src / dst
    w = np.zeros((dst, src))
    for d in range(dst):
        f1, f2 = d * scale, (d + 1) * scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = (s1 - f1) / cell
        w[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] = min(f2 - s2, 1.0, cell) / cell
    return w


def resize_area(img, factor):
    """Integer-factor downscale of an integer image [H, W] or [H, W, C] to
    [H // factor, W // factor], as cv2.resize(..., INTER_AREA) computes it.
    Where the factor divides both sides OpenCV averages factor x factor
    blocks (rounding half up for 2, to nearest even otherwise): bit-exact
    here.  Elsewhere it weighs fractional source intervals in f32; this
    computes them in f64, within one step of OpenCV's rounding."""
    a = np.asarray(img)
    f = int(factor)
    if f < 1 or not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"resize_area takes an integer image and factor >= 1, got "
                         f"{a.dtype}, {factor}")
    if f == 1:
        return a.copy()
    H, W = a.shape[:2]
    h, w = H // f, W // f
    info = np.iinfo(a.dtype)
    if H % f == 0 and W % f == 0:
        s = a.reshape(h, f, w, f, *a.shape[2:]).astype(np.int64).sum((1, 3))
        if f == 2:
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32) * np.float32(1.0 / (f * f)))
    else:
        out = np.rint(np.einsum("yh,hw...,xw->yx...", _area_weights(H, h), a.astype(np.float64),
                                _area_weights(W, w)))
    return np.clip(out, info.min, info.max).astype(a.dtype)
