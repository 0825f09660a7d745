"""A baseline JPEG decoder and encoder on the standard library and numpy,
bit-exact with what OpenCV gives through libjpeg-turbo at its defaults.

The card's Python has no OpenCV, and TUM-VIE's frames are JPEG files.

Decoding (`read_jpeg`, `decode_jpeg`) gives what
`cv2.imread(path, cv2.IMREAD_UNCHANGED)` gives: [H, W] uint8 for a gray
file, [H, W, 3] BGR for a colour one; with gray=True what
`cv2.IMREAD_GRAYSCALE` gives, the Y plane of a colour file with no colour
conversion (libjpeg's JCS_GRAYSCALE output).  It covers baseline and
extended-sequential Huffman files (SOF0 / SOF1) at 8 bits with 1 or 3
components, any integral sampling factors, restart intervals, several
DQT / DHT segments, byte stuffing and fill bytes, and partial MCUs at the
right and bottom edges.  It follows libjpeg-turbo's default path: the
ISLOW integer IDCT (jidctint.c), "fancy" triangle upsampling for h2v1,
h1v2 and h2v2 (box replication for other factors, and for h2v1 / h2v2
when the subsampled width is at most 2), and the fixed-point YCbCr -> RGB
tables of jdcolor.c.  Only the entropy decoding is a Python loop: it peeks
16 bits against one lookup table per Huffman table and writes the
coefficients into one int16 array; dequantisation, the IDCT, upsampling
and colour conversion run over all blocks at once in numpy int32.
Progressive, arithmetic, lossless, hierarchical, 12-bit, CMYK and
Adobe-transformed files raise NotImplementedError naming the file and the
marker.

Encoding (`encode_jpeg`, `write_jpeg`) gives the bytes whose decoding
equals that of `cv2.imwrite(path.jpg, img)`: quality 95 (libjpeg's
scaling of the standard tables, forced to baseline), 4:2:0 for colour,
the fixed-point RGB -> YCbCr of jccolor.c, libjpeg's 2x2 / 2x1 box
downsampling with its alternating bias, the edge replicated into the
padding, the ISLOW forward DCT (jfdctint.c), libjpeg-turbo's reciprocal
quantisation, the standard Huffman tables and a JFIF header.  It is
vectorised end to end: the bitstream is assembled with numpy.
"""

import array
import functools
import struct

import numpy as np

# natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_SOF_NAMES = {
    0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)", 0xC2: "SOF2 (progressive)",
    0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)", 0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)", 0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)", 0xCD: "SOF13 (arithmetic differential sequential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)",
}

# jidctint.c / jfdctint.c constants (CONST_BITS 13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


# ----------------------------------------------------------------------------
# Huffman tables


def _ceil_div(a, b):
    return -(-a // b)


def _huff_codes(bits, vals):
    """(code lengths, codes) of a DHT's symbols, canonical order."""
    lengths, codes, code = [], [], 0
    for L in range(1, 17):
        for _ in range(bits[L - 1]):
            lengths.append(L)
            codes.append(code)
            code += 1
        code <<= 1
    return np.asarray(lengths, np.int64), np.asarray(codes, np.int64), np.asarray(vals, np.int64)


def _lookup(bits, vals):
    """Per 16-bit window: (code length, symbol); length 0 where no code
    matches."""
    lengths, codes, syms = _huff_codes(bits, vals)
    L16 = np.zeros(1 << 16, np.int64)
    S16 = np.zeros(1 << 16, np.int64)
    if len(lengths):
        starts = codes << (16 - lengths)
        spans = np.int64(1) << (16 - lengths)
        if starts[-1] + spans[-1] > (1 << 16):
            raise ValueError("bad Huffman table")
        within = np.arange(spans.sum()) - np.repeat(np.cumsum(spans) - spans, spans)
        idx = np.repeat(starts, spans) + within
        L16[idx] = np.repeat(lengths, spans)
        S16[idx] = np.repeat(syms, spans)
    return L16, S16


def _extend(bits, s):
    """JPEG's EXTEND: s magnitude bits -> a signed value."""
    half = np.int64(1) << np.maximum(s - 1, 0)
    return np.where(bits < half, bits - (np.int64(1) << s) + 1, bits)


@functools.lru_cache(maxsize=32)
def _fast_table(bits, vals, ac):
    """One decode table over every 16-bit window, as a list of 3-tuples
    (kept across files: a sequence's frames share their tables).

    DC:  (bits used, diff, 0) when code and magnitude fit in 16 bits,
         else (0, code length, magnitude size).
    AC:  (bits used, run + 1, value) (EOB: run + 1 = 64, ZRL: 16, value 0)
         when they fit, else (0, code length, symbol).
    (0, 0, 0) marks a window that starts no code.
    """
    L, S = _lookup(bits, vals)
    w = np.arange(1 << 16, dtype=np.int64)
    s = S & 15 if ac else S
    fits = (L > 0) & (L + s <= 16)
    mag = (w >> np.maximum(16 - L - s, 0)) & ((np.int64(1) << s) - 1)
    val = np.where(s > 0, _extend(mag, s), 0)
    if ac:
        run = S >> 4
        adv = np.where(s > 0, run + 1, np.where(run == 15, 16, 64))
        n = np.where(fits, L + s, 0)
        a = np.where(fits, adv, L)
        v = np.where(fits, val, S)
    else:
        n = np.where(fits, L + s, 0)
        a = np.where(fits, val, L)
        v = np.where(fits, 0, s)
    return list(zip(n.tolist(), a.tolist(), v.tolist()))


def _windows(data):
    """The 16-bit big-endian window at every bit position of `data` (bytes
    after unstuffing), zero-padded past the end (libjpeg inserts zeros at
    a marker)."""
    b = np.frombuffer(data, np.uint8).astype(np.uint32)
    b = np.concatenate([b, np.zeros(4, np.uint32)])
    b24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = np.arange(8, 0, -1, dtype=np.uint32)
    w = ((b24[:, None] >> shifts[None, :]) & 0xFFFF).astype(np.uint16).reshape(-1)
    return array.array("H", w.tobytes())


def _unstuff(data, pos, path):
    """Entropy-coded bytes from `pos` up to the next marker that is not a
    stuffed 0xFF00 or a fill byte run: (bytes, marker, pos after it)."""
    out = bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            raise ValueError(f"{path}: entropy-coded data runs past the end of the file")
        out += data[pos:j]
        k = j + 1
        while k < n and data[k] == 0xFF:  # fill bytes
            k += 1
        if k >= n:
            raise ValueError(f"{path}: truncated JPEG")
        if data[k] == 0x00:
            out.append(0xFF)
            pos = k + 1
            continue
        return bytes(out), data[k], k + 1


# ----------------------------------------------------------------------------
# entropy decoding: the one Python loop


def _decode_blocks(W, seg_starts, comp_seq, restart_blocks, dc_tabs, ac_tabs, path):
    """Decode len(comp_seq) blocks (zigzag order, int16, DC undifferenced)
    from the window array W; a restart at every `restart_blocks` blocks
    resets the DC predictors and moves to the next segment."""
    nblk = len(comp_seq)
    out = array.array("h", bytes(2 * 64 * (nblk + 1)))
    ncomp = max(comp_seq) + 1 if nblk else 0
    preds = [0] * ncomp
    seg = 0
    p = seg_starts[0]
    next_restart = restart_blocks if restart_blocks else nblk + 1
    try:
        for i in range(nblk):
            if i == next_restart:
                seg += 1
                p = seg_starts[seg]
                preds = [0] * ncomp
                next_restart += restart_blocks
            c = comp_seq[i]
            act = ac_tabs[c]
            base = i * 64
            n, a, v = dc_tabs[c][W[p]]
            if n:
                p += n
            elif a:
                p += a
                if v:
                    bits = W[p] >> (16 - v)
                    p += v
                    a = bits - (1 << v) + 1 if bits < (1 << (v - 1)) else bits
                else:
                    a = 0
            else:
                raise ValueError(f"{path}: corrupt DC code in block {i}")
            a += preds[c]
            preds[c] = a
            out[base] = a
            k = 1
            base -= 1
            while k < 64:
                n, a, v = act[W[p]]
                if n:
                    p += n
                    k += a
                    out[base + k] = v
                elif a:
                    p += a
                    s = v & 15
                    k += v >> 4
                    bits = W[p] >> (16 - s)
                    p += s
                    out[base + k + 1] = bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits
                    k += 1
                else:
                    raise ValueError(f"{path}: corrupt AC code in block {i}")
    except (IndexError, OverflowError) as e:
        raise ValueError(f"{path}: corrupt entropy-coded data ({e})") from None
    return np.frombuffer(out, np.int16).reshape(-1, 64)[:nblk]


# ----------------------------------------------------------------------------
# IDCT, upsampling, colour conversion (libjpeg-turbo's default path)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(d0, d1, d2, d3, d4, d5, d6, d7, shift):
    """One pass of jpeg_idct_islow on int32 arrays; returns the 8 outputs
    descaled by `shift`."""
    z1 = (d2 + d6) * _F0541
    tmp2 = z1 - d6 * _F1847
    tmp3 = z1 + d2 * _F0765
    tmp0 = (d0 + d4) << _CONST_BITS
    tmp1 = (d0 - d4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d7, d5, d3, d1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_limit_table():
    """jdmaster.c's post-IDCT range limit, indexed by (x & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(0, 128)
    return t


_IDCT_LIMIT = _idct_limit_table()


def idct_islow(coef, qt):
    """[N, 64] int16 coefficients (natural order) and a [64] quant table
    -> [N, 8, 8] uint8 samples, as jpeg_idct_islow gives them."""
    d = coef.astype(np.int32) * qt.astype(np.int32)[None, :]
    d = d.reshape(-1, 8, 8)
    # pass 1: columns
    ws = _idct_1d(*[d[:, i, :] for i in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.stack(ws, axis=1)  # [N, row, col]
    # pass 2: rows
    out = _idct_1d(*[ws[:, :, i] for i in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(out, axis=2)
    return _IDCT_LIMIT[out & 1023]


def _upsample(x, hf, vf):
    """One component's [ds_h, ds_w] samples (int32) -> [ds_h*vf, ds_w*hf],
    as jdsample.c's method for (hf, vf) gives it with do_fancy_upsampling
    (libjpeg's default)."""
    ds_h, ds_w = x.shape
    if hf == 1 and vf == 1:
        return x
    if hf == 2 and vf == 1 and ds_w > 2:
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((ds_h, ds_w * 2), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out
    if hf == 1 and vf == 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((ds_h * 2, ds_w), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out
    if hf == 2 and vf == 2 and ds_w > 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((ds_h * 2, ds_w * 2), np.int32)
        for r, nb in ((0, up), (1, down)):
            cs = 3 * x + nb  # column sums
            last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[r::2, 0::2] = (3 * cs + last + 8) >> 4
            out[r::2, 1::2] = (3 * cs + nxt + 7) >> 4
        return out
    return np.repeat(np.repeat(x, vf, axis=0), hf, axis=1)


def _fix(v):
    """libjpeg's FIX(v) at SCALEBITS 16."""
    return int(v * (1 << 16) + 0.5)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * x + half) >> 16
    cb_b = (_fix(1.77200) * x + half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_bgr(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert on uint8-valued arrays -> [..., 3] BGR."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


# ----------------------------------------------------------------------------
# the decoder


def _unsupported(path, what):
    raise NotImplementedError(f"{path}: {what} JPEG files are not supported "
                              "(the port decodes baseline / extended-sequential Huffman "
                              "8-bit gray or YCbCr files)")


def decode_jpeg(data, gray=False, path="<bytes>"):
    """JPEG file bytes -> uint8 [H, W] (gray file, or gray=True) or
    [H, W, 3] BGR, as cv2.imread gives them (IMREAD_UNCHANGED, or
    IMREAD_GRAYSCALE with gray=True)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    pos = 2
    qtabs, dc_defs, ac_defs = {}, {}, {}
    frame = None
    restart = 0
    adobe_transform = None
    coefs = None  # per component [rows, cols, 64] int16, zigzag order
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1  # garbage before a marker, as libjpeg skips it
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError(f"{path}: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError(f"{path}: truncated JPEG")
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        pos += seglen
        if marker in _SOF_NAMES:
            if marker not in (0xC0, 0xC1):
                _unsupported(path, _SOF_NAMES[marker])
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                _unsupported(path, f"{prec}-bit {_SOF_NAMES[marker]}")
            if nc not in (1, 3):
                _unsupported(path, f"{nc}-component (CMYK / YCCK)")
            if H == 0:
                raise NotImplementedError(f"{path}: a height defined by a DNL marker "
                                          "is not supported")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            frame = (H, W, comps)
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = _ceil_div(W, 8 * hmax), _ceil_div(H, 8 * vmax)
            coefs = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int16) for c in comps]
        elif marker == 0xCC:
            _unsupported(path, "arithmetic-coded (DAC)")
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc_th = seg[i]
                bits = tuple(seg[i + 1:i + 17])
                nv = sum(bits)
                vals = tuple(seg[i + 17:i + 17 + nv])
                (ac_defs if tc_th >> 4 else dc_defs)[tc_th & 15] = _fast_table(
                    bits, vals, bool(tc_th >> 4))
                i += 17 + nv
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq_tq = seg[i]
                if pq_tq >> 4:
                    q = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int32)
                    i += 129
                else:
                    q = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int32)
                    i += 65
                nat = np.zeros(64, np.int32)
                nat[ZIGZAG] = q
                qtabs[pq_tq & 15] = nat
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: SOS before SOF")
            ids = [c["id"] for c in frame[2]]
            ns = seg[0]
            scomps = []
            for i in range(ns):
                cid, tdta = seg[1 + 2 * i:3 + 2 * i]
                if cid not in ids:
                    raise ValueError(f"{path}: scan names component {cid}, not in the frame")
                scomps.append((ids.index(cid), tdta >> 4, tdta & 15))
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahal != 0:
                _unsupported(path, "spectral-selection / successive-approximation")
            pos = _decode_scan(data, pos, frame, scomps, restart, dc_defs, ac_defs, coefs, path)
        # APPn, COM and the rest carry nothing the decoder needs
    if frame is None:
        raise ValueError(f"{path}: no frame header")
    if len(frame[2]) == 3 and adobe_transform is not None and adobe_transform != 1:
        _unsupported(path, f"Adobe-transformed (transform {adobe_transform})")
    return _reconstruct(frame, coefs, qtabs, gray, path)


def _decode_scan(data, pos, frame, scomps, restart, dc_defs, ac_defs, coefs, path):
    """Decode one scan starting at `pos` into `coefs`; returns the position
    of the marker that ends it."""
    H, W, comps = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if len(scomps) == 1:
        ci = scomps[0][0]
        c = comps[ci]
        # a one-component scan codes the component's own blocks, no MCU padding
        bw = _ceil_div(_ceil_div(W * c["h"], hmax), 8)
        bh = _ceil_div(_ceil_div(H * c["v"], vmax), 8)
        rows, cols = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        dest = [(ci, rows.reshape(-1), cols.reshape(-1))]
        comp_seq = np.zeros(bh * bw, np.int64)
        blocks_per_mcu = 1
        nblk = bh * bw
    else:
        mcux, mcuy = _ceil_div(W, 8 * hmax), _ceil_div(H, 8 * vmax)
        order = []
        for si, (ci, _, _) in enumerate(scomps):
            c = comps[ci]
            for v in range(c["v"]):
                for h in range(c["h"]):
                    order.append((si, ci, v, h))
        blocks_per_mcu = len(order)
        nblk = mcux * mcuy * blocks_per_mcu
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
        my, mx = my.reshape(-1), mx.reshape(-1)
        comp_seq = np.tile(np.asarray([o[0] for o in order]), mcux * mcuy)
        dest = []
        for si, (ci, _, _) in enumerate(scomps):
            c = comps[ci]
            slots = [(v, h) for s_i, _, v, h in order if s_i == si]
            rows = np.stack([my * c["v"] + v for v, _ in slots], 1).reshape(-1)
            cols = np.stack([mx * c["h"] + h for _, h in slots], 1).reshape(-1)
            dest.append((ci, rows, cols))
    # entropy-coded segments, split at RSTn
    segs, starts = [], []
    total = 0
    while True:
        chunk, marker, pos = _unstuff(data, pos, path)
        segs.append(chunk)
        starts.append(total * 8)
        total += len(chunk)
        if not (restart and 0xD0 <= marker <= 0xD7):
            pos -= 2  # leave the marker for the main loop
            break
    W16 = _windows(b"".join(segs))
    dc_tabs, ac_tabs = [], []
    for ci, td, ta in scomps:
        if td not in dc_defs or ta not in ac_defs:
            raise ValueError(f"{path}: scan uses an undefined Huffman table")
        dc_tabs.append(dc_defs[td])
        ac_tabs.append(ac_defs[ta])
    blk = _decode_blocks(W16, starts, comp_seq.tolist(), restart * blocks_per_mcu,
                         dc_tabs, ac_tabs, path)
    for si, (ci, rows, cols) in enumerate(dest):
        coefs[ci][rows, cols] = blk[comp_seq == si]
    return pos


def _reconstruct(frame, coefs, qtabs, gray, path):
    H, W, comps = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    want = [0] if (gray or len(comps) == 1) else list(range(len(comps)))
    planes = []
    for ci in want:
        c = comps[ci]
        if c["tq"] not in qtabs:
            raise ValueError(f"{path}: undefined quantisation table {c['tq']}")
        if hmax % c["h"] or vmax % c["v"]:
            raise NotImplementedError(f"{path}: non-integral sampling factors are not "
                                      "supported")
        blk = coefs[ci]
        R, C = blk.shape[:2]
        nat = np.zeros((R * C, 64), np.int16)
        nat[:, ZIGZAG] = blk.reshape(-1, 64)
        pix = idct_islow(nat, qtabs[c["tq"]]).reshape(R, C, 8, 8)
        pix = pix.transpose(0, 2, 1, 3).reshape(R * 8, C * 8).astype(np.int32)
        ds_h, ds_w = _ceil_div(H * c["v"], vmax), _ceil_div(W * c["h"], hmax)
        up = _upsample(pix[:ds_h, :ds_w], hmax // c["h"], vmax // c["v"])
        planes.append(up[:H, :W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return ycc_to_bgr(*planes)


def read_jpeg(path, gray=False):
    """cv2.imread(path, IMREAD_UNCHANGED) (or IMREAD_GRAYSCALE with
    gray=True) of a JPEG file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), gray=gray, path=path)


# ----------------------------------------------------------------------------
# the encoder (libjpeg's defaults as cv2.imwrite sets them)

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_Q = np.full(64, 99, np.int64)
_STD_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                       [24, 26, 56, 99], [47, 66, 99, 99]]

_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], list(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")))

# Y's (h, v) sampling factors; chroma is 1 x 1 (cv2's IMWRITE_JPEG_SAMPLING_FACTOR_*)
SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}


def quality_table(base, quality):
    """jpeg_set_quality(quality, force_baseline=TRUE) applied to a table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _fdct_1d(d, shift, final):
    """One pass of jpeg_fdct_islow over the last axis of d's 8 slices."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if final:
        o0 = _descale(tmp10 + tmp11, _PASS1_BITS)
        o4 = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        o0 = (tmp10 + tmp11) << _PASS1_BITS
        o4 = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    o2 = _descale(z1 + tmp13 * _F0765, shift)
    o6 = _descale(z1 - tmp12 * _F1847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4 = tmp4 * _F0298
    tmp5 = tmp5 * _F2053
    tmp6 = tmp6 * _F3072
    tmp7 = tmp7 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    o7 = _descale(tmp4 + z1 + z3, shift)
    o5 = _descale(tmp5 + z2 + z4, shift)
    o3 = _descale(tmp6 + z2 + z3, shift)
    o1 = _descale(tmp7 + z1 + z4, shift)
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def fdct_islow(blocks):
    """[N, 8, 8] samples (int) -> [N, 64] DCT outputs scaled by 8, as
    jpeg_fdct_islow gives them from sample - 128."""
    d = blocks.astype(np.int32) - 128
    rows = np.stack(_fdct_1d([d[:, :, i] for i in range(8)], _CONST_BITS - _PASS1_BITS, False),
                    axis=2)
    cols = np.stack(_fdct_1d([rows[:, i, :] for i in range(8)], _CONST_BITS + _PASS1_BITS, True),
                    axis=1)
    return cols.reshape(-1, 64)


def quantize(dct, qt):
    """libjpeg-turbo's reciprocal quantisation of [N, 64] ISLOW outputs by
    a [64] table (divisor 8 * q)."""
    div = qt.astype(np.int64) * 8
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // div
    fr = (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    t = dct.astype(np.int64)
    q = ((np.abs(t) + c) * fq) >> r
    return np.where(t < 0, -q, q).astype(np.int16)


def bgr_to_ycc(bgr):
    """jccolor.c's rgb_ycc_convert on [..., 3] uint8 BGR -> (Y, Cb, Cr) int32."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off + half - 1) >> 16
    return [y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32)]


def _downsample(x, hexp, vexp):
    """jcsample.c: [rows, cols] (already edge-padded) -> [rows/vexp,
    cols/hexp] with libjpeg's bias (h2v1: 0,1,...; h2v2: 1,2,...;
    others: round half up)."""
    if hexp == 1 and vexp == 1:
        return x
    R, C = x.shape
    s = x.reshape(R // vexp, vexp, C // hexp, hexp).sum(axis=(1, 3))
    if (hexp, vexp) == (2, 1):
        bias = (np.arange(C // 2) & 1)[None, :]
        return (s + bias) >> 1
    if (hexp, vexp) == (2, 2):
        bias = 1 + (np.arange(C // 2) & 1)[None, :]
        return (s + bias) >> 2
    n = hexp * vexp
    return (s + n // 2) // n


def _pad_edge(x, rows, cols):
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])), mode="edge")


def _huff_lut(spec):
    """Symbol -> (code, length) arrays of a DHT spec."""
    lengths, codes, syms = _huff_codes(*spec)
    code = np.zeros(256, np.int64)
    ln = np.zeros(256, np.int64)
    code[syms] = codes
    ln[syms] = lengths
    return code, ln


def _bit_size(v):
    """Magnitude category of each value (0 for 0)."""
    return np.where(v == 0, 0, np.frexp(np.abs(v).astype(np.float64))[1]).astype(np.int64)


def _emit_bits(codes, lengths):
    """Concatenate variable-length codes MSB first; pad with 1-bits; stuff
    a 0x00 after every 0xFF."""
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    rep_len = np.repeat(lengths, lengths)
    j = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
    bits = ((np.repeat(codes, lengths) >> (rep_len - 1 - j)) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _scan_symbols(blocks, tabs):
    """(codes, lengths) of one scan's blocks ([N, 64] zigzag int16 with the
    DC already differenced), `tabs` [N] the Huffman table index of each
    block into _ENC_TABLES."""
    N = blocks.shape[0]
    dc_code, dc_len, ac_code, ac_len = (np.stack([t[i] for t in _ENC_TABLES])
                                        for i in range(4))
    b = blocks.astype(np.int64)
    # DC
    dc = b[:, 0]
    s = _bit_size(dc)
    mag = np.where(dc < 0, dc - 1, dc) & ((np.int64(1) << s) - 1)
    items = [(np.arange(N), np.zeros(N, np.int64),
              (dc_code[tabs, s] << s) | mag, dc_len[tabs, s] + s)]
    # AC
    blk, k = np.nonzero(b[:, 1:])
    k = k + 1
    v = b[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s = _bit_size(v)
    mag = np.where(v < 0, v - 1, v) & ((np.int64(1) << s) - 1)
    rs = (run % 16) * 16 + s
    t = tabs[blk]
    items.append((blk, 2 * k, (ac_code[t, rs] << s) | mag, ac_len[t, rs] + s))
    nz = run // 16
    if nz.any():
        zb = np.repeat(blk, nz)
        zt = tabs[zb]
        items.append((zb, np.repeat(2 * k - 1, nz), ac_code[zt, 0xF0], ac_len[zt, 0xF0]))
    # EOB after the last nonzero AC unless it is at 63
    last = np.full(N, 0, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.nonzero(last < 63)[0]
    items.append((eob, np.full(len(eob), 200, np.int64), ac_code[tabs[eob], 0],
                  ac_len[tabs[eob], 0]))
    bid, key, codes, lens = (np.concatenate(x) for x in zip(*items))
    order = np.argsort(bid * 256 + key, kind="stable")
    return codes[order], lens[order]


_ENC_TABLES = [_huff_lut(_DC_LUMA) + _huff_lut(_AC_LUMA),
               _huff_lut(_DC_CHROMA) + _huff_lut(_AC_CHROMA)]


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dht(tc, th, spec):
    return _segment(0xC4, bytes([tc << 4 | th]) + bytes(spec[0]) + bytes(spec[1]))


def encode_jpeg(img, quality=95, sampling="420"):
    """uint8 [H, W] (gray) or [H, W, 3] BGR -> baseline JPEG bytes that
    decode to what cv2.imwrite(path.jpg, img) with IMWRITE_JPEG_QUALITY
    `quality` and the sampling factor `sampling` ("444", "422", "420",
    "440", "411"; ignored for gray) decodes to."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"encode_jpeg takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        planes, facs, qsel = [a.astype(np.int32)], [(1, 1)], [0]
    elif a.ndim == 3 and a.shape[-1] == 3:
        if sampling not in SAMPLINGS:
            raise ValueError(f"sampling must be one of {sorted(SAMPLINGS)}, got {sampling!r}")
        planes, facs, qsel = bgr_to_ycc(a), [SAMPLINGS[sampling], (1, 1), (1, 1)], [0, 1, 1]
    else:
        raise ValueError(f"encode_jpeg takes [H, W] or [H, W, 3], got {a.shape}")
    H, W = a.shape[:2]
    qts = [quality_table(_STD_LUMA_Q, quality), quality_table(_STD_CHROMA_Q, quality)]
    hmax = max(f[0] for f in facs)
    vmax = max(f[1] for f in facs)
    mcux, mcuy = _ceil_div(W, 8 * hmax), _ceil_div(H, 8 * vmax)
    grids = []
    for plane, (h, v), qi in zip(planes, facs, qsel):
        hexp, vexp = hmax // h, vmax // v
        # the component's blocks (width_in_blocks, height_in_blocks)
        wib = _ceil_div(_ceil_div(W * h, hmax), 8)
        hib = _ceil_div(_ceil_div(H * v, vmax), 8)
        # jcprepct.c: rows replicated to a whole row group, columns to the
        # blocks' width, before downsampling; the downsampled rows after
        x = _pad_edge(plane, _ceil_div(H, vmax) * vmax, wib * 8 * hexp)
        x = _downsample(x, hexp, vexp)
        x = _pad_edge(x, hib * 8, wib * 8)
        blocks = x.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        q = quantize(fdct_islow(blocks), qts[qi]).reshape(hib, wib, 64)
        if len(planes) > 1:
            # dummy blocks out to the MCU grid: zero AC, the DC of the block
            # before them in the MCU (jccoefct.c)
            g = np.zeros((mcuy * v, mcux * h, 64), np.int16)
            g[:hib, :wib] = q
            g[:hib, wib:, 0] = q[:, wib - 1:wib, 0]
            if hib < mcuy * v:
                last = g[hib - 1, h - 1::h, 0]
                g[hib:, :, 0] = np.repeat(last, h)[None, :]
            q = g
        grids.append(q[..., ZIGZAG])
    # blocks in scan order with their DC differenced per component
    if len(planes) == 1:
        blocks = grids[0].reshape(-1, 64)
        comp = np.zeros(len(blocks), np.int64)
    else:
        order, comp_of = [], []
        for ci, (h, v) in enumerate(facs):
            g = grids[ci].reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4)
            order.append(g.reshape(mcuy * mcux, v * h, 64))
            comp_of += [ci] * (v * h)
        blocks = np.concatenate(order, axis=1).reshape(-1, 64)
        comp = np.tile(np.asarray(comp_of), mcux * mcuy)
    blocks = blocks.astype(np.int64)
    for ci in range(len(planes)):
        sel = comp == ci
        dc = blocks[sel, 0]
        blocks[sel, 0] = np.diff(dc, prepend=0)
    tabs = np.asarray(qsel)[comp]
    codes, lens = _scan_symbols(blocks, tabs)
    # markers in libjpeg's order
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for qi in sorted(set(qsel)):
        out.append(_segment(0xDB, bytes([qi]) + qts[qi][ZIGZAG].astype(np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, H, W, len(planes))
    for ci, ((h, v), qi) in enumerate(zip(facs, qsel)):
        sof += bytes([ci + 1, h << 4 | v, qi])
    out.append(_segment(0xC0, sof))
    specs = [(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)]
    for ti in sorted(set(qsel)):
        out += [_dht(0, ti, specs[ti][0]), _dht(1, ti, specs[ti][1])]
    sos = bytes([len(planes)])
    for ci, qi in enumerate(qsel):
        sos += bytes([ci + 1, qi << 4 | qi])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out.append(_emit_bits(codes, lens))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, img, quality=95, sampling="420"):
    """cv2.imwrite(path, img) for a .jpg path (see encode_jpeg)."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality=quality, sampling=sampling))
