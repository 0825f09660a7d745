"""The port's JPEG codec (enerf_torch/utils/jpeg.py) against OpenCV's
libjpeg-turbo: the decoder bit-equal to cv2.imread in both read modes on
files cv2.imwrite writes (qualities, samplings, optimized tables, restart
intervals, edge sizes), the encoder's files decoding to what cv2's own
encoding decodes to, and the raise on files outside the subset."""

import os
import re
import struct

import cv2
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.data.provider import read_gray, read_image
from enerf_torch.utils import jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (17, 23), (48, 64), (67, 129)]


def _image(H, W, channels, seed):
    """Smooth structure plus noise: every coefficient band is used."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    base = (128 + 70 * np.sin(xx / 6.0 + seed) * np.cos(yy / 4.0))[..., None]
    img = np.clip(base + rng.normal(0, 30, (H, W, channels)), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLINGS) + ["gray"])
def test_decoder_is_bit_equal_to_cv2(tmp_path, sampling, size):
    H, W = size
    img = _image(H, W, 1 if sampling == "gray" else 3, seed=H + W)
    checked = 0
    for quality in (50, 95, 100):
        for optimize in (0, 1):
            for rst in (0, 1, 5):
                params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                if sampling != "gray":
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
                path = str(tmp_path / f"q{quality}_o{optimize}_r{rst}.jpg")
                assert cv2.imwrite(path, img, params)
                for flag, gray in ((cv2.IMREAD_UNCHANGED, False), (cv2.IMREAD_GRAYSCALE, True)):
                    ref = cv2.imread(path, flag)
                    got = jpeg.read_jpeg(path, gray=gray)
                    assert got.dtype == np.uint8 and got.shape == ref.shape, (path, gray)
                    assert np.array_equal(got, ref), (path, gray, np.abs(
                        got.astype(int) - ref).max())
                    checked += 1
    assert checked == 36


@pytest.mark.parametrize("size", [(17, 23), (48, 64), (67, 129)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_encoder_decodes_as_cv2s_own_encoding(tmp_path, sampling, quality, size):
    H, W = size
    img = _image(H, W, 1 if sampling == "gray" else 3, seed=3 * H + W)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    ref_path, our_path = str(tmp_path / "cv2.jpg"), str(tmp_path / "port.jpg")
    assert cv2.imwrite(ref_path, img, params)
    jpeg.write_jpeg(our_path, img, quality=quality, sampling=sampling)
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
        assert np.array_equal(cv2.imread(our_path, flag), cv2.imread(ref_path, flag))
    # the markers, tables and entropy-coded data are libjpeg's byte for byte
    with open(ref_path, "rb") as f:
        assert jpeg.encode_jpeg(img, quality=quality, sampling=sampling) == f.read()


def test_encoder_defaults_are_imwrites(tmp_path):
    """cv2.imwrite(path.jpg, img) with no parameters: quality 95, 4:2:0."""
    img = _image(40, 56, 3, seed=7)
    assert cv2.imwrite(str(tmp_path / "a.jpg"), img)
    jpeg.write_jpeg(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


def test_read_image_and_read_gray_on_jpeg(tmp_path):
    from enerf_tpu.data.provider import read_image as jax_read_image

    for name, img in (("c.jpg", _image(33, 45, 3, 1)), ("g.jpeg", _image(33, 45, 1, 2))):
        path = str(tmp_path / name)
        assert cv2.imwrite(path, img)
        for dim, down in ((3, 1), (1, 1), (1, 3)):
            np.testing.assert_array_equal(read_image(path, dim, down),
                                          jax_read_image(path, dim, down))
        np.testing.assert_array_equal(read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    for shape in ((21, 30, 3), (21, 30, 4), (21, 30)):
        path = str(tmp_path / "p.png")
        assert cv2.imwrite(path, np.random.default_rng(0).integers(0, 256, shape, np.uint8))
        np.testing.assert_array_equal(read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_progressive_and_arithmetic_files_raise(tmp_path):
    img = _image(24, 32, 3, seed=5)
    prog = str(tmp_path / "progressive.jpg")
    assert cv2.imwrite(prog, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match=r"progressive\.jpg.*SOF2"):
        jpeg.read_jpeg(prog)
    with pytest.raises(NotImplementedError, match="progressive"):
        read_image(prog, 3)
    # an arithmetic-coded frame header (SOF9), written by hand
    sof9 = struct.pack(">BHHB", 8, 24, 32, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(b"\xff\xd8" + b"\xff\xc9" + struct.pack(">H", len(sof9) + 2) + sof9
                      + b"\xff\xd9")
    with pytest.raises(NotImplementedError, match=r"arith\.jpg.*SOF9"):
        jpeg.read_jpeg(str(arith))


def test_no_code_path_catches_the_decoders_raise():
    pat = re.compile(r"except\s*(\(.*NotImplementedError.*\)|NotImplementedError|Exception"
                     r"|BaseException)?\s*(as \w+)?:")
    for root, _, files in os.walk(os.path.join(REPO, "enerf_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                for i, line in enumerate(f, 1):
                    m = pat.search(line)
                    assert not (m and "NotImplementedError" in line), (name, i, line)


def test_decode_speed_path_matches_on_a_frame_with_long_codes():
    """Quality 100 at 4:4:4 gives the longest codes and magnitudes: the
    slow path of the entropy loop (code + magnitude past 16 bits)."""
    img = np.random.default_rng(11).integers(0, 256, (40, 48, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 100,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    assert ok
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.tobytes()),
                                  cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
