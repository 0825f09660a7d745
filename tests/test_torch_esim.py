"""Parity of the port's esim dataset path with enerf_tpu: the PNG reader and
INTER_AREA downscale against OpenCV, read_image, load_esim_dataset (clean,
e2vid, images_corrupted, downscale 2) on a directory written by the JAX
package's own writer, the port's writer read back by JAX's loader, the
transforms JSON, the scene pose offsets and make_providers in esim mode."""

import json
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from torch_parity import n

from enerf_tpu.data import provider as jprov, synthetic as jsyn
from enerf_torch.config import build_config
from enerf_torch.data import provider as tprov, synthetic as tsyn
from enerf_torch.utils import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_FILTERS = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]


def _raw_png(a, color, depth, interlace=0):
    """A PNG of `a` ([H, W, samples]) with filter 0 rows and any header,
    including ones cv2.imwrite cannot write (gray + alpha, interlaced,
    palette, 1 bit)."""
    H, W = a.shape[:2]
    rows = (a.astype(">u2").view(np.uint8) if depth == 16 else a).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace))
            + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))


def _filter_types(path):
    """The set of row filter types in a PNG file."""
    data = open(path, "rb").read()
    pos, idat = 8, []
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            W, H, depth, color = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat.append(body)
    stride = W * png._CHANNELS[color] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[r * (stride + 1)] for r in range(H)}


def _random_image(kind, rng):
    shapes = {"gray8": ((32, 32), np.uint8), "bgr8": ((32, 32, 3), np.uint8),
              "gray16": ((32, 32), np.uint16), "bgra8": ((32, 32, 4), np.uint8)}
    shape, dtype = shapes[kind]
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


@pytest.mark.parametrize("filters", ["adaptive", "opencv_default"])
@pytest.mark.parametrize("kind", ["gray8", "bgr8", "gray16", "bgra8"])
def test_png_reader_matches_cv2(tmp_path, kind, filters):
    img = _random_image(kind, np.random.default_rng(len(kind)))
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, img, ALL_FILTERS if filters == "adaptive" else [])
    if filters == "adaptive":  # libpng's heuristic picks every filter on random rows
        assert _filter_types(path) == {0, 1, 2, 3, 4}
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


def test_png_reader_on_the_port_writer_and_alpha_files(tmp_path):
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (17, 23), dtype=np.uint8)
    rgb = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    for name, img, want in (("g", gray, gray), ("rgb", rgb, rgb[..., ::-1])):
        path = str(tmp_path / f"{name}.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(png.read_png(path), want)
        np.testing.assert_array_equal(png.read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))
    # gray + alpha (8 and 16 bit) and RGBA 16: cv2 gives BGRA, gray repeated
    for name, a, color, depth in (
            ("ga8", rng.integers(0, 256, (9, 11, 2), dtype=np.uint8), 4, 8),
            ("ga16", rng.integers(0, 65536, (9, 11, 2), dtype=np.uint16), 4, 16),
            ("rgba16", rng.integers(0, 65536, (9, 11, 4), dtype=np.uint16), 6, 16)):
        path = str(tmp_path / f"{name}.png")
        open(path, "wb").write(_raw_png(a, color, depth))
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = png.read_png(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape == (9, 11, 4), name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_png_reader_refuses_what_it_cannot_decode(tmp_path):
    a = np.zeros((4, 4, 1), np.uint8)
    cases = {"interlaced.png": _raw_png(a, 0, 8, interlace=1),
             "palette.png": _raw_png(a, 3, 8),
             "onebit.png": _raw_png(np.zeros((4, 1, 1), np.uint8), 0, 1),
             "notpng.png": b"GIF89a" + bytes(20)}
    for name, data in cases.items():
        path = str(tmp_path / name)
        open(path, "wb").write(data)
        with pytest.raises(ValueError, match=name):
            png.read_png(path)
    # a JPEG frame reads as cv2 reads it (utils/jpeg.py); other formats raise
    jpg = str(tmp_path / "frame.jpg")
    cv2.imwrite(jpg, np.full((8, 8), 128, np.uint8))
    np.testing.assert_array_equal(tprov.read_image(jpg, 1)[..., 0],
                                  cv2.imread(jpg, cv2.IMREAD_UNCHANGED) / np.float32(255.0))
    bmp = str(tmp_path / "frame.bmp")
    cv2.imwrite(bmp, np.full((8, 8), 128, np.uint8))
    with pytest.raises(ValueError, match="frame.bmp"):
        tprov.read_image(bmp, 1)


@pytest.mark.parametrize("factor", [2, 3])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_area_matches_cv2(factor, channels):
    rng = np.random.default_rng(factor * 10 + channels)
    for H, W in ((12 * factor, 10 * factor), (12 * factor + 1, 10 * factor + 2)):
        shape = (H, W) if channels == 1 else (H, W, channels)
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = cv2.resize(a, (W // factor, H // factor), interpolation=cv2.INTER_AREA)
        got = png.resize_area(a, factor)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        if H % factor == 0 and W % factor == 0:
            np.testing.assert_array_equal(got, ref)  # OpenCV's block average
        else:  # OpenCV's fractional weights in f32 against f64 here
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("out_dim_color", [1, 3])
def test_read_image_matches_jax(tmp_path, out_dim_color, downscale):
    rng = np.random.default_rng(5)
    for name, img in (("g", rng.integers(0, 256, (16, 20), dtype=np.uint8)),
                      ("c", rng.integers(0, 256, (16, 20, 3), dtype=np.uint8))):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img, ALL_FILTERS)
        got = tprov.read_image(path, out_dim_color, downscale)
        ref = jprov.read_image(path, out_dim_color, downscale)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def esim_dir(tmp_path_factory):
    """A 32 x 32, 8-frame esim directory from the JAX package's writer, with
    the e2vid and images_corrupted sources (which that writer does not
    write) added as cv2 PNGs of the frames with seeded noise."""
    root = tmp_path_factory.mktemp("esim")
    data = jsyn.simulate_events(H=32, W=32, n_frames=8, C=0.2,
                                cache_dir=os.environ.get("ENERF_SYN_CACHE"))
    d = str(root / "ShakeCarpet1_scene")
    jprov.save_esim_dataset(data, d, scale=0.3)
    rng = np.random.default_rng(9)
    for sub in ("e2vids/e2vid_up1_a/e2calib", "images_corrupted"):
        os.makedirs(os.path.join(d, sub))
        for i, im in enumerate(data["frames"]):
            noisy = np.clip(im[..., 0] * 255 + rng.normal(0, 20, im.shape[:2]), 0, 255)
            cv2.imwrite(os.path.join(d, sub, f"{i:06d}.png"), noisy.astype(np.uint8), ALL_FILTERS)
    return d, data


def _assert_same_dataset(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("source", ["clean", "e2vid", "corrupted", "downscale2"])
def test_load_esim_dataset_matches_jax(esim_dir, source):
    d, _ = esim_dir
    kw = {"clean": {}, "e2vid": {"e2vid": 1}, "corrupted": {"images_corrupted": True},
          "downscale2": {"downscale": 2}}[source]
    ref = jprov.load_esim_dataset(d, scale=0.3, **kw)
    got = tprov.load_esim_dataset(d, scale=0.3, **kw)
    _assert_same_dataset(got, ref)
    assert got["events"].shape[0] > 100 and set(np.unique(got["events"][:, 3])) == {-1.0, 1.0}
    if source == "corrupted":
        assert not np.array_equal(got["train_images"], got["images"])
    if source == "downscale2":
        assert got["images"].shape == (8, 16, 16, 1)


def test_port_writer_loads_through_the_jax_loader(esim_dir, tmp_path):
    d, _ = esim_dir
    data = tsyn.simulate_events(H=32, W=32, n_frames=8, C=0.2)
    mine = tprov.save_esim_dataset(data, str(tmp_path / "port"), scale=0.3)
    _assert_same_dataset(jprov.load_esim_dataset(mine, scale=0.3),
                         jprov.load_esim_dataset(d, scale=0.3))
    # and the port's own reader reads back the uint8 frames it wrote
    for i, im in enumerate(data["frames"]):
        np.testing.assert_array_equal(
            png.read_png(os.path.join(mine, "images", f"{i:06d}.png")),
            (np.clip(im[..., 0], 0, 1) * 255).astype(np.uint8))


def test_transforms_json_and_scene_pose_offsets(esim_dir, tmp_path):
    d, _ = esim_dir
    data = tprov.load_esim_dataset(d, scale=0.3)
    pj = jprov.write_transforms_json(str(tmp_path / "j"), data)
    pt = tprov.write_transforms_json(str(tmp_path / "t"), data)
    assert json.load(open(pt)) == json.load(open(pj))
    for name, sphere in (("ShakeCarpet1_x", False), ("00_peanuts_dark", False),
                         ("00_peanuts_dark", True), ("11_all_characters", True), ("other", False)):
        a = {k: data[k].copy() for k in ("poses", "hf_poses")}
        b = {k: data[k].copy() for k in ("poses", "hf_poses")}
        jprov.apply_scene_pose_offset(f"/x/{name}/", a, pp_poses_sphere=sphere)
        tprov.apply_scene_pose_offset(f"/x/{name}/", b, pp_poses_sphere=sphere)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=name)
        moved = not np.array_equal(b["poses"], data["poses"])
        assert moved == (name not in ("other",) and not (name == "00_peanuts_dark" and sphere))


def _esim_cfg(d, tmp, *extra):
    return build_config([
        "--config", os.path.join(REPO, "configs", "spiral1", "spiral1_nerf.txt"),
        "--datadir", d, "--outdir", str(tmp), "--num_rays", "64", "--batch_size_evs", "64",
        "--num_levels", "2", "--num_steps", "16", "--train_idxs", "0", "--train_idxs", "2",
        "--train_idxs", "4", "--train_idxs", "6", "--val_idxs", "1", "--val_idxs", "3", *extra])


@pytest.mark.parametrize("events,event_only", [(0, 0), (1, 0), (1, 1)])
def test_make_providers_esim_matches_jax(esim_dir, tmp_path, events, event_only):
    d, _ = esim_dir
    cfg = _esim_cfg(d, tmp_path, "--events", str(events), "--event_only", str(event_only),
                    "--images_corrupted", "1")
    train, val = tprov.make_providers(cfg, device="cpu")
    train_j, val_j = jprov.make_providers(cfg)
    assert type(train).__name__ == type(train_j).__name__
    vt, vj = val.val_views(), val_j.val_views()
    assert len(vt) == len(vj) == 2
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a["pose"], b["pose"])
        np.testing.assert_array_equal(a["gt"], b["gt"])
        assert (a["H"], a["W"]) == (b["H"], b["W"]) == (32, 32)
        np.testing.assert_array_equal(a["intrinsics"], b["intrinsics"])
    ws = os.path.join(str(tmp_path), cfg.expweek, cfg.expname, "transform_train.json")
    assert os.path.exists(ws)
    if not events:
        np.testing.assert_array_equal(n(train.images), np.asarray(train_j.images))
        np.testing.assert_array_equal(train.train_poses, train_j.train_poses)
        assert train.images.shape[0] == 4  # the train indices, corrupted frames
        return
    for k in ("xs", "ys", "ts", "pols", "cum_pols", "num_successors", "group_offset",
              "group_count"):
        np.testing.assert_array_equal(n(getattr(train.chains, k)),
                                      np.asarray(getattr(train_j.chains, k)), err_msg=k)
    np.testing.assert_array_equal(n(train.poses_evs), np.asarray(train_j.poses_evs))
    for k in ("key_ts", "key_quats", "key_trans"):
        np.testing.assert_allclose(n(getattr(train, k)), np.asarray(getattr(train_j, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if event_only:
        assert train.frames is None and train_j.frames is None
    else:
        np.testing.assert_array_equal(n(train.frames), np.asarray(train_j.frames))
        np.testing.assert_array_equal(n(train.frame_poses), np.asarray(train_j.frame_poses))
        batch = train.train_step_batch(torch.Generator().manual_seed(0))
        assert batch["images"].shape == (64, 1) and batch["rays_evs_o1"].shape == (64, 3)


def test_loader_errors_name_what_is_missing(esim_dir, tmp_path):
    d, _ = esim_dir
    bare = str(tmp_path / "bare")
    shutil.copytree(d, bare, ignore=shutil.ignore_patterns("e2vids", "images_corrupted"))
    with pytest.raises(FileNotFoundError, match="e2vid"):
        tprov.load_esim_dataset(bare, e2vid=1)
    with pytest.raises(FileNotFoundError, match="images_corrupted"):
        tprov.load_esim_dataset(bare, images_corrupted=True)
    os.remove(os.path.join(bare, "images", "000003.png"))
    with pytest.raises(ValueError, match="timestamps"):
        tprov.load_esim_dataset(bare)
    # an esim directory read as tumvie / eds: their loaders name the file
    for mode, missing in (("tumvie", "calib_undist.json"), ("eds", "stamped_groundtruth_us")):
        cfg = _esim_cfg(d, tmp_path)
        cfg.mode = mode
        with pytest.raises(FileNotFoundError, match=missing):
            tprov.make_providers(cfg, device="cpu")
