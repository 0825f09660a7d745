"""Dataset providers: the esim on-disk format, event supervision and frame
supervision, device-resident.

Counterpart of enerf_tpu/data/provider.py (reference nerf/provider.py):
  - the esim format (`load_esim_dataset`, `save_esim_dataset`, the image
    sources `resolve_image_dir`, the scene pose offsets, the workspace's
    transforms JSON), read and written with the port's own PNG codec
    (utils/png.py) and JPEG decoder (utils/jpeg.py), since the card has
    no OpenCV;
  - `FramesProvider`: frame supervision (num_rays random pixels of one
    random frame per step, optionally weighted by an error map; with
    rand_pose, every so many batches a random orbit pose's full ray grid
    for the CLIP step instead), and the source of validation and test
    views, with the stereo rigs' event camera views (`stereo_views`);
  - `EventProvider` (per-event poses precomputed on the host, or
    interpolated on the device per batch with precompute_evs_poses=0), its
    per-image event windows (tumvie / eds: a window drawn each step), the
    event camera's own intrinsics, its no-event pairs
    (negative_event_sampling) and its frames for the frame term of
    event_only=0;
  - `make_providers` for mode=synthetic, esim, tumvie and eds.
Everything a step samples lives on the provider's device, and every draw
comes from the caller's torch.Generator, so a batch costs no host-device
transfer and no sync.
"""

import glob
import json
import os

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from enerf_torch.backend import resolve_device
from enerf_torch.data import eds, synthetic, tumvie
from enerf_torch.data.events import build_event_chains, sample_event_batch
from enerf_torch.data.poses import (
    get_hom_trafos, interp_pose_device, make_pose_interpolator, mat_to_quat_np,
    nerf_matrix_to_ngp,
)
from enerf_torch.data.rays import get_event_rays, get_rays_full, get_rays_sampled
from enerf_torch.parallel import multihost
from enerf_torch.utils import profiling
from enerf_torch.utils.jpeg import read_jpeg, write_jpeg
from enerf_torch.utils.png import read_png, resize_area, write_png


# ----------------------------------------------------------------------------
# pose conventions (reference pose_utils.py:250-262, 664-676)


def rub_from_rdf(poses):
    """[N, 3or4, >=4]: negate the y and z basis columns (an involution)."""
    p = np.array(poses, np.float64, copy=True)
    p[:, :3, 1] *= -1
    p[:, :3, 2] *= -1
    return p


def ngp_from_raw_rdf(pose_rdf, scale):
    """The esim chain: raw rdf c2w -> rub -> nerf_matrix_to_ngp."""
    return nerf_matrix_to_ngp(rub_from_rdf(pose_rdf[None])[0], scale=scale)


def raw_rdf_from_ngp(pose_ngp, scale):
    """Inverse of ngp_from_raw_rdf (the dataset writer's)."""
    p = np.asarray(pose_ngp, np.float64)
    rub = np.eye(4)
    # nerf_matrix_to_ngp took rub rows (1, 2, 0) to ngp rows (0, 1, 2)
    for src, dst in ((0, 1), (1, 2), (2, 0)):
        rub[dst, :] = p[src, 0], -p[src, 1], -p[src, 2], p[src, 3] / scale
    return rub_from_rdf(rub[None])[0]


# ----------------------------------------------------------------------------
# the esim on-disk format: loader and writer


def resolve_image_dir(datadir, mode, e2vid=0, images_corrupted=False, default_dir=None):
    """The image source (reference provider.py:487-545, 731-735): with
    e2vid N the E2VID reconstructions (e2vids/e2vid_upN_*/e2calib*/), with
    images_corrupted the images_corrupted/ folder (training only), else
    `default_dir`.  Returns (dir, kind), kind in {'clean', 'e2vid',
    'corrupted'}."""
    if e2vid:
        pats = {
            "esim": f"e2vids/e2vid_up{e2vid}_*/e2calib/",
            "eds": f"e2vids/left/e2vid_up{e2vid}_*/e2calib_undistorted/",
            "tumvie": f"e2vids/e2vid_up{e2vid}_*/e2calib_undistorted/",
        }
        pat = pats.get(mode, pats["esim"])
        hits = sorted(glob.glob(os.path.join(datadir, pat)))
        if not hits:
            raise FileNotFoundError(f"--e2vid {e2vid}: no reconstruction dir matching {pat} "
                                    f"under {datadir}")
        return hits[0], "e2vid"
    if images_corrupted:
        d = os.path.join(datadir, "images_corrupted")
        if not os.path.isdir(d):
            raise FileNotFoundError(f"images_corrupted=1 but {d} is missing")
        return d, "corrupted"
    return default_dir, "clean"


def _is_jpeg(path):
    return path.lower().endswith((".jpg", ".jpeg"))


def read_unchanged(path):
    """cv2.imread(path, IMREAD_UNCHANGED) of a PNG or JPEG file: gray as
    [H, W], colour as [H, W, 3] BGR (PNGs with alpha [H, W, 4] BGRA).
    Other formats raise, naming the file."""
    if _is_jpeg(path):
        return read_jpeg(path)
    if path.lower().endswith(".png"):
        return read_png(path)
    raise ValueError(f"{path}: the port reads PNG and JPEG images only")


def write_image(path, img):
    """cv2.imwrite(path, img) for a .png or .jpg / .jpeg path: img is gray
    [H, W], BGR [H, W, 3] or (PNG only) BGRA [H, W, 4], uint8 (PNG also
    uint16); a JPEG at cv2's defaults (quality 95, 4:2:0)."""
    img = np.asarray(img)
    if _is_jpeg(path):
        return write_jpeg(path, img)
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port writes PNG and JPEG images only")
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    return write_png(path, img)


# libpng's rgb_to_gray at cv2's (0.299, 0.587) in 15-bit fixed point: R, G, B
_GRAY_RGB = np.array([9797, 19234, 3737], np.int64)


def read_gray(path):
    """cv2.imread(path, IMREAD_GRAYSCALE) of an 8-bit PNG or a JPEG: a
    JPEG's Y plane (libjpeg's JCS_GRAYSCALE output); for a colour PNG
    libpng's truncating rgb_to_gray, alpha dropped.  16-bit PNGs raise."""
    if _is_jpeg(path):
        return read_jpeg(path, gray=True)
    im = read_unchanged(path)
    if im.dtype != np.uint8:
        raise NotImplementedError(f"{path}: grayscale reads of {im.dtype} PNGs are not "
                                  "supported")
    if im.ndim == 2:
        return im
    return ((im[..., 2::-1].astype(np.int64) @ _GRAY_RGB) >> 15).astype(np.uint8)


def read_image(path, out_dim_color, downscale=1):
    """One PNG or JPEG -> [H, W, C] float32 (8-bit images in [0, 1]), as the
    JAX package's cv2 reader gives it: RGB (alpha dropped, gray repeated),
    an INTER_AREA downscale, and luma when out_dim_color is 1.  Other
    formats, and JPEG files outside the decoder's subset (utils/jpeg.py),
    raise, naming the file."""
    im = read_unchanged(path)
    im = im[..., 2::-1] if im.ndim == 3 else im[..., None].repeat(3, -1)
    if downscale > 1:
        im = resize_area(im, downscale)
    im = im.astype(np.float32) / 255.0
    if out_dim_color == 1:
        im = (im @ np.asarray([0.299, 0.587, 0.114], np.float32))[..., None]
    return im


def _load_image_stack(imgdir, out_dim_color, downscale, expect=None):
    """The sorted png / jpg files of `imgdir` -> [F, H, W, C] float32."""
    paths = sorted(glob.glob(os.path.join(imgdir, "*.png"))
                   + glob.glob(os.path.join(imgdir, "*.jpg")))
    if not paths:
        raise FileNotFoundError(f"no images in {imgdir}")
    if expect is not None and len(paths) != expect:
        raise ValueError(f"{imgdir}: {len(paths)} images but {expect} timestamps — the "
                         "alternate image source must align with the frame stamps")
    return np.stack([read_image(p, out_dim_color, downscale) for p in paths])


def load_esim_dataset(datadir, scale=0.33, out_dim_color=1, downscale=1, e2vid=0,
                      images_corrupted=False):
    """An esim-format directory -> dict(images [F, H, W, C] float32,
    tss_imgs_ns [F], poses [F, 4, 4] (the final ngp frame), intrinsics
    (fx, fy, cx, cy), hf_ts [K], hf_poses [K, 4, 4], events [M, 4]
    (x, y, ts_ns, pol +-1), event_frame_ids [M], H, W).  With e2vid the
    images are the reconstructions (the reference evaluates against them
    too); with images_corrupted a separate `train_images` is returned and
    `images` stay clean (the reference trains on the corrupted folder
    only)."""
    pose_files = glob.glob(os.path.join(datadir, "*poses_all*.txt"))
    if not pose_files:
        raise FileNotFoundError(f"no *poses_all*.txt in {datadir}")
    quatlist = np.loadtxt(pose_files[0], skiprows=1)
    if quatlist.ndim != 2 or quatlist.shape[1] != 8:
        raise ValueError(f"{pose_files[0]}: rows must be ts_ns px py pz qx qy qz qw")
    hf_ts = quatlist[:, 0]
    hf_raw = get_hom_trafos(R.from_quat(quatlist[:, 4:8]).as_matrix(), quatlist[:, 1:4])

    clean_dir = os.path.join(datadir, "images")
    tss_imgs_ns = np.loadtxt(os.path.join(clean_dir, "image_stamps_ns.txt"))
    imgdir, kind = resolve_image_dir(datadir, "esim", e2vid, images_corrupted,
                                     default_dir=clean_dir)
    train_images = None
    images = _load_image_stack(imgdir if kind == "e2vid" else clean_dir, out_dim_color,
                               downscale, expect=len(tss_imgs_ns))
    if kind == "corrupted":
        train_images = _load_image_stack(imgdir, out_dim_color, downscale,
                                         expect=len(tss_imgs_ns))
    H, W = images.shape[1:3]

    # intrinsics from poses_bounds' hwf (reference load_intrinsics)
    hwf = np.load(os.path.join(datadir, "poses_bounds.npy"))[0, :15].reshape(3, 5)[:, 4]
    focal = hwf[2] / downscale
    intrinsics = (focal, focal, W / 2.0, H / 2.0)

    # raw poses at the image times, then the final frame
    img_raw = make_pose_interpolator(hf_ts, hf_raw)(np.clip(tss_imgs_ns, hf_ts[0], hf_ts[-1]))
    img_hom = get_hom_trafos(img_raw[:, :3, :3], img_raw[:, :3, 3])
    poses = np.stack([ngp_from_raw_rdf(p, scale) for p in img_hom])
    hf_final = np.stack([ngp_from_raw_rdf(p, scale) for p in hf_raw])

    ev_files = sorted(glob.glob(os.path.join(datadir, "events", "*.npy")))
    chunks = [np.load(f)[:, :4] for f in ev_files]
    events = np.concatenate(chunks) if chunks else np.zeros((0, 4))
    frame_ids = (np.concatenate([np.full(len(c), i, np.int64) for i, c in enumerate(chunks)])
                 if chunks else np.zeros((0,), np.int64))
    if events.shape[0] and set(np.unique(events[:, 3])) <= {0.0, 1.0}:
        events[:, 3] = events[:, 3] * 2.0 - 1.0  # polarity to +-1 (transform_pol)

    out = {"images": images, "tss_imgs_ns": tss_imgs_ns, "poses": poses,
           "intrinsics": intrinsics, "hf_ts": hf_ts, "hf_poses": hf_final, "events": events,
           "event_frame_ids": frame_ids, "H": H, "W": W}
    if train_images is not None:
        out["train_images"] = train_images
    return out


# The per-scene pose nudges the reference hardcodes after loading
# (provider.py:611-618, update_poses :705-718): translations in the final
# ngp frame, applied to the keyframe and the high-frequency poses.
_SCENE_POSE_OFFSETS = {
    "11_all_characters": (-1.5, -0.5, -0.75),
    "00_peanuts_dark": (-1.0, -0.5, -1.0),  # skipped when pp_poses_sphere
    "ShakeCarpet1": (0.0, 0.0, 0.3),
}


def apply_scene_pose_offset(datadir, data, pp_poses_sphere=False):
    """The reference's dataset-specific pose offset, in place, keyed on the
    scene directory's name (peanuts_dark only without the sphere
    preprocessing)."""
    name = os.path.basename(os.path.normpath(datadir or ""))
    off = next((xyz for key, xyz in _SCENE_POSE_OFFSETS.items() if key in name), None)
    if off is None or (name.startswith("00_peanuts_dark") and pp_poses_sphere):
        return data
    for key in ("poses", "hf_poses", "val_poses"):
        if data.get(key) is not None and len(data[key]):
            data[key][:, :3, 3] += np.asarray(off)
    return data


def write_transforms_json(workspace, data, split="train"):
    """The reference's workspace transforms file (provider.py:869-965):
    intrinsics and each frame's c2w, for interchange with its tooling."""
    fx, fy, cx, cy = [float(v) for v in data["intrinsics"]]
    H, W = int(data["H"]), int(data["W"])
    iev = data.get("intrinsics_evs", data["intrinsics"])
    out = {
        "camera_angle_x": float(2 * np.arctan(W / (2 * fx))),
        "camera_angle_y": float(2 * np.arctan(H / (2 * fy))),
        "fl_x": fx, "fl_y": fy,
        "k1": 0, "k2": 0, "p1": 0, "p2": 0,
        "cx": cx, "cy": cy, "w": W, "h": H,
        "h_evs": int(data.get("H_ev", H)), "w_evs": int(data.get("W_ev", W)),
        "fl_x_evs": float(iev[0]), "fl_y_evs": float(iev[1]),
        "cx_evs": float(iev[2]), "cy_evs": float(iev[3]),
        "frames": [
            {"file_path": f"images/{i:06d}.png",
             "ts_ns": float(data["tss_imgs_ns"][i]) if "tss_imgs_ns" in data else None,
             "transform_matrix": np.asarray(p)[:4, :4].tolist()}
            for i, p in enumerate(data["poses"])
        ],
    }
    os.makedirs(workspace, exist_ok=True)
    path = os.path.join(workspace, f"transform_{split}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return path


def save_esim_dataset(data, datadir, scale=0.33):
    """Write the synthetic simulator's output (synthetic.simulate_events) in
    the reference's esim format: images/ (8-bit gray PNG, written by the
    port's writer) with image_stamps_ns.txt, poses_all.txt (a raw rdf pose
    list, 4 per frame), poses_bounds.npy (hwf) and events/ (one .npy of
    (x, y, ts_ns, pol) per frame interval)."""
    os.makedirs(os.path.join(datadir, "images"), exist_ok=True)
    os.makedirs(os.path.join(datadir, "events"), exist_ok=True)
    H, W = data["H"], data["W"]
    ts_ns = data["frame_ts"] * 1e9
    np.savetxt(os.path.join(datadir, "images", "image_stamps_ns.txt"), ts_ns)
    for i, im in enumerate(data["frames"]):
        img8 = (np.clip(im[..., 0], 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(datadir, "images", f"{i:06d}.png"), img8)

    hf_t = np.linspace(data["frame_ts"][0], data["frame_ts"][-1], 4 * len(ts_ns))
    rows = []
    for t in hf_t:
        raw = raw_rdf_from_ngp(data["pose_fn"](t), scale)
        rows.append([t * 1e9, *raw[:3, 3], *R.from_matrix(raw[:3, :3]).as_quat()])
    np.savetxt(os.path.join(datadir, "poses_all.txt"), np.asarray(rows),
               header="ts_ns px py pz qx qy qz qw")

    pb = np.zeros((max(len(ts_ns), 11), 17))  # the loader reads hwf only
    base = np.eye(3, 5)
    base[:, 4] = (H, W, data["intrinsics"][0])
    pb[:, :15] = base.ravel()
    np.save(os.path.join(datadir, "poses_bounds.npy"), pb)

    ev = data["events"]
    for fid in range(len(ts_ns) - 1):
        t0, t1 = data["frame_ts"][fid], data["frame_ts"][fid + 1]
        last = fid == len(ts_ns) - 2  # the last interval includes its end
        m = (ev[:, 2] >= t0) & ((ev[:, 2] <= t1) if last else (ev[:, 2] < t1))
        chunk = ev[m].copy()
        chunk[:, 2] *= 1e9  # seconds -> ns
        np.save(os.path.join(datadir, "events", f"{fid:06d}.npy"), chunk)
    return datadir


# ----------------------------------------------------------------------------
# providers (the protocol train/trainer.py consumes)


def frame_batch(images, poses, intrinsics, H, W, num_rays, generator=None, fi=None,
                inds=None, error_map=None, inds_coarse=None, jitter=None):
    """num_rays random pixel rays of one random frame and their ground truth
    (reference collate provider.py:1057-1104; JAX's _frames_sample_jit):
    images [F, H*W, C] and poses [F, 4, 4] on one device, optional
    error_map [F, 128*128].  Returns (fi [1], the get_rays_sampled dict,
    batch dict(rays_o, rays_d [N, 3], images [N, C])).  The frame index
    `fi` and the pixel draws (`inds`, or with the error map `inds_coarse`
    and `jitter`) come from `generator` unless handed in; index_select keeps
    the draw on the device."""
    if fi is None:
        fi = torch.randint(0, images.shape[0], (1,), device=images.device, generator=generator)
    emap = None if error_map is None else error_map.index_select(0, fi)[0]
    rays = get_rays_sampled(poses.index_select(0, fi)[0], intrinsics, H, W, num_rays, generator,
                            inds, error_map=emap, inds_coarse=inds_coarse, jitter=jitter)
    batch = {"rays_o": rays["rays_o"], "rays_d": rays["rays_d"],
             "images": images.index_select(0, fi)[0][rays["inds"]]}
    return fi, rays, batch


class FramesProvider:
    """Frame supervision (reference NeRFDataset), with optional
    error-map-weighted pixel sampling (utils.py:134-156, 611-632), and the
    source of validation and test views.  `stereo_views`: the event camera
    views of a stereo rig (tumvie / eds), dicts of pose [4, 4],
    intrinsics, H, W and gt None, rendered by the evaluation beside the
    frame views (reference provider.py:1087-1091).

    rand_pose (reference main_nerf.py:183, wired as the JAX package wires
    it): < 0 never, 0 every batch, > 0 the batches whose count (from 1) is a
    multiple of rand_pose + 1 are rand-pose batches: a look-at orbit pose at
    rand_radius * U(1, 1.2), its full side x side ray grid (side =
    max(floor(sqrt(rand_pose_rays)), 8), a 60 degree field of view) and
    `rand_pose_side`, no images.  rand_pose_rays defaults to num_rays; a
    data-parallel rank passes the config's global num_rays, as every rank
    renders the whole rand-pose image."""

    def __init__(self, images, poses, intrinsics, num_rays=4096, steps_per_epoch=100,
                 error_map=False, stereo_views=None, rand_pose=-1, rand_radius=2.5,
                 rand_pose_rays=None, device="cpu"):
        self.device = torch.device(device)
        self.stereo_views = stereo_views
        self.rand_pose, self.rand_radius = int(rand_pose), float(rand_radius)
        self.rand_pose_rays = num_rays if rand_pose_rays is None else int(rand_pose_rays)
        self._batch_i = 0
        self.H, self.W = images.shape[1:3]
        self.intrinsics = intrinsics
        self.num_rays = num_rays
        self.steps_per_epoch = steps_per_epoch
        self.train_poses = np.asarray(poses)  # the cameras mark_untrained_grid reads
        self._images_np = images
        # [F, H*W, C] and [F, 4, 4] on the device
        self.images = torch.as_tensor(
            np.asarray(images, np.float32).reshape(images.shape[0], -1, images.shape[-1]),
            device=self.device)
        self.poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=self.device)
        self.error_map = (torch.ones(images.shape[0], 128 * 128, device=self.device)
                          if error_map else None)

    def _rand_pose_batch(self, generator=None, draws=None):
        """A random orbit pose's full ray grid; its three draws (radius,
        theta, phi as U(0, 1) [3]) on the device from `generator`, or
        `draws`.  The pose is built on the device: no host sync."""
        u = draws if draws is not None else torch.rand(3, device=self.device,
                                                       generator=generator)
        side = max(int(np.sqrt(self.rand_pose_rays)), 8)
        r = self.rand_radius * (1.0 + 0.2 * u[0])
        theta = np.pi / 6 + (np.pi / 2 - np.pi / 6) * u[1]
        phi = 2 * np.pi * u[2]
        eye = torch.stack([r * torch.sin(theta) * torch.cos(phi),
                           r * torch.sin(theta) * torch.sin(phi), r * torch.cos(theta)])
        # look-at with rdf axes (synthetic.look_at_pose)
        f = -eye / torch.linalg.vector_norm(eye)
        up = torch.tensor([0.0, 0.0, 1.0], device=eye.device)
        rt = torch.linalg.cross(f, up)
        rt = rt / torch.linalg.vector_norm(rt)
        pose = torch.stack([rt, torch.linalg.cross(f, rt), f, eye], dim=1)  # [3, 4]
        fx = side / (2.0 * np.tan(np.radians(30.0)))
        ro, rd = get_rays_full(pose, (fx, fx, side / 2.0, side / 2.0), side, side)
        return {"rays_o": ro, "rays_d": rd, "rand_pose_side": side}

    def train_step_batch(self, generator=None, pose_generator=None, **draws):
        """One frame batch (see frame_batch; `draws` hands in fi, inds,
        inds_coarse, jitter), or a rand-pose batch at rand_pose's cadence,
        its pose drawn from `pose_generator` (a mesh's shared generator:
        every rank draws the same pose) or else `generator`."""
        self._batch_i += 1
        if self.rand_pose == 0 or (self.rand_pose > 0
                                   and self._batch_i % (self.rand_pose + 1) == 0):
            return self._rand_pose_batch(generator if pose_generator is None else pose_generator)
        fi, rays, batch = frame_batch(self.images, self.poses, self.intrinsics, self.H, self.W,
                                      self.num_rays, generator, error_map=self.error_map,
                                      **draws)
        if self.error_map is not None:
            self._last_fi, self._last_inds_coarse = fi, rays["inds_coarse"]
        return batch

    def error_map_cells(self):
        """The last batch's error-map cells: (frame [N], coarse cell [N])."""
        ic = self._last_inds_coarse
        return self._last_fi.expand_as(ic), ic

    def update_error_map(self, per_ray_loss, cells=None):
        """The error map's EMA at the last batch's coarse cells
        (utils.py:625-632; JAX's _errmap_update_jit).  A data-parallel
        trainer hands in every rank's cells and losses, gathered in rank
        order (`cells` = (frames, coarse cells)), and each rank's block is
        applied in that order, so every rank's map stays the same."""
        if self.error_map is None:
            return
        rows, ic = cells if cells is not None else self.error_map_cells()
        n = self.num_rays  # one rank's block
        loss = per_ray_loss.detach()
        for s in range(0, ic.shape[0], n):
            r, c = rows[s:s + n], ic[s:s + n]
            old = self.error_map[r, c]
            self.error_map.index_put_((r, c), 0.1 * old + 0.9 * loss[s:s + n])

    def val_views(self):
        poses = self.poses.cpu().numpy()
        return [{"pose": poses[i], "intrinsics": self.intrinsics,
                 "H": self.H, "W": self.W, "gt": self._images_np[i]}
                for i in range(len(self._images_np))]

    def test_views(self):
        return self.val_views()


def noev_arrays(events, H, W, chunk_frac=0.05):
    """Per time chunk, the pixels with no event in it (reference
    provider.py:1281-1351), padded to one array: (coords [J, Pmax, 2] f32
    (x, y), counts [J] int32, t0 [J] f32, t1 [J] f32).  A chunk's row is its
    pixel list tiled up to Pmax, so a draw below its count is uniform."""
    ev = np.asarray(events)
    t0, t1 = float(ev[:, 2].min()), float(ev[:, 2].max())
    n_chunks = max(int(1.0 / chunk_frac), 1)
    edges = np.linspace(t0, t1, n_chunks + 1)
    chunk_of = np.clip(np.searchsorted(edges, ev[:, 2], side="right") - 1, 0, n_chunks - 1)
    all_pix = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(-1, 2)
    coords = []
    for j in range(n_chunks):
        m = chunk_of == j
        has = np.zeros(H * W, bool)
        pix = ev[m, 1].astype(np.int64) * W + ev[m, 0].astype(np.int64)
        has[np.clip(pix, 0, H * W - 1)] = True
        coords.append(all_pix[~has].astype(np.float32))
    counts = [len(c) for c in coords]
    pmax = max(max(counts), 1)
    pad = np.zeros((n_chunks, pmax, 2), np.float32)
    for j, c in enumerate(coords):
        if len(c):
            pad[j] = np.tile(c, (-(-pmax // len(c)), 1))[:pmax]
    return (pad, np.asarray(counts, np.int32), edges[:-1].astype(np.float32),
            edges[1:].astype(np.float32))


class EventProvider:
    """Event-supervision provider (reference EventNeRFDataset): per-pixel
    chains built once on the host, batches sampled on `device`.  With
    `event_frame_ids` the events are grouped per image window (n_frames of
    them, tumvie / eds) and each batch samples one window drawn on the
    device; event and no-event rays are cast with `intrinsics_evs` (the
    event camera, H x W; default `intrinsics`), frame rays with
    `intrinsics`."""

    def __init__(self, events, hf_ts, hf_poses, intrinsics, H, W, batch_size_evs=4096,
                 accumulate_evs=False, acc_max_num_evs=0, steps_per_epoch=100,
                 precompute_evs_poses=True, negative_event_sampling=False,
                 noev_chunk_frac=0.05, frames=None, frame_poses=None, num_rays=4096,
                 event_frame_ids=None, n_frames=1, intrinsics_evs=None, device="cpu"):
        self.device = torch.device(device)
        # seconds of each part of the load, the host seconds of the spans
        # provider.chains and provider.poses (both end in a copy to the host
        # or from it, so the clock is the device's too)
        self.load_seconds = {}
        with profiling.span("provider.chains", self.device) as sp:
            self.chains, ev_ts_sorted = build_event_chains(events, event_frame_ids, n_frames,
                                                           device=self.device)
        self.load_seconds["chains"] = sp.host_s
        self.n_frames = n_frames if event_frame_ids is not None else 1
        # keyframe poses as (quat, trans) for the device interpolation
        hf_poses = np.asarray(hf_poses, np.float64)
        self.key_ts = torch.as_tensor(np.asarray(hf_ts, np.float64), dtype=torch.float32,
                                      device=self.device)
        self.key_quats = torch.as_tensor(mat_to_quat_np(hf_poses[:, :3, :3]),
                                         dtype=torch.float32, device=self.device)
        self.key_trans = torch.as_tensor(hf_poses[:, :3, 3], dtype=torch.float32,
                                         device=self.device)
        self.poses_evs = None
        with profiling.span("provider.poses", self.device) as sp:
            if precompute_evs_poses:
                # exact host Slerp + cubic per event (48 bytes/event on the device)
                interp = make_pose_interpolator(hf_ts, hf_poses)
                self.poses_evs = torch.as_tensor(interp(ev_ts_sorted), device=self.device)
        self.load_seconds["poses"] = sp.host_s
        self.noev_coords = None
        if negative_event_sampling and len(events):
            arrs = noev_arrays(events, H, W, noev_chunk_frac)
            self.noev_coords, self.noev_count, self.noev_t0, self.noev_t1 = (
                torch.as_tensor(a, device=self.device) for a in arrs)
        self.use_no_ev = True  # the trainer's epoch gate (epoch_start_noEvLoss)
        self.intrinsics = intrinsics
        self.intrinsics_evs = intrinsics_evs or intrinsics
        self.H, self.W = H, W
        self.batch_size_evs = batch_size_evs
        self.accumulate_evs = accumulate_evs
        self.acc_max_num_evs = acc_max_num_evs
        self.steps_per_epoch = steps_per_epoch
        self.num_rays = num_rays
        self.frames = None
        if frames is not None:
            # frames [F, H, W, C] on the device as [F, H*W, C]; their poses
            # are the cameras mark_untrained_grid reads (`train_poses`)
            self.frame_H, self.frame_W = frames.shape[1:3]
            self.frames = torch.as_tensor(
                np.asarray(frames, np.float32).reshape(frames.shape[0], -1, frames.shape[-1]),
                device=self.device)
            self.frame_poses = torch.as_tensor(np.asarray(frame_poses), dtype=torch.float32,
                                               device=self.device)
            self.train_poses = np.asarray(frame_poses)

    def _event_poses(self, idx):
        """Poses of flat event indices: the precomputed gather or the device
        interpolation (precompute_evs_poses=0)."""
        if self.poses_evs is not None:
            return self.poses_evs[idx]
        return interp_pose_device(self.key_ts, self.key_quats, self.key_trans,
                                  self.chains.ts[idx])

    def _no_event_rays(self, generator):
        """batch_size_evs // 2 pixel rays without events, at two sorted random
        times of one random chunk (reference provider.py:1443-1486)."""
        dev, n_no = self.device, self.batch_size_evs // 2
        j = torch.randint(0, self.noev_coords.shape[0], (1,), device=dev, generator=generator)
        count = self.noev_count[j].long().clamp(min=1)
        sel = (torch.rand(n_no, device=dev, generator=generator) * count).long()
        xy = self.noev_coords[j, torch.minimum(sel, count - 1)]  # [n_no, 2]
        u = torch.rand(n_no, 2, device=dev, generator=generator)
        tt = (self.noev_t0[j] + (self.noev_t1[j] - self.noev_t0[j]) * u).sort(dim=1).values
        p1, p2 = (interp_pose_device(self.key_ts, self.key_quats, self.key_trans, tt[:, i])
                  for i in (0, 1))
        rays = get_event_rays(xy[:, 0], xy[:, 1], p1, p2, self.intrinsics_evs)
        return {k.replace("evs", "no_evs"): v for k, v in rays.items()}

    def train_step_batch(self, generator=None, frame=None, draws=None):
        """One event batch (reference collate provider.py:1363-1499):
        paired rays at the poses of each sampled event and its successor,
        plus the no-event pairs when they are on.  The window is drawn
        from `generator` on the device when there are several (JAX's
        randint(0, n_frames)); `frame` ([1] int64) and `draws` (see
        sample_event_batch) hand them in."""
        if frame is None and self.n_frames > 1:
            frame = torch.randint(0, self.n_frames, (1,), device=self.device,
                                  generator=generator)
        samp = sample_event_batch(
            self.chains, 0 if frame is None else frame, self.batch_size_evs,
            generator=generator, accumulate=self.accumulate_evs,
            acc_max_num_evs=self.acc_max_num_evs, draws=draws)
        i0, i1 = samp["idx_start"], samp["idx_end"]
        rays = get_event_rays(self.chains.xs[i0], self.chains.ys[i0],
                              self._event_poses(i0), self._event_poses(i1),
                              self.intrinsics_evs)
        batch = dict(rays, pols=samp["pols"])
        if self.noev_coords is not None and self.use_no_ev:
            batch.update(self._no_event_rays(generator))
        if self.frames is not None:
            batch.update(self._frame_rays(generator))
        return batch

    def _frame_rays(self, generator, fi=None, inds=None):
        """The frame term's batch (frame_batch): num_rays random pixel rays
        of one random frame and their ground truth."""
        return frame_batch(self.frames, self.frame_poses, self.intrinsics, self.frame_H,
                           self.frame_W, self.num_rays, generator, fi, inds)[2]


def _maybe_write_transforms(cfg, data):
    """The workspace's transforms snapshot (the reference writes one on every
    real dataset load, provider.py:484-496), by rank 0 of a data-parallel
    job; it never stops training."""
    if not multihost.is_primary():
        return
    try:
        write_transforms_json(os.path.join(cfg.outdir, cfg.expweek, cfg.expname), data)
    except (OSError, KeyError, ValueError) as e:
        print(f"[provider] transforms.json snapshot skipped: {e}")


def _load_stereo_dataset(cfg, select_frames):
    """A tumvie / eds directory with the frames of select_frames: the
    train frames (and their event windows) as the JAX package loads them,
    the val frames by index into the whole sequence, as the reference's
    get_frames does (the JAX package keeps only val indices below the
    number of train frames loaded, which leaves the published configs
    without a val split)."""
    kw = dict(scale=cfg.scale, out_dim_color=cfg.out_dim_color, downscale=cfg.downscale,
              hotpixs=bool(cfg.hotpixs), e2vid=cfg.e2vid,
              images_corrupted=bool(cfg.images_corrupted),
              select_idxs=select_frames.get("train_idxs"),
              val_idxs=select_frames.get("val_idxs") or None)
    if cfg.mode == "tumvie":
        return tumvie.load_tumvie_dataset(cfg.datadir, pp_poses_sphere=bool(cfg.pp_poses_sphere),
                                          **kw)
    return eds.load_eds_dataset(cfg.datadir, **kw)


def make_providers(cfg, select_frames=None, device=None, shards=1):
    """(train_provider, val_provider) from cfg (enerf_tpu's make_providers):
    mode=synthetic runs the in-process event simulator, mode=esim, tumvie
    and eds read cfg.datadir.  With events=0 the train provider is a
    FramesProvider, else an EventProvider (serving frames too with
    event_only=0).  `select_frames` is __main__.get_select_frames' dict
    (train / val indices); without it the config's own indices.  For
    tumvie / eds the events are grouped per train image, and with
    eval_stereo_views the val provider carries the event camera's views at
    the val images' times.  `device=None` is the CUDA device
    (backend.resolve_device).  `shards`: the config's batch is the global
    batch of that many data-parallel ranks (--mesh_shape), so the train
    provider samples batch_size_evs / shards event pairs (and their
    no-event pairs) and num_rays / shards frame rays; a split that is not
    even raises.  That split is the per-step path's (fuse_steps 1, or
    frames mode with rand_pose, which the trainer keeps out of windows):
    otherwise the ranks train in windows (train/chunk.py), where each rank
    samples the config's whole batch, as each chip does in JAX's chunk.  A
    rand pose's image is the config's num_rays on every rank."""
    device = resolve_device(device)
    batch_size_evs, num_rays = cfg.batch_size_evs, cfg.num_rays
    per_step = cfg.fuse_steps <= 1 or (not cfg.events and cfg.rand_pose >= 0)
    if shards > 1 and per_step:
        split = {}  # what the train provider samples
        if cfg.events:
            split["batch_size_evs"] = batch_size_evs
            if cfg.negative_event_sampling:
                split["batch_size_evs // 2 (the no-event pairs)"] = batch_size_evs // 2
        if not (cfg.events and cfg.event_only):
            split["num_rays"] = num_rays
        uneven = [f"{k} = {v}" for k, v in split.items() if v % shards]
        if uneven:
            raise ValueError(f"the global batch does not split over {shards} ranks: "
                             + ", ".join(uneven))
        batch_size_evs, num_rays = batch_size_evs // shards, num_rays // shards
    if select_frames is None:
        select_frames = {"train_idxs": cfg.train_idxs, "val_idxs": cfg.val_idxs}
    ev_kw, stereo = {}, None
    if cfg.mode == "synthetic":
        data = synthetic.simulate_events(
            H=cfg.H, W=cfg.W, C=abs(cfg.C_thres) if cfg.C_thres > 0 else 0.2,
            n_frames=cfg.syn_frames, rich=int(cfg.syn_rich))
        images = (data["frames"] if cfg.out_dim_color == 1
                  else np.repeat(data["frames"], 3, -1))
        events, hf_ts, hf_poses = data["events"], data["frame_ts"], data["poses"]
        train_images, poses = images, data["poses"]
        va_idx = [i for i in select_frames.get("val_idxs") or range(len(images))
                  if i < len(images)]
        va_images, va_poses = images[va_idx], poses[va_idx]
    elif cfg.mode == "esim":
        data = load_esim_dataset(
            cfg.datadir, scale=cfg.scale, out_dim_color=cfg.out_dim_color,
            downscale=cfg.downscale, e2vid=cfg.e2vid,
            images_corrupted=bool(cfg.images_corrupted))
        apply_scene_pose_offset(cfg.datadir, data, pp_poses_sphere=bool(cfg.pp_poses_sphere))
        _maybe_write_transforms(cfg, data)
        images, n = data["images"], len(data["images"])
        events, hf_ts, hf_poses = data["events"], data["hf_ts"], data["hf_poses"]
        # images_corrupted trains on the corrupted folder and evaluates on
        # the clean one (reference provider.py:734-735)
        tr_idx = select_frames.get("train_idxs") or list(range(n))
        va_idx = [i for i in select_frames.get("val_idxs") or tr_idx[:1] if i < n]
        tr_idx = [i for i in tr_idx if i < n]
        train_images = data.get("train_images", images)[tr_idx]
        poses = data["poses"][tr_idx]
        va_images, va_poses = images[va_idx], data["poses"][va_idx]
    elif cfg.mode in ("tumvie", "eds"):
        data = _load_stereo_dataset(cfg, select_frames)
        apply_scene_pose_offset(cfg.datadir, data, pp_poses_sphere=bool(cfg.pp_poses_sphere))
        _maybe_write_transforms(cfg, data)
        events, hf_ts, hf_poses = data["events"], data["hf_ts"], data["hf_poses"]
        train_images, poses = data["images"], data["poses"]
        fids = data["event_frame_ids"]
        ev_kw = dict(event_frame_ids=fids, n_frames=int(fids.max()) + 1 if len(fids) else 1,
                     intrinsics_evs=data["intrinsics_evs"])
        # the val frames read by index, else every train frame
        src = "val_" if "val_images" in data else ""
        va_images, va_poses = data[src + "images"], data[src + "poses"]
        if cfg.eval_stereo_views:
            # the event camera's views at the val images' times
            ev_poses = make_pose_interpolator(hf_ts, hf_poses)(data[src + "tss_imgs_ns"])
            stereo = [{"pose": np.vstack([p, [0, 0, 0, 1]]),
                       "intrinsics": data["intrinsics_evs"], "H": data["H_ev"],
                       "W": data["W_ev"], "gt": None} for p in ev_poses]
    else:
        raise ValueError(f"unknown dataset mode {cfg.mode!r}")
    val = FramesProvider(va_images, va_poses, data["intrinsics"], num_rays=cfg.num_rays,
                         stereo_views=stereo, device=device)
    if not cfg.events:
        train = FramesProvider(train_images, poses, data["intrinsics"], num_rays=num_rays,
                               error_map=bool(cfg.error_map), rand_pose=cfg.rand_pose,
                               rand_radius=cfg.radius, rand_pose_rays=cfg.num_rays,
                               device=device)
    else:
        train = EventProvider(
            events, hf_ts, hf_poses, data["intrinsics"], data.get("H_ev", data["H"]),
            data.get("W_ev", data["W"]), batch_size_evs=batch_size_evs,
            accumulate_evs=bool(cfg.accumulate_evs), acc_max_num_evs=cfg.acc_max_num_evs,
            precompute_evs_poses=bool(cfg.precompute_evs_poses),
            negative_event_sampling=bool(cfg.negative_event_sampling),
            frames=None if cfg.event_only else train_images,
            frame_poses=None if cfg.event_only else poses,
            num_rays=num_rays, device=device, **ev_kw)
    return train, val
