"""LPIPS (perceptual distance) in PyTorch, without the lpips package.

Counterpart of enerf_tpu/train/lpips_jax.py (reference nerf/utils.py:40-41,
1096-1112, which computes `lpips.LPIPS(net='alex')` and `net='vgg'` per
validation image): AlexNet- and VGG16-style conv stacks, each tap's
features unit-normalised over channels, the squared difference averaged
per layer and summed over the layers.  No pretrained weight is downloaded:

  - without weights the stacks take seeded He-normal weights (zero biases)
    and the metric is labelled `_rand`.  They come from torch.Generator
    seeds 0 (alex) and 1 (vgg), not from JAX's threefry draws, which no
    other framework reproduces: the port's `_rand` values are comparable
    between the port's runs, not with the JAX package's;
  - with an npz at $ENERF_LPIPS_WEIGHTS in the layout of
    scripts/export_lpips_weights.py (`{net}_conv{i}_w` HWIO, `{net}_conv{i}_b`,
    `{net}_lin{j}`) the calibrated metric: trained convs and the per-tap
    1x1 `lin` heads, and the label loses its suffix.  A file without those
    keys is ignored, as in the JAX package.

Layout: the convs are F.conv2d on NCHW with OIHW weights.  JAX's "SAME"
padding is asymmetric where the stride does not divide the input (AlexNet's
11x11 stride-4 stem): low = total // 2, high = the rest, padded explicitly.
Max-pool is 2x2 stride 2, VALID.  On the card cuDNN would run the float32
convs in TF32; `lpips_distance` turns TF32 off for its own call and
restores the setting, so the card computes the CPU's float32 metric.
"""

import contextlib
import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from enerf_torch.backend import resolve_device

# (out_ch, kernel, stride, pool_before) per conv layer; features are taken
# after each layer's ReLU (alex: 5 taps, vgg16: 5 taps at block ends)
_ALEX = [(64, 11, 4, False), (192, 5, 1, True), (384, 3, 1, True),
         (256, 3, 1, False), (256, 3, 1, False)]
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# ImageNet normalization the torch LPIPS applies to [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _layers(net):
    """[(k, cin, cout)] of the net's convs, in order."""
    if net == "alex":
        cins = [3] + [c for c, _, _, _ in _ALEX[:-1]]
        return [(k, cin, cout) for (cout, k, _, _), cin in zip(_ALEX, cins)]
    out, cin = [], 3
    for cout, reps in _VGG_BLOCKS:
        for _ in range(reps):
            out.append((3, cin, cout))
            cin = cout
    return out


def _random_weights(net):
    """Seeded He-normal OIHW weights and zero biases (seed 0 alex, 1 vgg)."""
    gen = torch.Generator().manual_seed(0 if net == "alex" else 1)
    return [(torch.randn((cout, cin, k, k), generator=gen) * math.sqrt(2.0 / (k * k * cin)),
             torch.zeros(cout)) for k, cin, cout in _layers(net)]


def lpips_params_from_jax(params):
    """The JAX package's [(w HWIO, b)] (as arrays) -> the port's [(w OIHW, b)]."""
    return [(torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))),
             torch.from_numpy(np.array(b, np.float32))) for w, b in params]


def _load_external(net, path):
    """(convs, lins) from the npz at `path`, or None when it lacks a key."""
    z = np.load(path)
    try:
        convs = lpips_params_from_jax([(z[f"{net}_conv{i}_w"], z[f"{net}_conv{i}_b"])
                                       for i in range(len(_layers(net)))])
        lins = [torch.from_numpy(np.array(z[f"{net}_lin{j}"], np.float32)) for j in range(5)]
    except KeyError:
        return None
    return convs, lins


@functools.lru_cache(maxsize=8)
def _net(net, path, device):
    ext = _load_external(net, path) if path and os.path.exists(path) else None
    convs, lins, calibrated = (*ext, True) if ext is not None else (_random_weights(net), None,
                                                                    False)
    convs = [(w.to(device), b.to(device)) for w, b in convs]
    return convs, None if lins is None else [w.to(device) for w in lins], calibrated


def get_net(net, device="cpu"):
    """(convs [(w OIHW, b)], lins or None, calibrated) on `device`: from the
    npz at $ENERF_LPIPS_WEIGHTS when it has the net's arrays, else seeded.
    Cached per (net, file, device)."""
    return _net(net, os.environ.get("ENERF_LPIPS_WEIGHTS"), str(torch.device(device)))


def lpips_is_calibrated():
    """True when external (trained) weights are in use."""
    return get_net("alex")[2]


def _same_pad(x, k, s):
    """JAX's "SAME" padding of an NCHW tensor for kernel k, stride s."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv(x, w, b, stride):
    return F.relu(F.conv2d(_same_pad(x, w.shape[-1], stride), w, b, stride=stride))


def _features(net, convs, x):
    feats = []
    if net == "alex":
        for (w, b), (_, _, stride, pool) in zip(convs, _ALEX):
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = _conv(x, w, b, stride)
            feats.append(x)
        return feats
    i = 0
    for bi, (_, reps) in enumerate(_VGG_BLOCKS):
        if bi > 0:
            x = F.max_pool2d(x, 2, 2)
        for _ in range(reps):
            x = _conv(x, *convs[i], 1)
            i += 1
        feats.append(x)
    return feats


def _unit_normalize(f):
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _prep(img, device):
    """[H, W], [H, W, 1] or [H, W, 3] in [0, 1] -> normalised [1, 3, H, W]."""
    x = torch.as_tensor(img, dtype=torch.float32, device=device)
    if x.ndim == 2:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:2], 3)
    shift = torch.tensor(_SHIFT, device=device)
    scale = torch.tensor(_SCALE, device=device)
    return ((2.0 * x - 1.0 - shift) / scale).permute(2, 0, 1)[None]


@torch.no_grad()
def lpips_distance(img0, img1, net="alex", device=None):
    """Perceptual distance between two [H, W, C] images in [0, 1] (tensors
    or arrays), computed on `device` (default: img0's device if it is a
    tensor, else the card).  Grayscale inputs are replicated to 3 channels
    (the reference passes grayscale renders through RGB LPIPS the same way)."""
    if device is None:
        device = img0.device if isinstance(img0, torch.Tensor) else resolve_device(None)
    convs, lins, _ = get_net(net, device)
    with _no_tf32():
        f0 = _features(net, convs, _prep(img0, device))
        f1 = _features(net, convs, _prep(img1, device))
        d = torch.zeros((), device=device)
        for j, (a, b) in enumerate(zip(f0, f1)):
            sq = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            if lins is None:  # uncalibrated: mean over channels (lin weights = 1/C)
                d = d + sq.mean()
            else:  # calibrated: the 1x1 lin head over channels
                d = d + (sq * lins[j][None, :, None, None]).sum(1).mean()
    return float(d)
