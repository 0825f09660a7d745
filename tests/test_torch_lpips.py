"""Parity of the port's LPIPS (enerf_torch/train/lpips.py, metrics.compute_lpips)
with enerf_tpu's lpips_jax, with JAX's weights carried across."""

import numpy as np
import pytest
import torch

from torch_parity import carry_lpips_from_jax

import enerf_tpu.train.lpips_jax as LJ
from enerf_tpu.train import metrics as jmetrics
from enerf_torch.train import lpips as TL
from enerf_torch.train import metrics as tmetrics


def _pair(H, W, C, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(H, W, C)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


# 46 x 50: "SAME" pads AlexNet's 11 x 11 stride-4 stem 4 / 5 (asymmetric)
@pytest.mark.parametrize("H,W", [(48, 48), (46, 50)])
@pytest.mark.parametrize("C", [3, 1])
@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax_random_weights(monkeypatch, H, W, C, net):
    """f32 convolutions summed in other orders: relative 1e-4."""
    monkeypatch.delenv("ENERF_LPIPS_WEIGHTS", raising=False)
    LJ._get_net.cache_clear()
    carry_lpips_from_jax(monkeypatch)
    a, b = _pair(H, W, C, seed=H + C)
    dj = LJ.lpips_distance(a, b, net)
    dt = TL.lpips_distance(torch.from_numpy(a), torch.from_numpy(b), net)
    assert dj > 0
    np.testing.assert_allclose(dt, dj, rtol=1e-4)


def test_same_padding_matches_jax():
    """JAX's "SAME" for stride 4 / kernel 11 and stride 1 / kernel 3."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    for H, W, k, s in ((46, 50, 11, 4), (48, 45, 11, 4), (9, 10, 3, 1)):
        x = rng.normal(size=(1, H, W, 3)).astype(np.float32)
        w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
        yj = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
                                          dimension_numbers=("NHWC", "HWIO", "NHWC"))
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        yt = torch.nn.functional.conv2d(TL._same_pad(torch.from_numpy(x).permute(0, 3, 1, 2), k, s),
                                        wt, stride=s).permute(0, 2, 3, 1)
        assert yt.shape == yj.shape
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)


def _write_npz(path, rng):
    """A weight file in scripts/export_lpips_weights.py's layout (random
    values stand in for the exported ones)."""
    out = {}
    for net in ("alex", "vgg"):
        for i, (k, cin, cout) in enumerate(TL._layers(net)):
            out[f"{net}_conv{i}_w"] = rng.normal(scale=0.05, size=(k, k, cin, cout)).astype(
                np.float32)
            out[f"{net}_conv{i}_b"] = rng.normal(scale=0.01, size=cout).astype(np.float32)
        taps = [c for c, _, _, _ in TL._ALEX] if net == "alex" else [c for c, _ in TL._VGG_BLOCKS]
        for j, c in enumerate(taps):
            out[f"{net}_lin{j}"] = rng.uniform(0, 1, size=c).astype(np.float32)
    np.savez(path, **out)


@pytest.mark.parametrize("C", [3, 1])
def test_lpips_calibrated_npz_matches_jax(tmp_path, monkeypatch, C):
    """$ENERF_LPIPS_WEIGHTS read by both packages: the calibrated metric
    (trained convs + lin heads) within relative 1e-4, and the labels drop
    `_rand`; without the file both are back on their seeded weights."""
    path = str(tmp_path / "lpips_weights.npz")
    _write_npz(path, np.random.default_rng(0))
    monkeypatch.setenv("ENERF_LPIPS_WEIGHTS", path)
    LJ._get_net.cache_clear()
    try:
        assert TL.lpips_is_calibrated() and LJ.lpips_is_calibrated()
        assert tmetrics.lpips_label() == jmetrics.lpips_label() == ""
        a, b = _pair(40, 44, C, seed=3)
        for net in ("alex", "vgg"):
            dj = LJ.lpips_distance(a, b, net)
            dt = TL.lpips_distance(torch.from_numpy(a), torch.from_numpy(b), net)
            assert dj > 0
            np.testing.assert_allclose(dt, dj, rtol=1e-4, err_msg=net)
        assert TL.lpips_distance(torch.from_numpy(a), torch.from_numpy(a)) < 1e-6
        # a file without the arrays is ignored, as in the JAX package
        np.savez(str(tmp_path / "empty.npz"), x=np.zeros(1))
        monkeypatch.setenv("ENERF_LPIPS_WEIGHTS", str(tmp_path / "empty.npz"))
        assert not TL.lpips_is_calibrated()
    finally:
        monkeypatch.delenv("ENERF_LPIPS_WEIGHTS")
        LJ._get_net.cache_clear()
    assert tmetrics.lpips_label() == jmetrics.lpips_label() == "_rand"


def test_compute_lpips_and_the_port_seeded_weights(monkeypatch):
    """compute_lpips gives (alex, vgg) on the device asked for; grayscale is
    replicated to 3 channels; the port's own seeded weights are fixed
    (deterministic, zero at identity, monotone under distortion), He-normal
    with std sqrt(2 / fan_in), and are not JAX's draws."""
    monkeypatch.delenv("ENERF_LPIPS_WEIGHTS", raising=False)
    a, b = _pair(32, 36, 1, seed=5)
    alex, vgg = tmetrics.compute_lpips(a, b, rgb_channels=1, device="cpu")
    a3, b3 = np.repeat(a, 3, -1), np.repeat(b, 3, -1)
    assert (alex, vgg) == tmetrics.compute_lpips(a3, b3, device="cpu")
    assert 0 < alex and 0 < vgg
    assert TL.lpips_distance(a, a, device="cpu") < 1e-6
    rng = np.random.default_rng(6)
    noise = rng.normal(size=a3.shape).astype(np.float32)
    small = TL.lpips_distance(a3, np.clip(a3 + 0.05 * noise, 0, 1), device="cpu")
    big = TL.lpips_distance(a3, np.clip(a3 + 0.3 * noise, 0, 1), device="cpu")
    assert 0 < small < big
    convs, lins, calibrated = TL.get_net("vgg", "cpu")
    assert lins is None and not calibrated and len(convs) == 13
    for (w, bias), (k, cin, cout) in zip(convs, TL._layers("vgg")):
        assert w.shape == (cout, cin, k, k) and not bias.any()
    std = float(convs[1][0].std())
    assert abs(std - np.sqrt(2.0 / (9 * 64))) < 0.01 * std
    jw = np.asarray(LJ._get_net("alex")[0][0][0]).transpose(3, 2, 0, 1)
    assert not np.allclose(TL.get_net("alex", "cpu")[0][0][0].numpy(), jw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmetrics.compute_lpips(a, b)  # device=None is the card
