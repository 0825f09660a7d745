"""Parity of the port's run diagnostics (enerf_torch/utils/plotting.py) with
enerf_tpu's: the same files for an event provider with negative sampling,
and the numeric images pixel for pixel."""

import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_tpu.data import synthetic as jsyn
from enerf_tpu.data.provider import EventProvider as JEventProvider
from enerf_tpu.utils import plotting as jplot
from enerf_torch.data.provider import EventProvider as TEventProvider
from enerf_torch.utils import plotting as tplot

cv2 = pytest.importorskip("cv2")

NUMERIC = ("ev_accumulation.png", "ev_histogram.png", "noev_coverage.png")


def _providers():
    d = jsyn.simulate_events(H=32, W=32, n_frames=20, C=0.12, turns=0.4)
    kw = dict(batch_size_evs=64, negative_event_sampling=True)
    jp = JEventProvider(d["events"], d["frame_ts"], d["poses"], d["intrinsics"], 32, 32, **kw)
    tp = TEventProvider(d["events"], d["frame_ts"], d["poses"], d["intrinsics"], 32, 32,
                        device="cpu", **kw)
    for p in (jp, tp):
        p.train_poses = d["poses"]
        p.intrinsics = d["intrinsics"]
    return jp, tp, d


def test_run_diagnostics_match_jax(tmp_path):
    jp, tp, _ = _providers()
    out_j = jplot.dump_run_diagnostics(str(tmp_path / "jax"), jp)
    out_t = tplot.dump_run_diagnostics(str(tmp_path / "torch"), tp)
    assert not any(str(p).startswith("(") for p in out_t), out_t
    names_j = {os.path.basename(str(p)) for p in out_j}
    names_t = {os.path.basename(str(p)) for p in out_t}
    assert names_t == names_j
    assert set(NUMERIC) | set(tplot.PLOTS) <= names_t
    for name in NUMERIC:
        got = cv2.imread(str(tmp_path / "torch" / "diagnostics" / name), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(tmp_path / "jax" / "diagnostics" / name), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)
    # not a blank image: the events and the no-event pixels are there
    acc = cv2.imread(str(tmp_path / "torch" / "diagnostics" / "ev_accumulation.png"))
    assert (acc != 255).any(axis=-1).mean() > 0.05
    for name in tplot.PLOTS:
        assert os.path.getsize(tmp_path / "torch" / "diagnostics" / name) > 1000


def test_numeric_images_match_jax_functions():
    """RGB here, BGR in the JAX package; a negative event wins a pixel that
    has both; the histogram in float64."""
    rng = np.random.default_rng(0)
    xs = rng.integers(-2, 20, 500).astype(np.float32)
    ys = rng.integers(-2, 14, 500).astype(np.float32)
    pols = rng.choice([-1.0, 1.0], 500).astype(np.float32)
    acc = tplot.render_ev_accumulation(xs, ys, pols, 12, 18).numpy()
    np.testing.assert_array_equal(acc[..., ::-1], jplot.render_ev_accumulation(xs, ys, pols, 12, 18))
    hist = tplot.event_histogram(xs, ys, pols, 12, 18)
    np.testing.assert_array_equal(hist.numpy(), jplot.event_histogram(xs, ys, pols, 12, 18))
    mx = max(np.abs(hist.numpy()).max(), 1.0)
    np.testing.assert_array_equal(tplot.histogram_image(hist).numpy(),
                                  ((hist.numpy() / mx + 1.0) * 127.5).astype(np.uint8))


def test_diagnostics_without_matplotlib(tmp_path, monkeypatch):
    """The card's Python has no matplotlib: the numeric images are written
    and the four plots are skipped, named in one entry."""
    _, tp, _ = _providers()
    monkeypatch.setattr(tplot, "_has_matplotlib", lambda: False)
    out = tplot.dump_run_diagnostics(str(tmp_path), tp)
    skipped = [p for p in out if str(p).startswith("(skipped")]
    assert len(skipped) == 1 and all(name in skipped[0] for name in tplot.PLOTS)
    assert {os.path.basename(p) for p in out if p not in skipped} == set(NUMERIC)
