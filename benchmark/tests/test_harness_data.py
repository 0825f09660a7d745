"""The generator: the same seed gives the same inputs, every seed the same
sizes, and the inputs have the data's real shape."""

import numpy as np
import pytest

from benchmark import data, harness
from benchmark.tests.tiny_cells import tiny_cell


def inputs(name, seed, split="train"):
    cell = tiny_cell(name)
    return data.make_inputs(cell.config_file["data"], cell.cfg, seed, split)


@pytest.mark.parametrize("name", ["mocapDesk2_enerf.train", "spiral1_nerf.train"])
def test_same_seed_same_inputs_other_seed_same_sizes(name):
    a, b, c = inputs(name, 2 ** 31 + 11), inputs(name, 2 ** 31 + 11), inputs(name, 5)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
            assert a[k].shape == c[k].shape, k
        else:
            assert a[k] == b[k], k
    key = "events" if "events" in a else "images"
    assert not np.array_equal(a[key], c[key])


def test_events_have_the_stream_shape():
    cell = tiny_cell("mocapDesk2_enerf.train")
    d = cell.config_file["data"]
    inp = inputs("mocapDesk2_enerf.train", 77)
    ev, fid = inp["events"], inp["event_frame_ids"]
    assert ev.shape == (d["num_events"], 4)
    assert inp["n_frames"] == len(cell.cfg["train_idxs"]) == fid.max() + 1
    assert np.all(np.diff(ev[:, 2]) >= 0)  # sorted times, windows in order
    assert np.all(np.diff(fid) >= 0)
    assert set(np.unique(ev[:, 3])) == {-1.0, 1.0}
    assert np.mean(ev[:, 0] != np.floor(ev[:, 0])) > 0.9  # fractional coordinates
    assert ev[:, 0].min() >= 0 and ev[:, 0].max() < inp["W_ev"]
    assert ev[:, 1].min() >= 0 and ev[:, 1].max() < inp["H_ev"]
    # the windows: 19 of ~0.526 s, centred on the train images (20 Hz)
    span = [np.ptp(ev[fid == i, 2]) for i in range(inp["n_frames"])]
    assert 0.45e9 < np.median(span) < 0.53e9
    assert inp["hf_ts"][0] <= ev[0, 2] and ev[-1, 2] <= inp["hf_ts"][-1]


@pytest.mark.parametrize("name", ["mocapDesk2_enerf.train", "spiral1_nerf.train"])
def test_cameras_look_into_the_box(name):
    inp = inputs(name, 3)
    poses = inp["hf_poses"] if "hf_poses" in inp else inp["poses"]
    bound = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), name).cfg["bound"]
    eye, fwd = poses[:, :3, 3], poses[:, :3, 2]
    assert np.all(np.abs(eye) < bound)
    # the optical axis passes near the centre of the box
    to_centre = -eye / np.linalg.norm(eye, axis=1, keepdims=True)
    assert np.all(np.sum(fwd * to_centre, 1) > 0.95)
    R = poses[:, :3, :3]
    assert np.allclose(np.einsum("nij,nik->njk", R, R), np.eye(3), atol=1e-9)
    assert np.allclose(np.linalg.det(R), 1.0)


def test_frames_at_the_config_size():
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), "spiral1_nerf.train")
    cam = cell.config_file["data"]["camera"]
    inp = data.make_inputs(cell.config_file["data"], cell.cfg, 9)
    assert inp["images"].shape == (len(cell.cfg["train_idxs"]), cam["H"], cam["W"], 1)
    assert inp["images"].dtype == np.float32
    assert 0.0 <= inp["images"].min() and inp["images"].max() <= 1.0
    val = data.make_inputs(cell.config_file["data"], cell.cfg, 9, "val")
    assert val["images"].shape[0] == len(cell.cfg["val_idxs"])
