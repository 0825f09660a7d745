"""The span registry (enerf_torch/utils/profiling.py): nested spans and
their parents, the process-wide stack across a thread, which spans mark
the card, counters under a capture replayed through `recording` /
`replayed`, the device ring's decode
across a wrap and the self time it gives, the spans of a training window,
a view, the trainer's epoch and mesh and the event provider's load, on the
CPU; on the card (`gpu`), a captured step's spans once per replay, with
no synchronize among the replays.

Card tests run with
`python -m pytest tests/test_torch_spans.py --noconftest -o addopts="" -q`."""

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.config import build_config
from enerf_torch.data import provider as tprov
from enerf_torch.data import synthetic
from enerf_torch.train.trainer import Trainer
from enerf_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def _event_cfg(tmp_path, *extra):
    # the hash grid and the fixed-step renderer, as the published configs
    return build_config([
        "--mode", "synthetic", "--H", "24", "--W", "24", "--syn_frames", "8",
        "--events", "1", "--event_only", "1", "--out_dim_color", "1", "--C_thres", "0.2",
        "--bound", "1", "--num_levels", "2", "--num_steps", "8", "--batch_size_evs", "32",
        "--max_ray_batch", "200", "--log_every", "1", "--outdir", str(tmp_path), *extra])


def _device_fields(spans):
    return {(p, k) for p, s in spans.items() for k in ("device_s", "device_self_s")
            if s[k] is not None}


def test_nested_spans_record_parents_and_host_time_and_a_thread_nests_in_the_process_stack():
    seen = {}

    def worker():
        with profiling.span("child.thread") as sp:
            seen["path"] = sp.path

    with profiling.span("outer") as outer:
        with profiling.span("inner") as inner:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            torch.ones(256).cumsum(0)
        with profiling.span("inner"):
            pass
    assert seen["path"] == "outer/inner/child.thread"
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert set(spans) == {"outer", "outer/inner", "outer/inner/child.thread"}
    assert [spans[p]["count"] for p in ("outer", "outer/inner", "outer/inner/child.thread")] \
        == [1, 2, 1]
    assert all(s["graphed"] == 0 for s in spans.values())
    assert outer.host_s >= inner.host_s > 0
    assert spans["outer"]["host_s"] == pytest.approx(outer.host_s)
    assert spans["outer"]["host_s"] >= spans["outer/inner"]["host_s"]
    # on the CPU no mark: no device number, and the clock has no device side
    assert not _device_fields(spans)
    assert snap["clock"]["device_ns"] is None and snap["clock"]["host_ns"] > 0
    assert snap["lost_marks"] == 0


def test_a_span_leaves_the_stack_when_its_block_raises():
    with pytest.raises(ValueError):
        with profiling.span("fails"):
            raise ValueError("x")
    with profiling.span("after") as sp:
        pass
    assert sp.path == "after"
    assert profiling.snapshot()["spans"]["fails"]["count"] == 1


@pytest.mark.parametrize("device,card", [(None, None), ("cpu", None), (torch.device("cpu"), None),
                                         ("cuda:0", 0), (torch.device("cuda", 1), 1)])
def test_a_span_marks_the_card_its_work_runs_on(device, card):
    """Marks follow the span's device, not whether the process uses CUDA."""
    assert profiling._card(device) == card


def test_counts_of_a_capture_are_set_back_and_added_once_a_replay():
    """What a capture adds to a kernel wrapper's `launches` and to the
    registry's counters goes to the Replay, kept apart, and comes back once
    a replay, through the one path train/chunk.py uses for both."""
    class Wrapper:
        launches = 5

    profiling.count("a.samples", 7)
    profiling.count("b.untouched", 1)
    with profiling.recording([Wrapper]) as replay:
        Wrapper.launches += 2
        profiling.count("a.samples", 100)
        profiling.count("c.rays", 3)
    # every wrapper's launches, none on the CPU included; the counters bumped
    assert replay.launches == {Wrapper: 2, profiling.span_mark: 0}
    assert replay.counters == {"a.samples": 100, "c.rays": 3}
    assert Wrapper.launches == 5
    assert profiling.snapshot()["counters"] == {"a.samples": 7, "b.untouched": 1}
    for _ in range(3):
        profiling.replayed(replay)
    assert Wrapper.launches == 11
    assert profiling.snapshot()["counters"] == {"a.samples": 307, "b.untouched": 1, "c.rays": 9}


def test_ring_decode_across_a_wrap_pairs_marks_and_gives_self_time():
    """A ring of 8 slots whose count of marks written (11) has wrapped: the
    marks 5-10 lie in slots 5, 6, 7, 0, 1, 2, and an enter read at an
    earlier drain pairs with an exit read now."""
    with profiling.span("parent") as parent, profiling.span("kid") as kid:
        pass
    p, k = parent.sid, kid.sid
    ring = profiling._Ring("cpu", slots=8)
    ring.read, ring.open = 5, {p: [1_000]}  # the parent's enter came before
    mem = np.full(2 * 8 + 1, -1, dtype=np.int64)
    marks = {5: (1_200, 2 * k), 6: (1_500, 2 * k + 1), 7: (1_600, 2 * k),
             8: (1_900, 2 * k + 1), 9: (2_000, 2 * profiling.CLOCK), 10: (2_500, 2 * p + 1)}
    for i, (t, tag) in marks.items():
        mem[2 * (i % 8)], mem[2 * (i % 8) + 1] = t, tag
    mem[16] = 11
    ended, clock, lost = ring.take(torch.from_numpy(mem))
    assert ended == [(k, 1_200, 1_500), (k, 1_600, 1_900), (p, 1_000, 2_500)]
    assert clock == 2_000 and lost == 0 and ring.read == 11 and ring.open == {p: [], k: []}
    profiling._record(ended)
    spans = profiling.snapshot()["spans"]
    assert spans["parent"]["device_s"] == pytest.approx(1.5e-6)
    assert spans["parent/kid"]["device_s"] == pytest.approx(0.6e-6)
    assert spans["parent"]["device_self_s"] == pytest.approx(0.9e-6)
    assert spans["parent/kid"]["device_self_s"] == pytest.approx(0.6e-6)
    # eager instances count on the host, not again from their marks
    assert spans["parent"]["count"] == 1 and spans["parent"]["graphed"] == 0
    # 3 more marks than the ring holds were written before the next read
    mem[16] = 11 + 8 + 3
    ended, clock, lost = ring.take(torch.from_numpy(mem))
    assert lost == 3 and ring.read == 22


@pytest.mark.parametrize("mode,renders", [("events", 2), ("frames", 1)])
def test_a_window_records_each_phase_once_a_step_and_the_encode_once_a_render(tmp_path, mode,
                                                                              renders):
    """An event step renders its pairs twice, a frames step its rays once."""
    extra = () if mode == "events" else ("--events", "0", "--event_only", "0",
                                         "--num_rays", "32")
    cfg = _event_cfg(tmp_path, *extra)
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    train, _ = tprov.make_providers(cfg, device="cpu")
    profiling.reset()
    K = 3
    chunk = tr._chunk(train, K, tr.state.step)
    tr.occupancy, aux = chunk(tr.state, tr.occupancy, train, tr.generator, tr.rank_generator)
    assert np.isfinite(float(aux["loss"]))
    snap = profiling.snapshot()
    spans = snap["spans"]
    counts = {p: s["count"] for p, s in spans.items()}
    assert counts == {"step": K, "step/step.batch": K, "step/step.forward": K,
                      "step/step.forward/encode.fwd": renders * K, "step/step.backward": K,
                      "step/step.backward/encode.bwd": renders * K, "step/step.optim": K}
    assert not _device_fields(spans)
    assert all(s["graphed"] == 0 and s["host_s"] > 0 for s in spans.values())
    step = spans["step"]["host_s"]
    assert sum(spans[f"step/step.{k}"]["host_s"]
               for k in ("batch", "forward", "backward", "optim")) <= step
    assert snap["counters"] == {}


def test_the_trainer_epoch_mesh_view_and_profile_spans(tmp_path):
    """epoch_seconds and mesh_seconds are the host seconds of the spans
    epoch.* and mesh.*; a view's spans and rays; --profile 1 writes the
    snapshot beside its trace and logs the phases' ms a step."""
    cfg = _event_cfg(tmp_path, "--fuse_steps", "2", "--profile", "1")
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    train, val = tprov.make_providers(cfg, device="cpu")
    train.steps_per_epoch = 4
    tr.train(train, None, max_epoch=1)
    # the trace of step 2-3: one window (steps 3-4) after the first
    files = glob.glob(os.path.join(tr.workspace, "profile", "spans_*.json"))
    assert len(files) == 1
    assert os.path.basename(files[0])[len("spans_"):] == \
        os.path.basename(tr.profile_path)[len("trace_"):]
    with open(files[0]) as f:
        traced = json.load(f)
    assert traced["spans"]["epoch.steps/step/step.forward"]["count"] == 2
    log = open(os.path.join(tr.workspace, "log.txt")).read()
    line = [x for x in log.splitlines() if x.startswith("[profile] host ms a step")]
    assert len(line) == 1 and all(f"{name} " in line[0] for name in profiling.PROFILED)

    # the totals since the trace began (its start resets them)
    spans = profiling.snapshot()["spans"]
    assert set(tr.epoch_seconds) == {"steps", "checkpoint"}
    for key, secs in tr.epoch_seconds.items():
        assert spans[f"epoch.{key}"]["host_s"] == pytest.approx(secs)
    assert spans["epoch.steps/step"]["count"] == 2

    profiling.reset()
    tr.save_mesh(resolution=8)
    spans = profiling.snapshot()["spans"]
    assert {k: spans[f"mesh.{k}"]["host_s"] for k in ("query", "extract", "write")} \
        == pytest.approx(tr.mesh_seconds)

    profiling.reset()
    v = val.val_views()[0] if hasattr(val, "val_views") else None
    pose = train.train_poses[0] if v is None else v["pose"]
    img, depth = tr.render_view(pose, train.intrinsics, 24, 24)
    snap = profiling.snapshot()
    counts = {p: s["count"] for p, s in snap["spans"].items()}
    assert counts == {"render.view": 1, "render.view/encode.fwd": 3}  # 3 chunks of 200 rays
    assert snap["counters"] == {"render.rays": 24 * 24}
    assert img.shape == (24, 24, 1) and np.isfinite(depth).all()


def test_event_provider_load_seconds_are_its_spans():
    data = synthetic.simulate_events(H=16, W=16, n_frames=6, C=0.2)
    prov = tprov.EventProvider(data["events"], data["frame_ts"], data["poses"],
                               data["intrinsics"], 16, 16, batch_size_evs=32, device="cpu")
    spans = profiling.snapshot()["spans"]
    assert set(prov.load_seconds) == {"chains", "poses"}
    assert prov.load_seconds["chains"] == pytest.approx(spans["provider.chains"]["host_s"])
    assert prov.load_seconds["poses"] == pytest.approx(spans["provider.poses"]["host_s"])


@pytest.mark.gpu
def test_a_captured_step_records_its_spans_once_a_replay_without_a_sync(tmp_path,
                                                                         monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _event_cfg(tmp_path)
    tr = Trainer(cfg, device="cuda", workspace=str(tmp_path / "ws"))
    train, _ = tprov.make_providers(cfg, device="cuda")
    chunk = tr._chunk(train, 4, tr.state.step)
    args = (train, tr.generator, tr.rank_generator)
    tr.occupancy, _ = chunk(tr.state, tr.occupancy, *args, steps=1)  # warm-up + capture
    assert chunk.graph is not None
    assert chunk.per_replay.launches[profiling.span_mark] == 2 * 9  # 9 spans in the step
    assert chunk.per_replay.counters == {}
    profiling.reset()
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a) or real(*a))
    K = 5
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.occupancy, aux = chunk(tr.state, tr.occupancy, *args, steps=K, update=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert syncs == []
    snap = profiling.snapshot()
    spans = snap["spans"]
    graphed = {p: s["graphed"] for p, s in spans.items()}
    assert graphed == {"step": K, "step/step.batch": K, "step/step.forward": K,
                       "step/step.forward/encode.fwd": 2 * K, "step/step.backward": K,
                       "step/step.backward/encode.bwd": 2 * K, "step/step.optim": K}
    assert all(s["count"] == s["graphed"] and s["device_s"] > 0 for s in spans.values())
    phases = sum(spans[f"step/step.{k}"]["device_s"]
                 for k in ("batch", "forward", "backward", "optim"))
    assert phases <= spans["step"]["device_s"]
    assert spans["step"]["device_self_s"] == pytest.approx(spans["step"]["device_s"] - phases)
    assert snap["counters"] == {}
    assert snap["clock"]["device_ns"] > 0 and snap["lost_marks"] == 0
    assert np.isfinite(float(aux["loss"]))


@pytest.mark.gpu
def test_a_cpu_window_in_a_process_on_the_card_has_no_device_time(tmp_path):
    """The marks follow where a span's work runs: a CPU trainer's window
    after CUDA is initialised reads host seconds only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.init()
    torch.ones(1, device="cuda").sum().item()
    cfg = _event_cfg(tmp_path)
    tr = Trainer(cfg, device="cpu", workspace=str(tmp_path / "ws"))
    train, _ = tprov.make_providers(cfg, device="cpu")
    profiling.reset()
    chunk = tr._chunk(train, 2, tr.state.step)
    tr.occupancy, _ = chunk(tr.state, tr.occupancy, train, tr.generator, tr.rank_generator)
    spans = profiling.snapshot()["spans"]
    assert spans["step"]["count"] == 2 and spans["step/step.forward/encode.fwd"]["count"] == 4
    assert not _device_fields(spans)
    ms, clock = profiling.per_step_ms(profiling.snapshot(), 2)
    assert clock == "host" and set(ms) == set(profiling.PROFILED)
