"""The trainer's training window.

Set-up builds the trainer from the configuration, as the command line
does, hands it the benchmark's weights, builds the train provider from the
generated inputs, and runs the first `check_steps` steps through the
window's own call one at a time (the first also captures the step's CUDA
graph); the window then runs 16-step windows while a whole one fits into
the seconds left, and single steps to the end, as Trainer.train runs an
epoch's remainder.  The reference (reference/train.py) follows the same
first steps from the same weights, inputs and draws.

Event cells train E-NeRF's event-only loss; a configuration with the frame
term beside the events needs a driver and a reference of its own.
"""

import gc
import statistics

import torch

from benchmark import common, data
from benchmark.reference import render as ref_render
from benchmark.reference import train as ref_train
from benchmark.reference.field import Field

LOWER = torch.float8_e4m3fn  # the control's MLP precision, the step below bf16


class Driver(common.BaseDriver):
    def setup(self):
        run = self.run
        from enerf_torch.data.provider import EventProvider, FramesProvider

        self.inputs = inp = self.make_inputs()
        cfg, self.trainer = self._trainer()
        t0 = run.clock()
        if cfg.events:
            if not cfg.event_only:
                raise NotImplementedError(
                    "events with the frame term: add a driver and a reference for it")
            self.provider = EventProvider(
                inp["events"], inp["hf_ts"], inp["hf_poses"], inp["intrinsics"], inp["H_ev"],
                inp["W_ev"], batch_size_evs=cfg.batch_size_evs,
                accumulate_evs=bool(cfg.accumulate_evs), acc_max_num_evs=cfg.acc_max_num_evs,
                precompute_evs_poses=bool(cfg.precompute_evs_poses),
                negative_event_sampling=bool(cfg.negative_event_sampling), frames=None,
                frame_poses=None, num_rays=cfg.num_rays, device=run.device,
                event_frame_ids=inp["event_frame_ids"], n_frames=inp["n_frames"],
                intrinsics_evs=inp["intrinsics_evs"])
            run.spans["data_load"] = run.clock() - t0
            run.spans["pose_precompute"] = self.provider.load_seconds["poses"]
        else:
            self.provider = FramesProvider(
                inp["images"], inp["poses"], inp["intrinsics"], num_rays=cfg.num_rays,
                error_map=bool(cfg.error_map), rand_pose=cfg.rand_pose, rand_radius=cfg.radius,
                rand_pose_rays=cfg.num_rays, device=run.device)
            run.spans["data_load"] = run.clock() - t0
        tr = self.trainer
        self.chunk = tr._chunk(self.provider, cfg.fuse_steps, tr.state.step)
        losses, replays = [], []
        for i in range(int(self.traffic["check_steps"])):
            t0 = run.clock()
            aux = self._call(1)
            losses.append(float(aux["loss"]))
            if i == 0:
                run.spans["capture"] = run.clock() - t0
                grad = {k: float(torch.linalg.vector_norm(m / 0.1))
                        for k, m in tr.state.exp_avg.items()}
            else:
                replays.append(run.clock() - t0)
        run.spans["replays"] = sum(replays)
        change = {}
        for k, w in self.weights.items():
            change[k] = float(torch.linalg.vector_norm(tr.state.params[k].detach() - w))
            change["ema." + k] = float(torch.linalg.vector_norm(tr.state.ema_params[k] - w))
        self.program = {"loss": losses, "grad": grad, "change": change}
        self.step_est = statistics.mean(replays) if replays else run.spans["capture"]

    def _call(self, steps):
        tr = self.trainer
        tr.occupancy, aux = self.chunk(tr.state, tr.occupancy, self.provider, tr.generator,
                                       tr.rank_generator, steps=steps,
                                       update=tr.state.step % 16 == 0)
        return aux

    def window(self, seconds):
        run, K = self.run, self.chunk.chunk_len
        losses, steps, el = [], 0, 0.0
        t0 = run.clock()
        while True:
            est = el / steps if steps else self.step_est
            if el + K * est <= seconds:
                n = K
            elif el + 0.5 * est <= seconds or steps == 0:
                n = 1
            else:
                break
            losses.append((n, self._call(n)["loss"]))
            steps += n
            el = run.clock() - t0
        run.window = {"seconds": el, "steps": steps}
        self.attempted = steps
        self.failed = sum(n for n, loss in losses if not torch.isfinite(loss))

    def release(self):
        self.trainer._release_windows()
        self.grid_meta = self.trainer.static.grid_meta
        self.trainer = self.chunk = self.provider = None
        gc.collect()

    def encode_inputs(self):
        """Positions of one render of the first step's batch (its event
        pair's first render, or its frame rays), the weights' table and
        the program's grid constants."""
        f = ref_train.Follower(self.cfg, self.weights, self.inputs, self.run.seed,
                               self.run.device)
        b, _ = f.draw()
        o, d, j = (b["o1"], b["d1"], b["jitter1"]) if "o1" in b else (b["o"], b["d"], b["jitter"])
        xyz = ref_render.sample_points(o, d, self.field.bound, self.cfg["num_steps"],
                                       self.cfg["min_near"], j)[0].reshape(-1, 3)
        x01 = (xyz + self.field.bound) / (2.0 * self.field.bound)
        return x01, self.weights["hash_table"], self.grid_meta

    def check(self):
        steps = len(self.program["loss"])
        follower = ref_train.Follower(self.cfg, self.weights, self.inputs, self.run.seed,
                                      self.run.device)
        with common.reference_precision():
            ref = ref_train.readings(follower, self.weights, steps)
        self.readings = {"program": self.program, "reference": ref}
        return common.compare_steps(self.program, ref)


def program_seconds(cell):
    """The lower readings come from set-up's steps: no window."""
    return 0


def control(cell, seed, device):
    """{control: numbers, half_batch: numbers, loss_steps: each one's loss
    gap at every step} of one seed: the reference in float8 MLPs, and with
    half of each batch left out, each compared with the sound reference as
    a run compares the program."""
    cfg, traffic = cell.cfg, cell.traffic
    weights = common.make_weights(Field(cfg, device), float(traffic["table_scale"]), seed,
                                  device)
    inputs = data.make_inputs(cell.config_file["data"], cfg, seed, "train", cell.root)
    steps = int(traffic["check_steps"])
    out = {"loss_steps": {}}
    with common.reference_precision():
        sound = ref_train.readings(
            ref_train.Follower(cfg, weights, inputs, seed, device), weights, steps)
        for name, kw in (("control", {"precision": LOWER}),
                         ("half_batch", {"fault": "half_batch"})):
            other = ref_train.readings(
                ref_train.Follower(cfg, weights, inputs, seed, device, **kw), weights, steps)
            out[name] = common.compare_steps(other, sound)
            out["loss_steps"][name] = [common.gap(a, b, 0.0)
                                       for a, b in zip(other["loss"], sound["loss"])]
    return out
