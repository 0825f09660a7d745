"""What the drivers (drivers/<name>.py) share: the weights from the seed,
the program's config and trainer as its command line builds them, the
training comparison, a view's rays and the reference's precision.

A driver module defines `Driver`, a class that takes the run and has
`setup()`, `window(seconds)`, `release()`, `check()` (the numbers compared,
by name) and, for the hash-grid probe, `encode_inputs()`; and two module
functions for benchmark/control.py: `control(cell, seed, device)`, the
upper readings, and `program_seconds(cell)`, the window a run of the
program needs for its lower readings.
"""

import statistics

import numpy as np
import torch

from benchmark import data
from benchmark.reference.batch import pixel_dirs
from benchmark.reference.field import Field


def make_weights(field, scale, seed, device):
    """The field's weights from the seed, in a few large calls on the
    device: the table U(-scale, scale) (the published init at 1e-4), each
    MLP matrix U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch.nn.Linear's)."""
    shapes = field.shapes()
    gen = torch.Generator(device=device).manual_seed(
        int(data.seed_sequence(seed, 2).generate_state(1, np.uint64)[0]) >> 1)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.rand(sum(sizes), device=device, generator=gen) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        bound = scale if name == "hash_table" else 1.0 / np.sqrt(shape[0])
        out[name] = (flat[at:at + n] * bound).reshape(shape).contiguous()
        at += n
    return out


def port_config(run):
    """The port's Config, parsed from the configuration's published keys as
    `python -m enerf_torch --config` parses a config file, with the run's
    seed and workspace; the defaults the run relies on are checked."""
    from enerf_torch.config import build_config

    lines = []
    for k, v in run.cell.config_file["config"].items():
        lines.append(f"{k} = {v}")
    path = f"{run.workdir}/config.txt"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    cfg = build_config(["--config", path, "--seed", str(run.seed), "--outdir", run.workdir])
    for k, v in run.cell.config_file["defaults"].items():
        if getattr(cfg, k) != v:
            raise ValueError(f"the program's default {k} = {getattr(cfg, k)!r}; the "
                             f"benchmark's configuration states {v!r}")
    return cfg


def install(trainer, weights):
    """Copy the benchmark's weights into the trainer's parameters and EMA
    shadow, in place (the captured step reads them at fixed addresses)."""
    params = trainer.state.params
    if {k: tuple(v.shape) for k, v in params.items()} != {k: tuple(v.shape)
                                                           for k, v in weights.items()}:
        raise ValueError("the program's parameters do not have the reference's shapes: "
                         f"{[(k, tuple(v.shape)) for k, v in params.items()]}")
    with torch.no_grad():
        for k, w in weights.items():
            params[k].copy_(w)
            trainer.state.ema_params[k].copy_(w)


def gap(program, reference, floor):
    return abs(program - reference) / max(abs(reference), floor)


def compare_steps(prog, ref):
    """The training comparison: the first step's loss gap (relative; the
    later steps' losses follow Adam's first update, which moves every entry
    by the learning rate times the sign of its gradient, so rounding that
    flips the sign of a gradient near zero swings them: run's readings
    only), and, by the worst leaf, the gap between the norms of the first
    gradient and of the change after the steps, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out (their change is round-off)."""
    loss = gap(prog["loss"][0], ref["loss"][0], 0.0)
    g = ref["grad"]
    med = statistics.median(g.values())
    leaves = [k for k in g if g[k] >= 1e-3 * med]
    grad = max(gap(prog["grad"][k], g[k], med) for k in leaves)
    keys = [k for k in ref["change"] if k.split(".")[-1] in leaves]
    cmed = statistics.median(ref["change"][k] for k in keys)
    change = max(gap(prog["change"][k], ref["change"][k], cmed) for k in keys)
    return {"loss": loss, "grad": grad, "change": change}


def view_rays(view, device, idx):
    """Rays of the flat pixel indices `idx` of a view (row-major)."""
    pose = torch.as_tensor(np.asarray(view["pose"]), dtype=torch.float32, device=device)
    idx = torch.as_tensor(idx, device=device)
    i = (idx % view["W"]).float()
    j = torch.div(idx, view["W"], rounding_mode="floor").float()
    d = pixel_dirs(i, j, view["intrinsics"]) @ pose[:3, :3].T
    return pose[:3, 3].expand_as(d), d


class BaseDriver:
    """The weights from the seed and the program's trainer; each step of
    set-up is a span of the run (its `run` line on standard error)."""

    def __init__(self, run):
        self.run, self.cfg, self.traffic = run, run.cfg, run.cell.traffic
        self.attempted = self.failed = 0
        self.readings = {}  # what the check compared, for the run's log line
        t0 = run.clock()
        self.field = Field(self.cfg, run.device)
        self.weights = make_weights(self.field, float(self.traffic["table_scale"]), run.seed,
                                    run.device)
        run.spans["weights"] = run.clock() - t0

    def make_inputs(self, split="train"):
        run = self.run
        t0 = run.clock()
        inputs = data.make_inputs(run.cell.config_file["data"], self.cfg, run.seed, split,
                                  run.cell.root)
        run.spans["data_make"] = run.clock() - t0
        return inputs

    def _trainer(self):
        from enerf_torch.train.trainer import Trainer

        t0 = self.run.clock()
        cfg = port_config(self.run)
        trainer = Trainer(cfg, device=self.run.device, workspace=f"{self.run.workdir}/ws")
        install(trainer, self.weights)
        self.run.spans["trainer"] = self.run.clock() - t0
        return cfg, trainer


class reference_precision:
    """float32 matrix products without TF32 while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


