"""Trainer.render_view over the configuration's val views in turn, each a
full frame; set-up renders one frame's worth of the two chunk shapes a
view uses.  A sample of each finished view's pixels, drawn from the seed,
is rendered again by the reference (reference/render.py)."""

import gc
import time

import numpy as np
import torch

from benchmark import common, data
from benchmark.reference import render as ref_render
from benchmark.reference.field import Field

LOWER = torch.float8_e4m3fn  # the control's MLP precision, the step below bf16
CONTROL_VIEWS = 3  # the views a run finishes in its window


class Driver(common.BaseDriver):
    def setup(self):
        run = self.run
        from enerf_torch.data.provider import FramesProvider

        self.inputs = inp = self.make_inputs(self.traffic["views"])
        cfg, self.trainer = self._trainer()
        t0 = run.clock()
        self.provider = FramesProvider(inp["images"], inp["poses"], inp["intrinsics"],
                                       num_rays=cfg.num_rays, device=run.device)
        run.spans["data_load"] = run.clock() - t0
        t0 = run.clock()
        self.views = self.provider.val_views()
        v = self.views[0]
        n = v["H"] * v["W"]
        B = min(int(cfg.max_ray_batch), n)
        # the two chunk shapes of a view: whole chunks and the remainder
        self.trainer.render_view(v["pose"], v["intrinsics"], 1, B + (n % B))
        run.spans["warmup"] = run.clock() - t0

    def window(self, seconds):
        run, tr = self.run, self.trainer
        self.outputs, el = [], 0.0
        t0 = run.clock()
        while not self.outputs or el + 0.5 * el / len(self.outputs) <= seconds:
            v = self.views[len(self.outputs) % len(self.views)]
            img, depth = tr.render_view(v["pose"], v["intrinsics"], v["H"], v["W"])
            self.outputs.append((len(self.outputs) % len(self.views), img, depth))
            el = time.time() - t0
        sizes = [(self.views[i]["H"], self.views[i]["W"]) for i, _, _ in self.outputs]
        run.window = {"seconds": el, "views": len(sizes), "view_sizes": sizes,
                      "rays": sum(H * W for H, W in sizes)}
        self.attempted = len(self.outputs)
        self.failed = sum(1 for _, img, depth in self.outputs
                          if not (np.isfinite(img).all() and np.isfinite(depth).all()))

    def release(self):
        self.grid_meta = self.trainer.static.grid_meta
        self.trainer = self.provider = None
        gc.collect()

    def encode_inputs(self):
        """Positions of the first render chunk of the first view."""
        v = self.views[0]
        B = min(int(self.cfg["max_ray_batch"]), v["H"] * v["W"])
        o, d = common.view_rays(v, self.run.device, np.arange(B))
        xyz = ref_render.sample_points(o, d, self.field.bound, self.cfg["num_steps"],
                                       self.cfg["min_near"])[0].reshape(-1, 3)
        return (xyz + self.field.bound) / (2.0 * self.field.bound), \
            self.weights["hash_table"], self.grid_meta

    def check(self):
        """The widest gaps of image and depth over a sample of each
        finished view's pixels."""
        rng = np.random.default_rng(data.seed_sequence(self.run.seed, 1))
        k = int(self.traffic["pixels_checked_per_view"])
        cfg, worst = self.cfg, {"image": 0.0, "depth": 0.0}
        with common.reference_precision(), torch.no_grad():
            for vi, img, depth in self.outputs:
                v = self.views[vi]
                n = v["H"] * v["W"]
                idx = rng.choice(n, size=min(k, n), replace=False)
                for s in range(0, len(idx), 1024):
                    o, d = common.view_rays(v, self.run.device, idx[s:s + 1024])
                    out = ref_render.render(self.field, self.weights, o, d, cfg["num_steps"],
                                            cfg["min_near"], cfg["density_scale"], 1.0)
                    pi = torch.as_tensor(img.reshape(n, -1)[idx[s:s + 1024]],
                                         device=self.run.device)
                    pd = torch.as_tensor(depth.reshape(n)[idx[s:s + 1024]],
                                         device=self.run.device)
                    worst["image"] = max(worst["image"],
                                         float((pi - out["image"]).abs().max()))
                    worst["depth"] = max(worst["depth"], float((pd - out["depth"]).abs().max()))
        return worst


def program_seconds(cell):
    """The lower readings come from whole runs at the cell's own length."""
    return cell.run_seconds


def control(cell, seed, device, views=CONTROL_VIEWS):
    """{control: widest image and depth gaps} of one seed over `views`
    views, the pixels a run samples: the reference in float8 MLPs against
    the sound reference."""
    cfg, traffic = cell.cfg, cell.traffic
    field, lower = Field(cfg, device), Field(cfg, device, precision=LOWER)
    weights = common.make_weights(field, float(traffic["table_scale"]), seed, device)
    inp = data.make_inputs(cell.config_file["data"], cfg, seed, traffic["views"], cell.root)
    rng = np.random.default_rng(data.seed_sequence(seed, 1))
    k = int(traffic["pixels_checked_per_view"])
    H, W = inp["images"].shape[1:3]
    worst = {"image": 0.0, "depth": 0.0}
    with common.reference_precision(), torch.no_grad():
        for vi in range(views):
            view = {"pose": inp["poses"][vi % len(inp["poses"])],
                    "intrinsics": inp["intrinsics"], "H": H, "W": W}
            idx = rng.choice(H * W, size=min(k, H * W), replace=False)
            for s in range(0, len(idx), 1024):
                o, d = common.view_rays(view, device, idx[s:s + 1024])
                args = (o, d, cfg["num_steps"], cfg["min_near"], cfg["density_scale"], 1.0)
                a = ref_render.render(field, weights, *args)
                b = ref_render.render(lower, weights, *args)
                worst["image"] = max(worst["image"], float((a["image"] - b["image"]).abs().max()))
                worst["depth"] = max(worst["depth"], float((a["depth"] - b["depth"]).abs().max()))
    return {"control": worst}
