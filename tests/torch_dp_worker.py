"""The port's side of tests/test_torch_parallel.py: two gloo ranks on the CPU.

    python tests/torch_dp_worker.py INPUTS.npz OUT_DIR

starts two ranks with enerf_torch.parallel.mesh.spawn; each reads the
inputs the test wrote with the JAX package (weights, global batches, the
JAX draws as noise, JAX's march samples, occupancy jitter) and writes
OUT_DIR/rank<r>.npz:
  - for each step case: the params, EMA and reduced gradients after one
    data-parallel step, its global scalars (and per_ray_loss and error map
    in frames mode); rank 0 also the single-process step on the global
    batch; for `events_norm` also the step with each rank's loss normalized
    over its own shard (what the global norm must not be);
  - the sharded eval render of 131 rays;
  - the sharded occupancy update: its full phase with JAX's jitter, then a
    resampling update.
This module imports no JAX (tests/test_torch_parallel.py imports its case
table).
"""

import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LR, ITERS = 5e-3, 1000
N_EVENTS, N_FRAMES = 64, 64  # global batch rows (32 per rank)

# field: extra FieldStatic kwargs, "hashgrid64" for the hash grid whose finest
# level has 64 cells (JAX's FMA-contracted positions move an ulp, which at
# 2048 cells moves the trilinear weights visibly: tests/test_torch_frames.py)
COMMON = dict(min_near=0.2, density_scale=1.0, event_only=True, use_luma=False,
              linlog=True, out_dim_color=1)
CASES = {
    "events_c02": dict(field="hashgrid64", mode="events",
                       step=dict(C_thres=0.2, num_steps=32, w_opacity=0.01)),
    "events_norm": dict(field="hashgrid64", mode="events",
                        step=dict(C_thres=-1.0, num_steps=32, w_opacity=0.01)),
    "frames": dict(field="hashgrid64", mode="frames",
                   step=dict(C_thres=0.2, num_steps=32, event_only=False, linlog=False)),
    "march": dict(field="blockgrid", mode="events",
                  step=dict(C_thres=0.2, use_march=True, march_samples=32, max_steps=1024,
                            dt_gamma=0.0, compact_frac=0.5, w_opacity=0.01,
                            w_distortion=0.01)),
}
FIELD_KW = {
    "hashgrid64": dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=13,
                       encoding="hashgrid"),
    "blockgrid": dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
                      encoding="blockgrid", use_fused_head=True, density_bias=3.0),
}
HASHGRID64 = dict(num_levels=4, level_dim=2, log2_hashmap_size=13, desired_resolution=64)
RENDER_FIELD = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10,
                    encoding="blockgrid")
OCC_FIELD = dict(bound=1.0, out_dim_color=1, num_levels=4, log2_hashmap_size=10)


def field_static(name):
    """The port's FieldStatic of a case's field."""
    from enerf_torch.models.field import FieldStatic
    from enerf_torch.ops.hashgrid import HashGridMeta
    st = FieldStatic(**FIELD_KW[name])
    if name == "hashgrid64":
        st.grid_meta = HashGridMeta(**HASHGRID64)
    return st


def step_statics(case):
    from enerf_torch.train.step import StepStatics
    c = CASES[case]
    return StepStatics(field_static=field_static(c["field"]), **{**COMMON, **c["step"]})


def _case(data, case, part):
    pre = f"{case}/{part}/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in data.items() if k.startswith(pre)}


class JaxMarch:
    """march_rays replaced by JAX's samples of the step's two renders (in
    call order), the rows of `rows`: the packages then composite the same
    samples (JAX's jit may contract o + t * d into an FMA, which can flip a
    block-grid floor(): tests/test_torch_train.py)."""

    def __init__(self, samples):
        self.samples, self.calls, self.rows = samples, 0, slice(None)

    def __call__(self, *args, **kw):
        ts, dts, valid = self.samples[self.calls % 2]
        self.calls += 1
        return ts[self.rows], dts[self.rows], valid[self.rows]


def run_step_case(mesh, data, case, out, monkeypatch):
    from enerf_torch.data.provider import FramesProvider
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.render import march as tmarch
    from enerf_torch.render.occupancy import pack_bitfield
    from enerf_torch.train import losses, state as tstate, step as tstep
    from torch_march_parity import per_render

    c = CASES[case]
    ss = step_statics(case)
    params = _case(data, case, "param")
    batch, noise = _case(data, case, "batch"), _case(data, case, "noise")
    occ = data.get(f"{case}/occ")
    occ = None if occ is None else pack_bitfield(torch.from_numpy(occ))
    if c["field"] == "blockgrid":
        samples = [tuple(torch.from_numpy(data[f"{case}/march{i}/{k}"])
                         for k in ("ts", "dts", "valid")) for i in (1, 2)]
        march = JaxMarch(samples)
        monkeypatch(tmarch, "march_rays", march)
        monkeypatch(tstep, "march_rays", march)
        monkeypatch(tstep, "march_rays_pair", per_render(march))
        n = N_EVENTS // mesh.world_size
        march.rows = slice(mesh.rank * n, (mesh.rank + 1) * n)

    def dp_step():
        state = tstate.TrainState(params, LR, ITERS)
        sc = dp.make_sharded_train_step(ss, mesh, c["mode"])(
            state, dp.shard_batch(batch, mesh), occ, noise=noise)
        return state, sc

    state, sc = dp_step()
    for k, p in state.params.items():
        out[f"{case}/param/{k}"] = p.detach().numpy()
        out[f"{case}/grad/{k}"] = p.grad.numpy()
        out[f"{case}/ema/{k}"] = state.ema_params[k].numpy()
    for k, v in sc.items():
        out[f"{case}/scalar/{k}"] = v.numpy()
    if c["mode"] == "frames":
        # the error map fed every rank's cells and losses in rank order
        n = N_FRAMES // mesh.world_size
        prov = FramesProvider(np.zeros((2, 8, 8, 1), np.float32), np.tile(np.eye(4), (2, 1, 1)),
                              (8.0, 8.0, 4.0, 4.0), num_rays=n, error_map=True)
        prov.error_map = torch.from_numpy(data["frames/errmap/map"].copy())
        prov._last_fi = torch.from_numpy(data["frames/errmap/fi"][mesh.rank:mesh.rank + 1])
        prov._last_inds_coarse = torch.from_numpy(
            data["frames/errmap/cells"][mesh.rank * n:(mesh.rank + 1) * n])
        cells = [dp.gather_rows(x, mesh.group) for x in prov.error_map_cells()]
        prov.update_error_map(sc["per_ray_loss"], cells)
        out["frames/errmap/after"] = prov.error_map.numpy()
    if case == "events_norm":
        # each rank's loss normalized over its own shard only
        real = losses.event_loss
        monkeypatch(losses, "event_loss",
                    lambda *a, group=None, **kw: real(*a, **kw))
        state, sc = dp_step()
        monkeypatch(losses, "event_loss", real)
        out["events_norm/per_rank/loss"] = sc["loss"].numpy()
        for k, p in state.params.items():
            out[f"events_norm/per_rank/param/{k}"] = p.detach().numpy()
    if mesh.rank == 0:
        if c["field"] == "blockgrid":
            march.rows = slice(None)
        state = tstate.TrainState(params, LR, ITERS)
        fn = tstep.train_step_events if c["mode"] == "events" else tstep.train_step_frames
        sc = fn(state, batch, ss, occ, noise=noise)
        out[f"{case}/single/loss"] = sc["loss"].numpy()
        for k, p in state.params.items():
            out[f"{case}/single/param/{k}"] = p.detach().numpy()


def run_render(mesh, data, out):
    from enerf_torch.models.field import FieldStatic
    from enerf_torch.parallel import mesh as dp
    from enerf_torch.render.march import render_rays_march
    from enerf_torch.render.occupancy import pack_bitfield

    st = FieldStatic(**RENDER_FIELD)
    params = _case(data, "render", "param")
    occ = pack_bitfield(torch.from_numpy(data["render/occ"]))
    o, d = torch.from_numpy(data["render/rays_o"]), torch.from_numpy(data["render/rays_d"])
    sharded = dp.make_sharded_render(st, mesh, num_samples=32, max_steps=256)(params, occ, o, d)
    for k, v in sharded.items():
        out[f"render/sharded/{k}"] = v.numpy()
    if mesh.rank == 0:
        single = render_rays_march(params, st, occ, o, d, num_samples=32, max_steps=256,
                                   bg_color=1.0, min_near=0.2)
        for k, v in single.items():
            out[f"render/single/{k}"] = v.numpy()


def run_occupancy(mesh, data, out):
    from enerf_torch.models.field import FieldStatic
    from enerf_torch.render import occupancy as tocc

    st = FieldStatic(**OCC_FIELD)
    params = _case(data, "occ", "param")
    occ = tocc.update_occupancy_sharded(params, st, tocc.init_occupancy(1.0), mesh=mesh,
                                        noise=torch.from_numpy(data["occ/noise"]))
    # copies: the next update writes the same tensors in place
    out["occ/full/density_grid"] = occ.density_grid.numpy().copy()
    out["occ/full/occ_bitfield"] = occ.occ_bitfield.numpy().copy()
    out["occ/full/mean_density"] = occ.mean_density.numpy().copy()
    out["occ/full/iter_density"] = np.asarray(occ.iter_density)
    # the resampling phase: each rank's own draws, one merge
    rank_gen = torch.Generator().manual_seed(100 + mesh.rank)
    occ = tocc.update_occupancy_sharded(params, st, occ._replace(iter_density=20),
                                        rank_generator=rank_gen, mesh=mesh)
    out["occ/partial/density_grid"] = occ.density_grid.numpy().copy()
    out["occ/partial/iter_density"] = np.asarray(occ.iter_density)


def rank_main(mesh, inputs, out_dir):
    torch.set_num_threads(1)
    data = dict(np.load(inputs))
    out, patched = {}, []

    def monkeypatch(mod, name, value):
        patched.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    for case in CASES:
        run_step_case(mesh, data, case, out, monkeypatch)
        for mod, name, value in reversed(patched):
            setattr(mod, name, value)
        patched.clear()
    run_render(mesh, data, out)
    run_occupancy(mesh, data, out)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)


if __name__ == "__main__":
    from enerf_torch.parallel import mesh as dp
    dp.spawn(rank_main, ["cpu", "cpu"], args=tuple(sys.argv[1:3]),
             timeout=datetime.timedelta(seconds=120))
