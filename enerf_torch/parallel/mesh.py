"""Data-parallel mesh: the sharded train step, the sharded eval render, and
the launcher that starts one process per rank.

Counterpart of enerf_tpu/parallel/mesh.py.  The JAX package jits its step
over a 1-D ('data',) mesh: batches sharded on axis 0, params, Adam and EMA
replicated, and XLA inserts one gradient psum.  Here each rank is a process
with its own device, holding a full copy of the state and its shard of the
batch:

  - `make_mesh`: the rank's view of the job (process group, rank, world
    size, device, backend);
  - `make_sharded_train_step`: the rank's forward on its shard (the
    normalized event loss takes its norm over the *global* batch through an
    autograd-aware all_reduce, train/losses.py), the backward, one flat
    all_reduce of every gradient divided by the world size (the psum of the
    global mean), then Adam + EMA on every rank, which stay bitwise
    replicated because every rank applies the same reduced gradient;
  - `make_window_step` and `merge_error_map`: the data-parallel step of a
    training window (train/chunk.py, JAX's chunk under shard_map): each
    rank samples the config's whole batch and normalizes its loss over it
    alone, the gradient is the ranks' mean, and the error map's per-rank
    updates merge once, at the window's end;
  - `make_sharded_render`: the eval rays split over the ranks, rendered
    with `render_rays_march`, gathered and cropped (`shard_rays`);
  - `spawn`: len(devices) processes of this host joined through a file://
    rendezvous (the CLI's --mesh_shape N; torchrun starts --multihost jobs).

Backends (`choose_backend`): NCCL when every rank has a card of its own;
gloo for CPU ranks, or for ranks placed on one card explicitly, which NCCL
refuses ("Duplicate GPU detected").  Every collective is an all_reduce or
a broadcast, which both backends take on CUDA tensors.

Random draws: the caller keeps two generators.  A shared one, seeded alike
on every rank, draws what must be the same everywhere (the occupancy
update's full phase, the step's noise, drawn for the global batch and
sliced per rank as XLA partitions JAX's draw); a per-rank one draws the
batch and the occupancy resampling.
"""

import os
import tempfile
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from enerf_torch.backend import resolve_device
from enerf_torch.parallel import multihost
from enerf_torch.parallel.multihost import gather_rows
from enerf_torch.render.march import render_rays_march
from enerf_torch.train.step import event_loss_fn, frames_loss_fn, step_noise

# noise keys shared by every ray of the batch (not sliced per rank)
SHARED_NOISE = ("bg", "bg_no_ev")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel job."""
    group: Any            # the process group (the default group: dist.group.WORLD)
    rank: int
    world_size: int
    device: torch.device
    backend: str


def choose_backend(devices):
    """'nccl' when every rank has a card of its own, else 'gloo'."""
    devices = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devices)
                 and len({d.index for d in devices}) == len(devices))
    return "nccl" if own_cards else "gloo"


def make_mesh(devices=None):
    """This process's mesh over the default process group (initialize()
    first), as wide as its world.  `devices`: every rank's device, in rank
    order (ranks may share a card under gloo); without it the rank takes
    cuda:LOCAL_RANK under NCCL and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call multihost.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = resolve_device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
    elif backend == "nccl":
        device = resolve_device(None, local_rank=multihost.local_rank())
    else:
        device = torch.device("cpu")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a card per rank; rank {rank} is on {device}")
    return Mesh(group=dist.group.WORLD, rank=rank, world_size=world, device=device,
                backend=backend)


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (every [N, ...] tensor; N must
    divide by the world size)."""
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v):
            out[k] = v
            continue
        if v.shape[0] % mesh.world_size:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over {mesh.world_size} ranks")
        n = v.shape[0] // mesh.world_size
        out[k] = v[mesh.rank * n:(mesh.rank + 1) * n]
    return out


def replicated_tensors(state, occupancy=None):
    """Every tensor the ranks keep replicated, by name, in one order: params,
    EMA, Adam's moments and the update count, the occupancy grid (and its
    packed words)."""
    out = {"count": state.count}
    for k, p in state.params.items():
        out[f"params/{k}"] = p.data
        out[f"ema/{k}"] = state.ema_params[k]
        out[f"adam/exp_avg/{k}"] = state.exp_avg[k]
        out[f"adam/exp_avg_sq/{k}"] = state.exp_avg_sq[k]
    if occupancy is not None:
        out["occupancy/density_grid"] = occupancy.density_grid
        out["occupancy/occ_bitfield"] = occupancy.occ_bitfield
        out["occupancy/mean_density"] = occupancy.mean_density
        out["occupancy/occ_packed"] = occupancy.occ_packed
    return out


def replicate(state, occupancy, mesh):
    """Make rank 0's state and occupancy every rank's (broadcast + check)."""
    multihost.replicate_from_host(replicated_tensors(state, occupancy), mesh.group)


def assert_replicated(state, occupancy, mesh):
    """Raise on every rank unless the ranks hold bit-equal state."""
    multihost.assert_replicated(replicated_tensors(state, occupancy), mesh.group)


def shard_noise(noise, mesh):
    """This rank's slice of the global noise (per-ray draws split along axis
    0; the pair's shared backgrounds whole)."""
    out = {}
    for k, v in noise.items():
        if k in SHARED_NOISE:
            out[k] = v
        else:
            n = v.shape[0] // mesh.world_size
            out[k] = v[mesh.rank * n:(mesh.rank + 1) * n]
    return out


def all_reduce_grads(params, mesh):
    """Every .grad summed over the ranks in one flat all_reduce, then divided
    by the world size (the psum of the global mean), written back."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def global_means(scalars, mesh):
    """{name: 0-dim tensor} of this rank -> their means over the ranks (one
    all_reduce); over equal shards the mean of the ranks' means is the
    global batch's mean."""
    names = list(scalars)
    vals = torch.stack([scalars[k].detach().float() for k in names])
    dist.all_reduce(vals, group=mesh.group)
    vals.div_(mesh.world_size)
    return dict(zip(names, vals.unbind()))


def make_sharded_train_step(ss, mesh, mode="events"):
    """The data-parallel step: step(state, batch, occ=None, noise=None,
    generator=None) -> scalars, with `batch` this rank's shard.  `noise` is
    the *global* batch's noise (step_noise(..., scale=world size)), drawn from
    the shared `generator` when not given; the step takes this rank's slice.
    Returns the global means of the loss terms (implC_* dropped, as in the
    JAX package: a median over the global batch would need a global sort)
    and, in frames mode, the global per_ray_loss [N_global] in rank order."""
    if mode not in ("events", "frames"):
        raise ValueError(f"mode {mode!r}")
    def step(state, batch, occ=None, noise=None, generator=None):
        if noise is None:
            if generator is None:  # the global RNG is not alike on every rank
                raise ValueError("the data-parallel step draws its noise from the shared "
                                 "generator: pass `generator` (or `noise`)")
            noise = step_noise(ss, batch, generator, mode, scale=mesh.world_size)
        noise = shard_noise(noise, mesh)
        state.zero_grad()
        if mode == "events":
            loss, aux = event_loss_fn(state.params, ss, batch, noise, occ, group=mesh.group)
        else:
            loss, aux = frames_loss_fn(state.params, ss, batch, noise, occ)
        loss.backward()
        all_reduce_grads(state.params.values(), mesh)
        state.apply_updates()
        scalars = {"loss": loss}  # event_loss_fn leaves implC_* out under a group
        scalars.update((k, v) for k, v in aux.items() if v.ndim == 0)
        out = global_means(scalars, mesh)
        if mode == "frames":
            out["per_ray_loss"] = gather_rows(aux["per_ray_loss"].detach(), mesh.group)
        return out

    return step


def make_window_step(ss, mesh, mode="events"):
    """The data-parallel step inside a training window (enerf_tpu's
    make_train_chunk under shard_map): step(state, batch, occ, generator,
    noise=None) -> this rank's loss terms, with `batch` this rank's own
    batch at the config's full size and its noise drawn from `generator`,
    the rank's own (JAX folds the rank into the step's key).  Each rank's loss is
    normalized over its own batch (no global norm: JAX's chunk normalizes
    per chip); the gradients are mean-all_reduced, then Adam + EMA."""
    if mode not in ("events", "frames"):
        raise ValueError(f"mode {mode!r}")
    loss_fn = event_loss_fn if mode == "events" else frames_loss_fn

    def step(state, batch, occ, generator, noise=None):
        if noise is None:
            noise = step_noise(ss, batch, generator, mode)
        state.zero_grad()
        loss, aux = loss_fn(state.params, ss, batch, noise, occ)
        loss.backward()
        all_reduce_grads(state.params.values(), mesh)
        state.apply_updates()
        out = {"loss": loss.detach()}
        out.update((k, v.detach()) for k, v in aux.items())
        return out

    return step


@torch.no_grad()
def merge_error_map(base, error_map, mesh):
    """The error map after a data-parallel window, in place on `error_map`:
    base + the sum of every rank's delta from `base`, floored at 1e-4 (two
    ranks' negative deltas on one cell can overshoot below zero, and the
    next window samples the map log-categorically; JAX's chunk.py:138-146)."""
    delta = error_map - base
    dist.all_reduce(delta, group=mesh.group)
    torch.clamp(base + delta, min=1e-4, out=error_map)
    return error_map


@torch.no_grad()
def shard_rays(render, mesh, rays_o, rays_d):
    """render(rays_o, rays_d) -> dict of [n, ...] over the ranks: the rays
    padded to a multiple of the world size (with ones, as the JAX package
    pads), this rank's slice rendered, every output gathered and cropped."""
    N = rays_o.shape[0]
    pad = (-N) % mesh.world_size
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_ones(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d.new_ones(pad, 3)])
    n = (N + pad) // mesh.world_size
    part = slice(mesh.rank * n, (mesh.rank + 1) * n)
    out = render(rays_o[part], rays_d[part])
    return {k: gather_rows(v, mesh.group)[:N] for k, v in out.items()}


def make_sharded_render(static, mesh, *, num_samples=128, max_steps=1024, min_near=0.2,
                        density_scale=1.0, dt_gamma=0.0):
    """Sharded full-image render through the occupancy march: returns
    render(params, occ_packed, rays_o, rays_d) -> dict(image, depth,
    weights_sum), every rank holding the whole image."""
    def render(params, occ_packed, rays_o, rays_d):
        return shard_rays(
            lambda o, d: render_rays_march(
                params, static, occ_packed, o, d, num_samples=num_samples,
                max_steps=max_steps, bg_color=1.0, min_near=min_near,
                density_scale=density_scale, dt_gamma=dt_gamma),
            mesh, rays_o, rays_d)

    return render


def _rank_main(rank, fn, devices, backend, init_method, timeout, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(init_method, world_size=len(devices), rank=rank, backend=backend,
                         timeout=timeout)
    try:
        fn(make_mesh(devices=devices), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, devices, args=(), timeout=multihost.DEFAULT_TIMEOUT):
    """Run fn(mesh, *args) in len(devices) new processes of this host
    (torch.multiprocessing, spawn), rank r on devices[r], joined through a
    file:// rendezvous in a fresh temporary directory; the backend as
    `choose_backend` picks it.  `fn` must be importable (pickled by name).
    If a rank fails the others are terminated and its error is raised
    (torch.multiprocessing.ProcessRaisedException / ProcessExitedException)."""
    devices = [str(torch.device(d)) for d in devices]
    with tempfile.TemporaryDirectory(prefix="enerf_rendezvous_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, devices, choose_backend(devices), init, timeout, args),
            nprocs=len(devices), join=True)
