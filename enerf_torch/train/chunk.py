"""Training windows: K steps with the occupancy update first.

Counterpart of enerf_tpu/train/chunk.py (`make_train_chunk`, the JAX
trainer's `--fuse_steps K` path, K = 16 by default).  A window runs

  1. the occupancy update, once, at its start (unless `freeze_occ`), in
     place on the grid, bitfield and packed bitfield the steps read
     (render/occupancy.py), as JAX's window runs it before its scan and the
     reference every 16 steps;
  2. K steps of {batch, loss, backward, Adam + EMA, error-map update};
  3. and returns the window mean of every scalar the steps report, as
     JAX's `tree.map(jnp.mean)` does.

On a card (one process) the window is one step captured in a CUDA graph
and replayed: the window's first step runs eagerly on a side stream (the
capture's warm-up, and a real step of the window), the cache it leaves is
freed, one step is captured (capture records, it does not run) and
replayed K - 1 times; later windows replay it K times.  The graph's
private memory pool (made of expandable segments, which fragment less)
holds a whole step's memory.  So the trainer keeps the graph across
epochs and runs an epoch's steps after its last window through the same
captured step, one a call (`steps=1`, with the per-step path's occupancy
cadence, `update`), and releases the graph only before an evaluation and
at the end of `train`: the capture is paid once a run and once after
each evaluation.  Everything the
step reads stays at a fixed address: the params, the Adam moments and the
device update count (train/state.py), the EMA, the packed bitfield, the
provider's arrays and error map, and the states of the trainer's
generators, which are registered with the graph so that each replay draws
new numbers, the numbers an eager step would draw.  The march (kernel M1)
and the batch sampling sync with the host nowhere, which a capture needs.
A window whose inputs moved (a resumed checkpoint, `mark_untrained_grid`)
is captured again.  The launches of the port's kernels recorded in the
captured step, and the span registry's counters, are added to their
counts once per replay (`per_replay`, utils/profiling.py `recording`;
chip_smoke.py holds the launches to the kernels a profiler sees in one
replay).

Spans (utils/profiling.py): `step` around each step, with `step.batch`
(the batch, its error-map cells and the noise draw) and, in train/step.py,
`step.forward`, `step.backward` and `step.optim`; `window.warmup` around a
capture's eager first step, so that its spans lie apart from the captured
step's.  A replay records the captured step's spans on the card.

On the CPU the same step function runs eagerly K times, and under a
data-parallel mesh as well (`mesh`; parallel/mesh.py `make_window_step`):
each rank draws the config's whole batch from its own generator and
normalizes its loss over it, the gradient is the ranks' mean, the error
map's per-rank updates merge at the window's end and the window's aux is
averaged over the ranks.  The mesh window is not captured: gloo, the
backend of the CPU and of two ranks on one card, cannot be captured, and
the NCCL window's capture is future work.

For the tests a window takes K handed-in batches (with their error-map
cells) and noise draws, as the steps do (train/step.py `draw_noise`).
"""

import contextlib
import gc
import os

import torch

from enerf_torch.parallel import mesh as dp
from enerf_torch.render.occupancy import update_occupancy, update_occupancy_sharded
from enerf_torch.train.step import step_noise, train_step_events, train_step_frames
from enerf_torch.utils import profiling


@contextlib.contextmanager
def _expandable_segments():
    """Inside, the CUDA caching allocator makes expandable segments (grown
    in place), unless PYTORCH_CUDA_ALLOC_CONF says how to allocate.  A
    captured step's private pool cannot hand cached blocks back, so with
    fixed-size segments it fragments: the capture of `mocapDesk2_enerf`'s
    step (61 GiB allocated at its peak) reserved all of an 80 GB H100 and
    ran out of memory, where expandable segments reserve ~67 GiB
    (PERF.md §5).  Outside the capture the allocator keeps its setting."""
    if "PYTORCH_CUDA_ALLOC_CONF" in os.environ:
        yield
        return
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def kernel_counters():
    """The wrapper functions whose `launches` count the port's kernels."""
    from enerf_torch.ops import fused_mlp, group_gather, scatter_accum
    from enerf_torch.render import march
    return (fused_mlp.fused_field_head, scatter_accum.block_table_grad,
            group_gather.group_gather, march.march_rays)


class TrainChunk:
    """One training window of `chunk_len` steps (see the module docstring).

    mode: 'events' | 'frames'; ss: the window's StepStatics (warm_statics
    for a march_warmup window); use_occ: the march path's occupancy grid;
    freeze_occ: no update (cfg.occ_freeze_after); error_map: the frames
    provider's error map is updated after each step; mesh: this rank's
    parallel.mesh.Mesh."""

    def __init__(self, ss, mode, chunk_len=16, use_occ=True, freeze_occ=False,
                 density_scale=1.0, density_thresh=0.01, error_map=False, mesh=None):
        if mode not in ("events", "frames"):
            raise ValueError(f"mode {mode!r}")
        self.ss, self.mode, self.chunk_len = ss, mode, int(chunk_len)
        self.use_occ, self.freeze_occ = use_occ, freeze_occ
        self.occ_kw = dict(density_scale=density_scale, density_thresh=density_thresh)
        self.error_map, self.mesh = error_map, mesh
        self.step_fn = train_step_events if mode == "events" else train_step_frames
        self.window_step = dp.make_window_step(ss, mesh, mode) if mesh is not None else None
        self.acc = {}  # the window's sums of the steps' scalars
        self.graph = None
        self._inputs = None  # what the graph was captured on
        self.per_replay = profiling.Replay()  # what one replay adds to the counts
        self.captures = 0

    def release(self):
        """Drop the captured graph (and its memory pool)."""
        self.graph, self._inputs, self.per_replay = None, None, profiling.Replay()

    # ------------------------------------------------------------ one step

    def _step(self, state, occ_bits, provider, generator, rank_generator, drawn=None,
              noise=None):
        """One step of the window; its scalars are added to self.acc."""
        dev = state.count.device
        with profiling.span("step", dev):
            with profiling.span("step.batch", dev):
                if drawn is None:
                    batch = provider.train_step_batch(rank_generator)
                    cells = provider.error_map_cells() if self.error_map else None
                else:
                    batch, cells = drawn
                if noise is None and self.mesh is None:
                    noise = step_noise(self.ss, batch, generator, self.mode)
            if self.mesh is None:
                aux = self.step_fn(state, batch, self.ss, occ_bits, noise=noise,
                                   generator=generator)
            else:
                aux = self.window_step(state, batch, occ_bits, rank_generator, noise=noise)
            if self.error_map:
                provider.update_error_map(aux["per_ray_loss"], cells)
            for k, v in aux.items():
                # implC_* medians are per rank under a mesh: JAX leaves them out
                if v.ndim or (self.mesh is not None and k.startswith("implC_")):
                    continue
                if k not in self.acc:
                    self.acc[k] = torch.zeros((), device=v.device)
                self.acc[k].add_(v.detach().float())

    # ----------------------------------------------------------- a window

    def __call__(self, state, occ, provider=None, generator=None, rank_generator=None,
                 batches=None, noises=None, occ_noise=None, steps=None, update=True):
        """Run one window on `state` (in place) -> (occ, aux).

        occ: the OccupancyState (None off the march path); provider: the
        train provider (its batches, its error map); generator: the
        trainer's shared generator (the occupancy update, the noise on one
        process); rank_generator: the batch's, and under a mesh the noise's
        (default: generator).  batches / noises: K handed-in (batch,
        error-map cells or None) pairs and noise dicts; occ_noise: the
        occupancy update's cell jitter (update_occupancy's `noise`).  steps:
        how many steps (default chunk_len; the trainer runs an epoch's
        last steps one at a time); update: whether the occupancy update
        runs first.  On a card without a mesh the steps replay the
        captured graph."""
        dev = next(iter(state.params.values())).device
        graphed = dev.type == "cuda" and self.mesh is None
        if graphed and (batches is not None or noises is not None):
            raise ValueError("a graphed window draws its own batches and noise")
        return self._window(state, occ, provider, generator, rank_generator, batches, noises,
                            occ_noise, graphed, steps or self.chunk_len, update)

    def eager(self, state, occ, provider, generator, rank_generator=None):
        """The window with its K steps run eagerly, on any device: what a
        graphed window is held to on the card."""
        return self._window(state, occ, provider, generator, rank_generator, None, None, None,
                            False, self.chunk_len, True)

    def _window(self, state, occ, provider, generator, rank_generator, batches, noises,
                occ_noise, graphed, steps, update):
        rank_generator = rank_generator if rank_generator is not None else generator
        if self.use_occ and not self.freeze_occ and update:
            if self.mesh is None:
                occ = update_occupancy(state.params, self.ss.field_static, occ, generator,
                                       noise=occ_noise, **self.occ_kw)
            else:
                occ = update_occupancy_sharded(state.params, self.ss.field_static, occ,
                                               generator, rank_generator, mesh=self.mesh,
                                               noise=occ_noise, **self.occ_kw)
        occ_bits = occ.occ_packed if (self.use_occ and occ is not None) else None
        base = None
        if self.mesh is not None and self.error_map:
            base = provider.error_map.clone()
        for v in self.acc.values():
            v.zero_()
        step0 = state.step
        if graphed:
            self._graphed(state, occ_bits, provider, generator, rank_generator, steps)
        else:
            for i in range(steps):
                self._step(state, occ_bits, provider, generator, rank_generator,
                           None if batches is None else batches[i],
                           None if noises is None else noises[i])
        state.step = step0 + steps  # a capture runs the host code, not the step
        if base is not None:
            dp.merge_error_map(base, provider.error_map, self.mesh)
        aux = {k: v / steps for k, v in self.acc.items()}
        if self.mesh is not None:
            aux = dp.global_means(aux, self.mesh)
        return occ, aux

    # ---------------------------------------------------------- the graph

    def _input_key(self, state, occ_bits, provider, generator, rank_generator):
        """What a captured step reads, by identity and address."""
        ptrs = [t.data_ptr() for d in (state.params, state.ema_params, state.exp_avg,
                                       state.exp_avg_sq) for t in d.values()]
        ptrs.append(state.count.data_ptr())
        if occ_bits is not None:
            ptrs.append(occ_bits.data_ptr())
        if self.error_map:
            ptrs.append(provider.error_map.data_ptr())
        return (id(state), id(provider), id(generator), id(rank_generator), tuple(ptrs))

    def _graphed(self, state, occ_bits, provider, generator, rank_generator, steps):
        key = self._input_key(state, occ_bits, provider, generator, rank_generator)
        replays = steps
        if self.graph is None or self._inputs != key:
            self.release()
            # warm-up: the window's first step, eagerly on a side stream
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), profiling.span("window.warmup", state.count.device):
                self._step(state, occ_bits, provider, generator, rank_generator)
            torch.cuda.current_stream().wait_stream(side)
            replays -= 1
            # the warm-up's cached blocks go back to the card: the graph's
            # private pool cannot use them
            gc.collect()
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            for g in {generator, rank_generator}:
                graph.register_generator_state(g)
            with profiling.recording(kernel_counters()) as per_replay, \
                    _expandable_segments(), torch.cuda.graph(graph):
                self._step(state, occ_bits, provider, generator, rank_generator)
            self.per_replay = per_replay
            self.graph, self._inputs = graph, key
            self.captures += 1
        for _ in range(replays):
            profiling.replayed(self.per_replay)
            self.graph.replay()


def make_train_chunk(ss, mode, chunk_len=16, use_occ=True, freeze_occ=False,
                     density_scale=1.0, density_thresh=0.01, error_map=False, mesh=None):
    """A TrainChunk (enerf_tpu's make_train_chunk; see the module docstring)."""
    return TrainChunk(ss, mode, chunk_len=chunk_len, use_occ=use_occ, freeze_occ=freeze_occ,
                      density_scale=density_scale, density_thresh=density_thresh,
                      error_map=error_map, mesh=mesh)
