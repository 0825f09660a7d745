"""The port's data-parallel training window against enerf_tpu's chunk on a
2-device mesh (tests/conftest.py's virtual devices), on the CPU.

JAX runs make_train_chunk(..., mesh) under shard_map: each chip folds its
lane into each step's key and draws its own batch at the config's size,
normalizes its loss over that batch alone, the gradients are pmean'd, the
error map's per-chip updates merge at the window's end (base + the sum of
the deltas, floored at 1e-4).  The test reproduces those draws lane by
lane (its window unrolled, held to JAX's), hands each lane's batches and
noise to the matching rank of the port (tests/torch_chunk_worker.py, two
gloo ranks in a subprocess under a timeout) and holds:
  - events at C_thres -1 (each rank's loss normalized over its own
    batch, as each chip's is) and frames with the error map, K = 2: the
    window's mean loss within 1e-4 of JAX's, the params within
    tests/test_torch_chunk.py's bounds of JAX's, the ranks bit-equal, the
    merged error map within 1e-3 of JAX's;
  - the trainer's window under a mesh: each rank samples the config's
    whole batch, and a 20-step epoch is rounded down to one 16-step window,
    which the log says.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from torch_parity import params_np
import torch_chunk_worker as W

from enerf_tpu.data import provider as jprov, synthetic as jsyn
from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_tpu.parallel import mesh as jmesh
from enerf_tpu.train import chunk as jchunk, state as jstate, step as jstep

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_chunk_worker.py")


def _jax_setup(case):
    sj = jfield.FieldStatic(**W.FIELD)
    sj.grid_meta = jh.HashGridMeta(**W.GRID)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    pj["hash_table"] = jnp.asarray(np.random.default_rng(1).uniform(
        -0.5, 0.5, pj["hash_table"].shape).astype(np.float32))
    ss = jstep.StepStatics(field_static=sj, upsample_steps=0, weight_loss_rgb=1.0,
                           negative_event_sampling=False, w_no_ev=1.0, **W.COMMON,
                           **W.CASES[case]["step"])
    if W.CASES[case]["mode"] == "events":
        data = jsyn.simulate_events(H=16, W=16, n_frames=8, C=0.2)
        prov = jprov.EventProvider(data["events"], data["frame_ts"], data["poses"],
                                   data["intrinsics"], 16, 16, batch_size_evs=W.N_EVENTS)
    else:
        data = jsyn.simulate_events(H=24, W=20, n_frames=6, C=0.2)
        prov = jprov.FramesProvider(data["frames"], data["poses"], data["intrinsics"],
                                    num_rays=W.N_FRAMES, error_map=True)
    return ss, pj, prov


def _fixed_noise(key, n):
    k_pert, _ = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_pert, (n, W.NUM_STEPS)))


def _jax_case(case, inputs):
    """The case's inputs (params, each lane's draws) into `inputs`; returns
    the function that runs JAX's dp window, and the unrolled window's
    params (and merged error map)."""
    mode = W.CASES[case]["mode"]
    ss, pj, prov = _jax_setup(case)
    arrs, statics = prov.sampler_bundle()
    inputs.update({f"{case}/param/{k}": v for k, v in params_np(pj).items()})
    emap0 = None
    if mode == "frames":
        emap0 = np.random.default_rng(2).uniform(0.1, 1, (6, 128 * 128)).astype(np.float32)
        inputs[f"{case}/emap0"] = emap0
    key = jax.random.PRNGKey(7)
    loss_fn = jstep.event_loss_fn if mode == "events" else jstep.frames_loss_fn
    state, opt = jstate.init_train_state(jax.tree.map(jnp.copy, pj), W.LR, W.ITERS)
    emaps = [None if emap0 is None else jnp.asarray(emap0) for _ in range(2)]
    for i, k in enumerate(jax.random.split(key, W.K)):  # chunk.py:137 (no occupancy split)
        grads = []
        for r in range(2):
            k1, k2 = jax.random.split(jax.random.fold_in(k, r))  # chunk.py:108-112
            pre = f"{case}/r{r}/s{i}/"
            if mode == "events":
                batch = jprov._event_sample_jit(k1, arrs, **statics)
                k_bg, kj1, kj2 = jax.random.split(k2, 7)[:3]  # event_loss_fn's draws
                noise = {"bg": np.asarray(jax.random.uniform(k_bg, (1, 1))),
                         "jitter1": _fixed_noise(kj1, W.N_EVENTS),
                         "jitter2": _fixed_noise(kj2, W.N_EVENTS)}
            else:
                batch, fi, ic = jprov._frames_sample_jit(
                    k1, arrs["poses"], arrs["images"], emaps[r], arrs["intrinsics"], **statics)
                k_bg, k_r = jax.random.split(k2)  # frames_loss_fn's draws
                noise = {"bg_frames": np.asarray(jax.random.uniform(k_bg, (W.N_FRAMES, 1))),
                         "jitter_frames": _fixed_noise(k_r, W.N_FRAMES)}
                inputs[pre + "fi"] = np.asarray(fi, np.int64).reshape(1)
                inputs[pre + "ic"] = np.asarray(ic, np.int64)
            inputs.update({pre + f"batch/{n}": np.asarray(v) for n, v in batch.items()})
            inputs.update({pre + f"noise/{n}": v for n, v in noise.items()})
            (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params, ss, batch, k2, None)
            grads.append(g)
            if mode == "frames":
                emaps[r] = emaps[r].at[fi, ic].set(0.1 * emaps[r][fi, ic]
                                                   + 0.9 * aux["per_ray_loss"])
        state = jstate.apply_updates(state, jax.tree.map(lambda a, b: (a + b) / 2, *grads), opt)
    unrolled = {"params": {k: np.asarray(v) for k, v in state.params.items()}}
    if mode == "frames":
        unrolled["emap"] = np.maximum(emap0 + sum(np.asarray(e) - emap0 for e in emaps), 1e-4)

    def reference():
        mesh = jmesh.make_mesh(2)
        st, opt_ = jstate.init_train_state(jax.tree.map(jnp.copy, pj), W.LR, W.ITERS)
        chunk = jchunk.make_train_chunk(ss, opt_, mode, statics, chunk_len=W.K, use_occ=False,
                                        mesh=mesh)
        new, _, emap, aux = chunk(st, None, arrs, None if emap0 is None else jnp.asarray(emap0),
                                  key)
        return {"params": {k: np.asarray(v) for k, v in new.params.items()},
                "aux": {k: float(v) for k, v in aux.items()},
                "emap": None if emap is None else np.asarray(emap)}

    return reference, unrolled


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's dp windows and the unrolled ones, and the two port ranks'
    results; the ranks run while JAX computes its references."""
    tmp = tmp_path_factory.mktemp("chunk_dp")
    inputs, refs, unrolled = {}, {}, {}
    for case in W.CASES:
        refs[case], unrolled[case] = _jax_case(case, inputs)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with open(tmp / "ranks.log", "w") as log:
        # its own session, so that a hung rank is killed with its parent
        proc = subprocess.Popen([sys.executable, WORKER, str(tmp / "inputs.npz"), str(tmp)],
                                env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            jax_out = {k: f() for k, f in refs.items()}
            proc.wait(timeout=240)
        except subprocess.TimeoutExpired:
            pytest.fail("the two port ranks did not finish in 240 s")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    assert proc.returncode == 0, (tmp / "ranks.log").read_text()
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)]
    return jax_out, unrolled, ranks, inputs


@pytest.mark.parametrize("case", list(W.CASES))
def test_dp_window_matches_jax_chunk(runs, case):
    jax_out, unrolled, (r0, r1), inputs = runs
    ref = jax_out[case]
    # the test's unrolled window is JAX's window (its draws are the ones
    # handed to the port: other draws would move entries by ~lr = 5e-3);
    # op by op it rounds a few entries apart from the jitted window
    for k, v in ref["params"].items():
        np.testing.assert_allclose(unrolled[case]["params"][k], v, rtol=0, atol=1e-4,
                                   err_msg=k)
    # the ranks hold one state
    for k, v in r0.items():
        if k.startswith(case + "/"):
            np.testing.assert_array_equal(r1[k], v, err_msg=k)
    # the window's mean scalars (the ranks' means): f32 renders, 1e-4
    for k, v in ref["aux"].items():
        if np.ndim(v) == 0 and not k.startswith("implC_"):
            np.testing.assert_allclose(float(r0[f"{case}/aux/{k}"]), v, rtol=1e-4, err_msg=k)
    assert not any(k.startswith(f"{case}/aux/implC_") for k in r0)
    # params after K Adam steps of the averaged gradients: an entry whose
    # gradient sits at the packages' rounding may step the other way (2 lr
    # apart at most a step); each leaf's difference within 2.5e-2 of the
    # window's update by norm (tests/test_torch_chunk.py)
    for k, v in ref["params"].items():
        p0 = inputs[f"{case}/param/{k}"]
        got = r0[f"{case}/param/{k}"]
        assert np.abs(got - v).max() <= 2 * W.K * W.LR * (1 + 1e-4), k
        assert np.linalg.norm(got - v) <= 2.5e-2 * np.linalg.norm(v - p0), k
    if ref["emap"] is not None:
        got = r0[f"{case}/emap"]
        np.testing.assert_allclose(unrolled[case]["emap"], ref["emap"], rtol=1e-5, atol=1e-7)
        # per-ray losses of f32 renders: test_torch_frames_mode.py's 1e-3
        np.testing.assert_allclose(got, ref["emap"], rtol=1e-3, atol=1e-6)
        assert (got >= 1e-4).all()


def test_trainer_window_under_a_mesh_samples_the_config_batch_and_rounds_the_epoch(runs):
    _, _, (r0, r1), _ = runs
    for r in (r0, r1):
        assert int(r["trainer/num_rays"]) == 64  # the config's num_rays, not 64 / 2
        assert int(r["trainer/step"]) == 16
        assert bool(r["trainer/emap_changed"])
        assert list(r["trainer/logged_steps"]) == [16]
    log = str(r0["trainer/log"])
    assert "[train] mesh chunking: 20 steps/epoch rounded down to 16" in log
    assert "each rank samples the config's batch" in log
