"""The port's data parallelism against enerf_tpu's mesh, on the CPU.

JAX runs its sharded step, render and occupancy update on a 2-device mesh
of tests/conftest.py's virtual devices; the port runs two gloo ranks in a
subprocess (tests/torch_dp_worker.py) on the same numpy inputs, with JAX's
draws handed in as noise.  Held:
  - each step case (events with C_thres 0.2 and -1, frames with the error
    map, the march with K1's plain version): the loss terms within rtol
    1e-4 of JAX's sharded step, the params within atol 1e-5 of it wherever
    Adam's step is decided by a gradient clear of the packages' rounding,
    the two ranks' state bit-equal, and every param within atol 1e-5 of the
    port's single-process step on the global batch with the same noise;
    with C_thres -1 a loss normalized per rank misses those tolerances;
  - the sharded render within atol 1e-5 of JAX's and of one process's;
  - update_occupancy_sharded's full phase equal to the serial update, and
    within the cross-package tolerance of JAX's sharded update.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from torch_parity import n, params_np, t, unit_dirs
import torch_dp_worker as W

from enerf_tpu.models import field as jfield
from enerf_tpu.ops import hashgrid as jh
from enerf_tpu.ops.aabb import near_far_from_aabb as jnear_far
from enerf_tpu.parallel import mesh as jmesh
from enerf_tpu.render import march as jmarch, occupancy as jocc
from enerf_tpu.train import state as jstate, step as jstep
from enerf_torch.models.field import FieldStatic
from enerf_torch.render import occupancy as tocc

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
JAX_STEP_EXTRA = dict(upsample_steps=0, weight_loss_rgb=1.0, negative_event_sampling=False,
                      w_no_ev=1.0)


def _jax_case(case):
    """JAX statics, params with a table of U(+-0.5) (U(+-1e-2) on the
    block grid, whose density_bias already makes the renders half opaque)."""
    c = W.CASES[case]
    sj = jfield.FieldStatic(**W.FIELD_KW[c["field"]])
    if c["field"] == "hashgrid64":
        sj.grid_meta = jh.HashGridMeta(**W.HASHGRID64)
    pj = jfield.init_field_params(jax.random.PRNGKey(1), sj)
    rng = np.random.default_rng(1)
    lim = 0.5 if c["field"] == "hashgrid64" else 1e-2
    pj["hash_table"] = jnp.asarray(rng.uniform(-lim, lim, pj["hash_table"].shape)
                                   .astype(np.float32))
    step = {**W.COMMON, **c["step"]}
    step.setdefault("num_steps", 64)
    ss = jstep.StepStatics(field_static=sj, **JAX_STEP_EXTRA, **step)
    return ss, pj


def _event_batch(rng, N):
    o1 = unit_dirs(rng, N) * 2.5
    d1 = rng.uniform(-0.4, 0.4, (N, 3)).astype(np.float32) - o1
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    o2 = o1 + rng.normal(scale=0.2, size=(N, 3)).astype(np.float32)
    d2 = d1 + rng.normal(scale=0.1, size=(N, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return {"rays_evs_o1": o1, "rays_evs_d1": d1.astype(np.float32),
            "rays_evs_o2": o2.astype(np.float32), "rays_evs_d2": d2.astype(np.float32),
            "pols": rng.choice([-1.0, 1.0], N).astype(np.float32)}


def _frame_batch(rng, N):
    o = np.repeat(unit_dirs(rng, 1) * 2.5, N, 0)
    d = rng.uniform(-0.6, 0.6, (N, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": o.astype(np.float32), "rays_d": d.astype(np.float32),
            "images": rng.uniform(0, 1, (N, 1)).astype(np.float32)}


def _fixed_noise(key, num_steps, n):
    k_pert, _ = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_pert, (n, num_steps)))


def _jax_step_case(case, inputs):
    """One case's inputs and draws, into `inputs`; returns the function that
    runs JAX's sharded step on make_mesh(2) and the gradient of its global
    loss (unsharded)."""
    c = W.CASES[case]
    ss, pj = _jax_case(case)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(11)
    occ = None
    if c["mode"] == "events":
        batch, N = _event_batch(rng, W.N_EVENTS), W.N_EVENTS
        k_bg, k1, k2 = jax.random.split(key, 7)[:3]
        noise = {"bg": np.asarray(jax.random.uniform(k_bg, (1, 1)))}
        if ss.use_march:
            occ = np.asarray(jocc.ball_bitfield(radius=0.6))
            noise["jitter1"] = np.asarray(jax.random.uniform(k1, (N,)))
            noise["jitter2"] = np.asarray(jax.random.uniform(k2, (N,)))
            for i, k in ((1, k1), (2, k2)):
                o, d = (jnp.asarray(batch[f"rays_evs_{v}{i}"]) for v in "od")
                box = jnp.asarray([-1, -1, -1, 1, 1, 1], jnp.float32)
                nears, fars = jnear_far(o, d, box, ss.min_near)
                ts, dts, valid = jmarch.march_rays(
                    o, d, jnp.asarray(occ), nears, fars, k, num_samples=ss.march_samples,
                    max_steps=ss.max_steps, cascades=1, bound=1.0, dt_gamma=ss.dt_gamma,
                    perturb=True)
                for name, v in (("ts", ts), ("dts", dts), ("valid", valid)):
                    inputs[f"{case}/march{i}/{name}"] = np.asarray(v)
            inputs[f"{case}/occ"] = occ
        else:
            noise["jitter1"] = _fixed_noise(k1, ss.num_steps, N)
            noise["jitter2"] = _fixed_noise(k2, ss.num_steps, N)
    else:
        batch = _frame_batch(rng, W.N_FRAMES)
        k_bg, k_r = jax.random.split(key)
        noise = {"bg_frames": np.asarray(jax.random.uniform(k_bg, (W.N_FRAMES, 1))),
                 "jitter_frames": _fixed_noise(k_r, ss.num_steps, W.N_FRAMES)}
    for part, d in (("param", params_np(pj)), ("batch", batch), ("noise", noise)):
        inputs.update({f"{case}/{part}/{k}": np.asarray(v) for k, v in d.items()})

    def reference():
        bj = {k: jnp.asarray(v) for k, v in batch.items()}
        occ_j = None if occ is None else jnp.asarray(occ)
        loss_fn = jstep.event_loss_fn if c["mode"] == "events" else jstep.frames_loss_fn
        grads = jax.grad(lambda p: loss_fn(p, ss, bj, key, occ_j)[0])(pj)
        state, opt = jstate.init_train_state(pj, W.LR, W.ITERS)
        mesh = jmesh.make_mesh(2)
        step = jmesh.make_sharded_train_step(ss, opt, mesh, mode=c["mode"])
        new, scalars = step(jmesh.replicate(state, mesh), jmesh.shard_batch(bj, mesh), key,
                            None if occ_j is None else jmesh.replicate(occ_j, mesh))
        return {"params": {k: np.asarray(v) for k, v in new.params.items()},
                "scalars": {k: np.asarray(v) for k, v in scalars.items()},
                "grads": {k: np.asarray(v) for k, v in grads.items()}}

    return reference


def _jax_full_update_noise(key, cas):
    """The cell jitter update_occupancy's full phase (and its sharded form,
    which keeps the serial keys) draws from `key`."""
    H3 = jocc.GRID_SIZE ** 3
    _, k = jax.random.split(key)
    out, rng = [], k
    for _ in range(cas):
        rng, kc = jax.random.split(rng)
        keys = jax.random.split(kc, 64)
        out.append(np.concatenate([np.asarray(jax.random.uniform(kk, (H3 // 64, 3)))
                                   for kk in keys]))
    return np.stack(out)


def _jax_render(inputs):
    sj = jfield.FieldStatic(**W.RENDER_FIELD)
    pj = jfield.init_field_params(jax.random.PRNGKey(0), sj)
    occ = np.asarray(jocc.ball_bitfield(radius=0.5))
    rng = np.random.RandomState(0)
    N = 131  # not a multiple of the ranks: the padding path
    o = np.tile(np.array([[0., 0., -2.5]], np.float32), (N, 1))
    d = rng.uniform(-0.4, 0.4, (N, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    inputs.update({f"render/param/{k}": v for k, v in params_np(pj).items()})
    inputs.update({"render/occ": occ, "render/rays_o": o, "render/rays_d": d})

    def reference():
        mesh = jmesh.make_mesh(2)
        out = jmesh.make_sharded_render(sj, mesh, num_samples=32, max_steps=256)(
            jmesh.replicate(pj, mesh), jmesh.replicate(jnp.asarray(occ), mesh), jnp.asarray(o),
            jnp.asarray(d))
        return {k: np.asarray(v) for k, v in out.items()}

    return reference


def _jax_occupancy(inputs):
    import functools
    from jax.sharding import NamedSharding, PartitionSpec as P
    sj = jfield.FieldStatic(**W.OCC_FIELD)
    pj = jfield.init_field_params(jax.random.PRNGKey(0), sj)
    key = jax.random.PRNGKey(3)
    inputs.update({f"occ/param/{k}": v for k, v in params_np(pj).items()})
    inputs["occ/noise"] = _jax_full_update_noise(key, 1)

    def reference():
        mesh = jmesh.make_mesh(2)
        repl = NamedSharding(mesh, P())

        @functools.partial(jax.jit, in_shardings=(repl, repl, repl), out_shardings=repl)
        @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()), out_specs=P())
        def sharded(params, occ, k):
            return jocc.update_occupancy_sharded(params, sj, occ, k, axis_name="data",
                                                 n_lanes=2)

        o = sharded(pj, jocc.init_occupancy(1.0), key)
        return {"density_grid": np.asarray(o.density_grid),
                "mean_density": float(o.mean_density), "occ_bitfield": np.asarray(o.occ_bitfield)}

    return reference


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results, and the two port ranks' (rank0, rank1) on the same
    inputs; the ranks run while JAX computes its references."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs = {}
    refs = {case: _jax_step_case(case, inputs) for case in W.CASES}
    # the error map of the frames case: 2 frames, each rank's cells
    rng = np.random.default_rng(5)
    inputs["frames/errmap/map"] = rng.uniform(0, 1, (2, 128 * 128)).astype(np.float32)
    inputs["frames/errmap/fi"] = np.asarray([0, 1], np.int64)
    cells = rng.integers(0, 128 * 128, W.N_FRAMES)
    cells[:4] = cells[W.N_FRAMES // 2:W.N_FRAMES // 2 + 4]  # the same cells, other frames
    inputs["frames/errmap/cells"] = cells
    refs["render"] = _jax_render(inputs)
    refs["occ"] = _jax_occupancy(inputs)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with open(tmp / "ranks.log", "w") as log:
        # its own session, so that a hung rank is killed with its parent
        proc = subprocess.Popen([sys.executable, WORKER, str(tmp / "inputs.npz"), str(tmp)],
                                env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            jax_out = {k: f() for k, f in refs.items()}
            proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            pytest.fail("the two port ranks did not finish in 300 s")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    assert proc.returncode == 0, (tmp / "ranks.log").read_text()
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)]
    return jax_out, ranks, inputs


def _params(out, prefix):
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("case", list(W.CASES))
def test_sharded_step_matches_jax_mesh(runs, case):
    jax_out, (r0, r1), _ = runs
    ref = jax_out[case]
    loss = float(r0[f"{case}/scalar/loss"])
    assert loss > 1e-3
    np.testing.assert_allclose(loss, float(ref["scalars"]["loss"]), rtol=1e-4)
    for k in ref["scalars"]:
        if k != "per_ray_loss":
            np.testing.assert_allclose(float(r0[f"{case}/scalar/{k}"]),
                                       float(ref["scalars"][k]), rtol=1e-4, err_msg=k)
    assert not any(k.startswith(f"{case}/scalar/implC_") for k in r0)
    p_dp, g_dp = _params(r0, f"{case}/param"), _params(r0, f"{case}/grad")
    assert set(p_dp) == set(ref["params"])
    for k, pj in ref["params"].items():
        # The reduced gradient against JAX's gradient of the global loss, at
        # the single-process parity tests' tolerances (tests/test_torch_frames.py:
        # the event pair's two renders cancel in the table's and sigma_w0's
        # gradients, whose f32 rounding reaches a few 1e-2 of their scale).
        gj = ref["grads"][k]
        scale = np.abs(gj).max()
        tol = 5e-2 if k in ("hash_table", "sigma_w0") else 1e-3
        np.testing.assert_allclose(g_dp[k], gj, rtol=0, atol=tol * scale, err_msg=k)
        assert np.linalg.norm(g_dp[k] - gj) <= 5e-3 * np.linalg.norm(gj), k
        # Adam's first step moves an entry by lr times the sign of its
        # gradient, whatever its size: atol 1e-5 wherever the gradient is
        # clear of that tolerance; where it is within rounding of zero its
        # sign may differ between the packages (measured: 4 of 58,992 table
        # entries), and the entry then lands at most 2 lr away
        clear = np.abs(gj) > 2 * tol * scale
        np.testing.assert_allclose(p_dp[k][clear], pj[clear], rtol=0, atol=1e-5, err_msg=k)
        assert np.abs(p_dp[k] - pj).max() <= 2 * W.LR * (1 + 1e-4), k
    # the ranks hold the same state, bit for bit
    for part in ("param", "ema", "grad", "scalar"):
        for k, v in _params(r0, f"{case}/{part}").items():
            np.testing.assert_array_equal(r1[f"{case}/{part}/{k}"], v, err_msg=f"{part} {k}")
    # and the state one process reaches on the global batch with the same noise
    np.testing.assert_allclose(loss, float(r0[f"{case}/single/loss"]), rtol=1e-4)
    for k, v in _params(r0, f"{case}/single/param").items():
        np.testing.assert_allclose(p_dp[k], v, rtol=0, atol=1e-5, err_msg=k)


def test_normalized_event_loss_needs_the_global_norm(runs):
    """C_thres = -1 divides by the norm over the batch: a rank that takes it
    over its own shard computes another loss, which misses JAX's."""
    jax_out, (r0, r1), _ = runs
    ref = float(jax_out["events_norm"]["scalars"]["loss"])
    per_rank = float(r0["events_norm/per_rank/loss"])
    assert abs(per_rank - ref) > 1e-4 * abs(ref) * 10, (per_rank, ref)
    worst = max(np.abs(r0[f"events_norm/per_rank/param/{k}"] - v).max()
                for k, v in jax_out["events_norm"]["params"].items())
    assert worst > 1e-5
    np.testing.assert_array_equal(float(r1["events_norm/per_rank/loss"]), per_rank)


def test_frames_step_gathers_per_ray_loss_and_error_map(runs):
    jax_out, (r0, r1), inputs = runs
    ref = jax_out["frames"]["scalars"]["per_ray_loss"]
    got = r0["frames/scalar/per_ray_loss"]
    assert got.shape == ref.shape == (W.N_FRAMES,)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)
    # every rank applies every rank's cells in rank order: the maps agree
    # and equal that update of the map, done here in numpy
    np.testing.assert_array_equal(r1["frames/errmap/after"], r0["frames/errmap/after"])
    emap = inputs["frames/errmap/map"].copy()
    cells, half = inputs["frames/errmap/cells"], W.N_FRAMES // 2
    for r in (0, 1):
        c = cells[r * half:(r + 1) * half]
        emap[r, c] = 0.1 * emap[r, c] + 0.9 * got[r * half:(r + 1) * half]
    np.testing.assert_allclose(r0["frames/errmap/after"], emap, rtol=1e-6)


def test_sharded_render_matches_jax_and_one_process(runs):
    jax_out, (r0, r1), _ = runs
    for k in ("image", "depth", "weights_sum"):
        got = r0[f"render/sharded/{k}"]
        assert got.shape[0] == 131
        np.testing.assert_array_equal(r1[f"render/sharded/{k}"], got)
        np.testing.assert_allclose(got, r0[f"render/single/{k}"], atol=1e-5, err_msg=k)
        if k in jax_out["render"]:
            np.testing.assert_allclose(got, jax_out["render"][k], atol=1e-5, err_msg=k)
    assert r0["render/sharded/weights_sum"].max() > 0.05


def test_sharded_occupancy_update_matches_serial_and_jax(runs):
    jax_out, (r0, r1), inputs = runs
    for k in ("density_grid", "occ_bitfield", "mean_density"):
        np.testing.assert_array_equal(r1[f"occ/full/{k}"], r0[f"occ/full/{k}"])
    assert int(r0["occ/full/iter_density"]) == 1
    # the full phase: the serial update's queries, merged exactly
    st = FieldStatic(**W.OCC_FIELD)
    params = {k[len("occ/param/"):]: t(v) for k, v in inputs.items()
              if k.startswith("occ/param/")}
    serial = tocc.update_occupancy(params, st, tocc.init_occupancy(1.0),
                                   noise=t(inputs["occ/noise"]))
    grid = r0["occ/full/density_grid"]
    assert (grid >= 0).all()
    np.testing.assert_allclose(grid, n(serial.density_grid), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(r0["occ/full/occ_bitfield"], n(serial.occ_bitfield))
    # JAX's sharded update: the cross-package tolerance of the serial update
    # (tests/test_torch_render.py: JAX's jit may FMA-contract a query point,
    # moving 3e-5 of the cells beyond 1e-4)
    g_j = jax_out["occ"]["density_grid"]
    rel = np.abs(grid - g_j) / np.abs(g_j)
    assert (rel > 1e-4).mean() < 1e-4
    np.testing.assert_allclose(float(r0["occ/full/mean_density"]),
                               jax_out["occ"]["mean_density"], rtol=1e-4)
    thresh = min(jax_out["occ"]["mean_density"], 0.01)
    clear = np.abs(g_j - thresh) > 1e-4 * thresh
    np.testing.assert_array_equal(r0["occ/full/occ_bitfield"][clear],
                                  jax_out["occ"]["occ_bitfield"][clear])
    # the resampling phase: each rank's draws merged into one grid
    np.testing.assert_array_equal(r1["occ/partial/density_grid"], r0["occ/partial/density_grid"])
    assert np.isfinite(r0["occ/partial/density_grid"]).all()
    assert int(r0["occ/partial/iter_density"]) == 21
    assert (r0["occ/partial/density_grid"] != grid).any()
