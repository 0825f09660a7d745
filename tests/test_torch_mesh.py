"""Parity of the port's mesh export (enerf_torch/utils/mesh.py, Trainer.save_mesh)
with enerf_tpu's: the same mesh from the same density grid, byte-identical
files, and the density grid of save_mesh from the same weights."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import params_np

from enerf_tpu import config as jconfig
from enerf_tpu.models import field as jfield
from enerf_tpu.train import trainer as jtrainer
from enerf_tpu.utils import mesh as jmesh
from enerf_torch import config as tconfig
from enerf_torch.convert import params_from_jax
from enerf_torch.train import trainer as ttrainer
from enerf_torch.utils import mesh as tmesh


def _noisy_sphere(R, seed=0, dtype=np.float32):
    """1 - |x| on a [-1, 1]^3 grid plus seeded noise: a bumpy sphere of
    radius 0.5 at threshold 0.5, with crossing cells of every tet case."""
    g = np.linspace(-1, 1, R)
    xs, ys, zs = np.meshgrid(g, g, g, indexing="ij")
    u = 1.0 - np.sqrt(xs ** 2 + ys ** 2 + zs ** 2)
    return (u + 0.05 * np.random.default_rng(seed).normal(size=u.shape)).astype(dtype)


@pytest.mark.parametrize("R,seed,dtype", [(24, 0, np.float32), (17, 1, np.float32),
                                          (24, 2, np.float64), (16, 4, "noise")])
def test_marching_tets_gives_jax_mesh(R, seed, dtype):
    """The vectorised extraction against JAX's loop on the same grid:
    the same vertices bit for bit (numbered in order of first visit, each
    interpolated in its first visit's orientation) and the same triangles.
    "noise": seeded N(0, 1) at threshold 0.5, nearly every cell crossing."""
    if dtype == "noise":
        u = np.random.default_rng(seed).normal(size=(R, R, R)).astype(np.float32)
    else:
        u = _noisy_sphere(R, seed, dtype)
    vj, tj = jmesh.marching_tets(u, 0.5)
    vt, tt = tmesh.marching_tets(torch.from_numpy(u), 0.5)
    assert len(tj) > 1000
    assert vt.dtype == torch.float32 and tt.dtype == torch.int64
    np.testing.assert_array_equal(tt.numpy(), tj)
    np.testing.assert_array_equal(vt.numpy(), vj)


def test_marching_tets_without_surface():
    u = np.zeros((6, 6, 6), np.float32)
    for thr in (0.5, -0.5, 0.0):  # all outside, all inside, all on the level
        vj, tj = jmesh.marching_tets(u, thr)
        vt, tt = tmesh.marching_tets(torch.from_numpy(u), thr)
        assert vt.shape == (0, 3) and tt.shape == (0, 3)
        assert vj.shape == (0, 3) and tj.shape == (0, 3)


def test_extract_geometry_scaling_and_grid():
    """extract_fields queries JAX's grid points (float64 linspace rounded to
    float32) in the same order, and extract_geometry scales to the box as
    JAX's does, bit for bit."""
    bmin, bmax, R = [-1.0, -0.5, -0.7], [1.0, 0.8, 0.3], 13
    seen = {"jax": [], "torch": []}

    def q_jax(pts):
        seen["jax"].append(np.asarray(pts))
        return 0.6 - np.linalg.norm(pts, axis=-1)

    def q_torch(pts):
        seen["torch"].append(pts.numpy())
        return 0.6 - torch.linalg.norm(pts, dim=-1)

    vj, tj = jmesh.extract_geometry(bmin, bmax, R, 0.1, q_jax)
    vt, tt = tmesh.extract_geometry(bmin, bmax, R, 0.1, q_torch, device="cpu")
    np.testing.assert_array_equal(np.concatenate(seen["torch"]), np.concatenate(seen["jax"]))
    assert len(tj) > 100
    np.testing.assert_array_equal(tt.numpy(), tj)
    # JAX's norm and torch's may round the last bit apart: vertices from the
    # port's grid through both scalings are compared bit for bit instead
    u = tmesh.extract_fields(bmin, bmax, R, q_torch, device="cpu")
    v_grid, _ = tmesh.marching_tets(u, 0.1)
    want = (v_grid.numpy() / (R - 1.0) * (np.asarray(bmax) - np.asarray(bmin))[None, :]
            + np.asarray(bmin)[None, :]).astype(np.float32)
    np.testing.assert_array_equal(tmesh.to_world(v_grid, bmin, bmax, R).numpy(), want)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["write_obj", "write_ply"])
def test_mesh_files_are_byte_identical(tmp_path, writer):
    u = _noisy_sphere(20, 3)
    verts, tris = jmesh.marching_tets(u, 0.5)
    verts = verts / 19.0 * 2.0 - 1.0  # negative coordinates too
    verts[0] = [-0.0, -1e-9, 2.5e-7]  # signed zeros and rounding at the 6th decimal
    getattr(jmesh, writer)(str(tmp_path / "jax"), verts, tris)
    getattr(tmesh, writer)(str(tmp_path / "torch"), torch.from_numpy(verts), torch.from_numpy(tris))
    assert (tmp_path / "torch").read_bytes() == (tmp_path / "jax").read_bytes()
    getattr(jmesh, writer)(str(tmp_path / "jax0"), np.zeros((0, 3), np.float32),
                           np.zeros((0, 3), np.int64))
    getattr(tmesh, writer)(str(tmp_path / "torch0"), torch.zeros(0, 3), torch.zeros(0, 3).long())
    assert (tmp_path / "torch0").read_bytes() == (tmp_path / "jax0").read_bytes()


def _argv(tmp_path, *extra):
    # f32 compute on the hash grid (the published configs' encoder)
    return ["--mode", "synthetic", "--H", "32", "--W", "32", "--events", "1",
            "--event_only", "1", "--out_dim_color", "1", "--bound", "1",
            "--num_levels", "4", "--outdir", str(tmp_path), *extra]


@pytest.mark.parametrize("extra", [(), ("--cuda_ray", "--encoding", "blockgrid")])
def test_save_mesh_matches_jax(tmp_path, monkeypatch, extra):
    """Both trainers' save_mesh at resolution 32 with the same EMA weights:
    density grids within test_torch_field.py's f32 tolerance, the files
    where JAX's say.  A value an ulp from the threshold flips a cell, so
    the meshes are compared by handing JAX's grid to the port's extraction,
    which must give JAX's file byte for byte."""
    argv = _argv(tmp_path, *extra)
    jt = jtrainer.Trainer(jconfig.build_config(argv), workspace=str(tmp_path / "jax"),
                          use_checkpoint="scratch")
    tt = ttrainer.Trainer(tconfig.build_config(argv), device="cpu",
                          workspace=str(tmp_path / "torch"))
    pj = jfield.init_field_params(jax.random.PRNGKey(3), jt.static)
    key = "hash_table" if "hash_table" in pj else next(k for k in pj if "table" in k)
    pj[key] = jnp.asarray(np.random.default_rng(3).uniform(-2.0, 2.0, pj[key].shape)
                          .astype(np.float32))
    jt.state = jt.state._replace(ema_params=pj)
    tt.state.ema_params = params_from_jax(params_np(pj))
    grids = {}

    def keep(name, fn):
        def wrapped(u, threshold):
            grids[name] = np.array(torch.as_tensor(u).numpy() if name == "torch" else u)
            return fn(u, threshold)
        return wrapped

    monkeypatch.setattr(jmesh, "marching_tets", keep("jax", jmesh.marching_tets))
    monkeypatch.setattr(ttrainer, "marching_tets", keep("torch", tmesh.marching_tets))
    thr = 1.05
    pj_path = jt.save_mesh(resolution=32, threshold=thr)
    pt_path = tt.save_mesh(resolution=32, threshold=thr)
    assert pt_path.endswith("meshes/testname_ep0000.obj")
    assert set(tt.mesh_seconds) == {"query", "extract", "write"}
    uj, ut = grids["jax"], grids["torch"]
    assert uj.shape == ut.shape == (32, 32, 32)
    assert ((uj > thr).mean() > 0.01) and ((uj < thr).mean() > 0.01)
    np.testing.assert_allclose(ut, uj, rtol=1e-5, atol=1e-6)
    # JAX's grid through the port's extraction and writer -> JAX's file
    v, t_ = tmesh.marching_tets(torch.from_numpy(uj), thr)
    out = tmp_path / "port_of_jax_grid.obj"
    tmesh.write_obj(str(out), tmesh.to_world(v, [-1.0] * 3, [1.0] * 3, 32), t_)
    with open(pj_path, "rb") as f:
        jax_bytes = f.read()
    assert len(t_) > 100 and out.read_bytes() == jax_bytes
    # and a .ply by suffix
    ply = tt.save_mesh(path=str(tmp_path / "m.ply"), resolution=8, threshold=thr)
    with open(ply, "rb") as f:
        assert f.read(4) == b"ply\n"
