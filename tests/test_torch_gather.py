"""K3 (the 8-row group gather) on the CPU: its plain version against the JAX
benchmark's own Pallas kernel, run in interpret mode, and the port's gather
benchmark at a tiny size.  K3 itself is held on the card by
tests/test_torch_kernels.py and chip_smoke.py."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_parity import n, t

from enerf_torch.ops import group_gather as gg
from enerf_torch.tools import bench_gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_gather", os.path.join(REPO, "scripts", "bench_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_version_equals_jax_pallas_kernel(monkeypatch):
    """make_group_gather's Pallas kernel (interpret mode on the CPU), jnp.take
    of the groups' rows and the port's plain version agree bit for bit."""
    mod = _jax_bench()
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    TG, D, MG = 64, 128, 1024
    rng = np.random.default_rng(0)
    table = rng.normal(size=(TG * 8, D)).astype(np.float32)
    gidx = rng.integers(0, TG, MG).astype(np.int32)
    got_j = np.asarray(mod.make_group_gather(TG, D, MG, W=4)(jnp.asarray(gidx),
                                                            jnp.asarray(table)))
    rows = (gidx[:, None] * 8 + np.arange(8)[None, :]).reshape(-1)
    take = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(rows), axis=0))
    launches = gg.group_gather.launches
    got_t = n(gg.group_gather(t(gidx), t(table)))
    assert gg.group_gather.launches == launches  # CPU: the plain version
    assert got_t.shape == (MG * 8, D)
    np.testing.assert_array_equal(got_t, got_j)
    np.testing.assert_array_equal(got_t, take)
    np.testing.assert_array_equal(n(gg.group_gather_reference(t(gidx), t(table))), take)


@pytest.mark.parametrize("d", [1, 3, 250])
def test_plain_version_any_width(d):
    """Every row width, the block-grid table's 250 included."""
    rng = np.random.default_rng(d)
    table = rng.normal(size=(96, d)).astype(np.float32)
    gidx = rng.integers(0, 12, 40).astype(np.int32)
    rows = (gidx[:, None] * 8 + np.arange(8)[None, :]).reshape(-1)
    np.testing.assert_array_equal(n(gg.group_gather(t(gidx), t(table))), table[rows])


def test_wrapper_refuses_what_the_kernel_cannot_take():
    table, gidx = torch.zeros(64, 4), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        gg.group_gather(gidx, table.double())
    with pytest.raises(TypeError):
        gg.group_gather(gidx.long(), table)
    with pytest.raises(ValueError):
        gg.group_gather(gidx, torch.zeros(60, 4))  # rows not a multiple of 8
    with pytest.raises(ValueError):
        gg.group_gather(gidx, table.t())  # not contiguous
    for w in (0, 33):
        with pytest.raises(ValueError):
            gg.group_gather(gidx, table, windows=w)
    with pytest.raises(ValueError):
        gg.launch_kernel(gidx, table)  # the kernel needs CUDA tensors


def test_bench_gather_cpu_prints_every_variant(capsys):
    res = bench_gather.main(["--device", "cpu", "--rows", "1030", "--m", "2048",
                             "--d", "16", "250", "--windows", "4", "8"])
    out = capsys.readouterr().out
    variants = ["index_select random", "index_select sorted(+sortcost)", "index_add_ random",
                "group_gather8 W= 4 random", "group_gather8 W= 8 random"]
    assert [r["variant"] for r in res] == variants * 2
    assert [r["D"] for r in res] == [16] * 5 + [250] * 5
    for r in res:
        assert r["seconds"] > 0 and r["gb_per_s"] > 0
    lines = [ln for ln in out.splitlines() if ln.startswith("D=")]
    assert len(lines) == 10 and all("GB/s" in ln and "rows/s" in ln for ln in lines)
    assert sum("exact=True" in ln for ln in lines) == 4


def test_bench_gather_raises_when_k3_differs(monkeypatch):
    """The benchmark does not swallow a failed check (the JAX script does)."""
    monkeypatch.setattr(bench_gather, "check_exact", lambda *a: False)
    with pytest.raises(AssertionError, match="differs"):
        bench_gather.main(["--device", "cpu", "--rows", "64", "--m", "64", "--d", "4",
                           "--windows", "4"])
