"""The result line's shape, and the run's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny_cells import run_tiny, tiny_cell

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_result_has_the_contract_keys(name, trace):
    r = run_tiny(name, trace=trace)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"  # the numbers compared come last
    assert ("breakdown" in r) == trace
    if trace:
        assert len(r["breakdown"]["device_ops"]) <= 10 >= len(r["breakdown"]["idle_gaps"])
        assert r["device"]["window_s"] > 0
    assert r["attempted"] >= 1 and r["failed"] == 0
    cell = tiny_cell(name)
    wanted = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    for k, v in r["metrics"].items():
        assert v["unit"] == units[k] and v["value"] == v["value"]
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(r))


def run_py(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = run_py(["--workload", "spiral1_nerf.train", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                "--trace", "0"], harness.ROOT, env)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    p = run_py(["--workload", "spiral1_nerf.train", "--seed", "1", "--seconds", "1",
                "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()
