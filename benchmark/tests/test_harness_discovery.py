"""Cells, configurations, dataset kinds, traffic mixes, drivers and metric
readers are found by name; a later change adds them as new files and
BENCHMARK.json entries, editing no file that is there."""

import json
import shutil

import pytest

from benchmark import harness, named
from benchmark.tests.tiny_cells import tiny_cell

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = harness.Cell(BENCH, name)
    for attr in ("Driver", "control", "program_seconds"):
        assert hasattr(cell.driver, attr), (cell.traffic["driver"], attr)
    assert hasattr(named.module("inputs", cell.config_file["data"]["kind"]), "make")
    assert cell.config_file["name"] == cell.workload["config"]
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(harness.reader(m["name"]), "read"), m["name"]
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_every_named_file_exists_and_nothing_else_is_needed():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        base = m["name"].rsplit(".", 1)[0]
        assert any(named.path("metrics", n).exists() for n in (m["name"], base)), m["name"]


def test_a_reader_serves_its_suffixed_names():
    assert harness.reader("device_idle_pct.train") is harness.reader("device_idle_pct.render")
    assert harness.reader("step_mfu.train") is not harness.reader("step_mfu.render")
    with pytest.raises(KeyError):
        harness.reader("no_such_metric.train")


NEW_KIND = """
from benchmark import named


def make(data, cfg, rng, split="train"):
    out = named.module("inputs", "esim").make(data, cfg, rng, split)
    out["images"] = out["images"] * data["dim"]
    return out
"""

NEW_DRIVER = """
from benchmark import named

base = named.module("drivers", "train_window")
control, program_seconds = base.control, base.program_seconds


class Driver(base.Driver):
    def window(self, seconds):
        super().window(seconds)
        self.run.spans["new_driver"] = 1.0
"""


def test_a_new_cell_kind_config_mix_driver_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    # a new kind of dataset, configuration, driver, mix, limits and
    # per-layer metric (read under a suffixed name), each a file of its own
    (root / "benchmark/inputs/esim_dim.py").write_text(NEW_KIND)
    cfg = json.loads((root / "benchmark/configs/spiral1_nerf.json").read_text())
    cfg["name"] = "spiral2_nerf"
    cfg["data"].update(kind="esim_dim", dim=0.5)
    (root / "benchmark/configs/spiral2_nerf.json").write_text(json.dumps(cfg))
    (root / "benchmark/drivers/train_window_marked.py").write_text(NEW_DRIVER)
    mix = json.loads((root / "benchmark/traffic/train.json").read_text())
    mix.update(driver="train_window_marked", check_steps=2)
    (root / "benchmark/traffic/train_short.json").write_text(json.dumps(mix))
    shutil.copy(root / "benchmark/limits/spiral1_nerf.train.json",
                root / "benchmark/limits/spiral2_nerf.train_short.json")
    (root / "benchmark/metrics/steps_done.py").write_text(
        "def read(run):\n    return float(run.window['steps']) + run.spans['new_driver']\n")
    bench["configs"].append({"name": "spiral2_nerf", "source": "https://example.org/spiral2",
                             "file": "benchmark/configs/spiral2_nerf.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "spiral2_nerf.train_short", "config": "spiral2_nerf",
                               "traffic": "train_short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_done.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "training window",
                               "moves": "train_steps_per_s",
                               "workloads": ["spiral2_nerf.train_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before  # nothing that was there changed
    cell = tiny_cell("spiral2_nerf.train_short", root)
    assert cell.traffic["check_steps"] == 2
    r = harness.run_cell(cell, 4, 0.3, True, "cpu")
    assert r["metrics"]["steps_done.train"]["value"] >= 2
    assert r["correct"] and len(r["checks"]) == 3
    # the new kind made the inputs: its frames are the esim frames dimmed
    from benchmark import data
    dim = data.make_inputs(cell.config_file["data"], cell.cfg, 4, "train", root)["images"]
    plain = named.module("inputs", "esim").make(
        cell.config_file["data"], cell.cfg, __import__("numpy").random.default_rng(
            data.seed_sequence(4, 0)), "train")["images"]
    assert abs(dim - 0.5 * plain).max() == 0
