"""The port's training-step benchmark (enerf_torch/tools/bench.py, the
counterpart of the repo's bench.py) on the CPU at a tiny size: its control
flow and its JSON lines (CPU rates mean nothing; the card's are PERF.md's)."""

import json

import pytest

import torch_parity  # noqa: F401  (one intra-op thread per xdist worker)

from enerf_torch.tools import bench


@pytest.mark.parametrize("share", ["1", "0"])
def test_bench_march_step_runs_on_cpu(capsys, share):
    lines = bench.main(["--device", "cpu", "--n_rays", "48", "--num_samples", "8",
                        "--num_levels", "2", "--level_dim", "2", "--grid_block", "4",
                        "--iters", "1", "--share_march", share])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["metric"] == "rays_per_s_per_chip_fwd_bwd_1024steps"
    assert printed["unit"] == "rays/s" and printed["value"] > 0 and printed["device"] == "cpu"
    assert printed == json.loads(json.dumps(lines))
    # the plain march on CPU tensors: no kernel, its host syncs counted
    assert printed["march_launches_per_step"] == 0 and printed["march_host_syncs_per_step"] > 0


def test_bench_fixed_steps_print_one_line_each(capsys):
    bench.main(["--device", "cpu", "--mode", "fixed", "--fixed_steps", "4", "8",
                "--fixed_rays", "16", "8", "--iters", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["metric"] for x in lines] == ["rays_per_s_per_chip_fwd_bwd_fixed4steps",
                                            "rays_per_s_per_chip_fwd_bwd_fixed8steps"]
    assert all(x["value"] > 0 for x in lines)
    with pytest.raises(ValueError, match="one ray count"):
        bench.main(["--device", "cpu", "--mode", "fixed", "--fixed_steps", "4", "8",
                    "--fixed_rays", "16", "--iters", "1"])
