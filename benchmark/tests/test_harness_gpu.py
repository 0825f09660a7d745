"""On the card: the tiny cells through the graphed training window and the
card's render; the reference follows the trainer's draws across the
capture and the replays.  Run there with
`python3 -m pytest benchmark/tests/test_harness_gpu.py -p no:cacheprovider -o addopts=""`."""

import pytest
import torch

from benchmark.tests.tiny_cells import run_tiny


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mocapDesk2_enerf.train", "spiral1_nerf.train",
                                  "spiral1_nerf.render"])
def test_tiny_cells_are_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run_tiny(name, seed=2 ** 31 + 77, seconds=1.0, trace=True, device="cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
