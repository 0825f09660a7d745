"""The operation and byte counts against hand counts."""

import json

from benchmark import harness, work


def cfg_of(name):
    return harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), name).cfg


def test_mlp_forward_flops_by_hand():
    # sigma 32x64 + 64x16, colour 31x64 + 64x64 + 64x1, two operations a product
    cfg = cfg_of("mocapDesk2_enerf.train")
    assert work.forward_flops_per_sample(cfg) == 2 * (32 * 64 + 64 * 16 + 31 * 64 + 64 * 64 + 64)


def test_step_and_view_flops_by_hand():
    ev, fr = cfg_of("mocapDesk2_enerf.train"), cfg_of("spiral1_nerf.train")
    f = 18432
    assert work.train_step_flops(ev) == 3 * f * 2 * 20096 * 512
    assert work.train_step_flops(fr) == 3 * f * 30096 * 512
    assert work.view_flops(fr, 480, 640) == f * 480 * 640 * 512


def test_encode_counts_at_a_small_shape():
    # 10 samples, 2 levels of 2 channels, a table of 100 rows: positions
    # 10 x 3, table 100 x 2, output 10 x 4, each 4 bytes
    assert work.encode_bytes(10, 100, 2, 2) == 4 * (30 + 200 + 40)
    # a level: 6 (scale, offset) + 3 (fraction) + 3 (1 - f) + 8 x 2 (weights)
    # + 8 x 2 x 2 (blend) = 60
    assert work.encode_flops(10, 2, 2) == 10 * 2 * 60
    peak = {"hbm_bytes_per_s": 1e3, "fp32_flops": 1e3}
    assert work.encode_roofline_s(10, 100, 2, 2, peak) == max(1080 / 1e3, 1200 / 1e3)


def test_the_peak_table_has_the_card():
    p = work.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert work.peaks("some other card") is None
    assert json.loads(work.PEAKS.read_text())
