"""Operation and byte counts of the benchmark's work, from the
configuration's shapes alone, whatever implements them.

Model operations are the MLPs' matrix products: 2 x in x out a sample for
each layer (sigma 32 -> 64 -> 16, colour 31 -> 64 -> 64 -> C); a training
sample costs three times its forward (the backward takes the products
for the inputs' and the weights' gradients).  The hash grid's blend, the
SH encoding and the compositing are not model operations: the encode's
own arithmetic is counted in `encode_flops`, for its roofline.

The hash-grid encode's bytes follow the roofline rule: each input read
once (positions [N, 3] f32, the whole table), the output [N, L x C] f32
written once.  Its operations a sample and level: the scaled position
(D multiply-adds), the fraction (D), the weights' 1 - f (D), the corner
weights (2^D x (D - 1) products) and the blend (2^D x C multiply-adds).
"""

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name):
    """The peak table's row for this card, or None for a card it lacks."""
    return json.loads(PEAKS.read_text()).get(device_name)


def mlp_layers(cfg):
    G, Hs, Hc = cfg["geo_feat_dim"], cfg["hidden_dim"], cfg["hidden_dim_color"]
    enc = cfg["num_levels"] * cfg["level_dim"]
    return [(enc, Hs), (Hs, 1 + G), (16 + G, Hc), (Hc, Hc), (Hc, cfg["out_dim_color"])]


def forward_flops_per_sample(cfg):
    return sum(2 * i * o for i, o in mlp_layers(cfg))


def samples_per_step(cfg):
    """Samples a training step renders: two renders of each event pair,
    or one of each frame ray."""
    if cfg["events"]:
        return 2 * cfg["batch_size_evs"] * cfg["num_steps"]
    return cfg["num_rays"] * cfg["num_steps"]


def train_step_flops(cfg):
    return 3 * forward_flops_per_sample(cfg) * samples_per_step(cfg)


def view_flops(cfg, H, W):
    return forward_flops_per_sample(cfg) * H * W * cfg["num_steps"]


def encode_flops(n, levels, level_dim, dims=3):
    corners = 2 ** dims
    per_level = 2 * dims + dims + dims + corners * (dims - 1) + 2 * corners * level_dim
    return n * levels * per_level


def encode_bytes(n, table_rows, levels, level_dim, dims=3):
    return 4 * (n * dims + table_rows * level_dim + n * levels * level_dim)


def encode_roofline_s(n, table_rows, levels, level_dim, peak):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the float32 peak (the encode runs in
    float32)."""
    return max(encode_bytes(n, table_rows, levels, level_dim) / peak["hbm_bytes_per_s"],
               encode_flops(n, levels, level_dim) / peak["fp32_flops"])
