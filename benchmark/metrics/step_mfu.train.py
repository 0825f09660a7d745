"""Model operations of the window's work over its seconds, as a share of
the card's dense bf16 peak (the precision the configuration states)."""

from benchmark import work


def read(run):
    peak = work.peaks(run.device_name)
    w = run.window
    if peak is None or not w.get("seconds"):
        return None
    flops = work.train_step_flops(run.cfg) * w["steps"]
    return 100.0 * flops / w["seconds"] / peak["bf16_flops"]
