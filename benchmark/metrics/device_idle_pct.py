"""The share of the traced window in which no kernel, copy or memset ran
on the card (the union of their intervals, from torch.profiler)."""


def read(run):
    t = run.trace
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
