"""The training window's first call: its first step, run eagerly, and the
capture of the step's CUDA graph."""


def read(run):
    return run.spans.get("capture")
