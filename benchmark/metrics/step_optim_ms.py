"""The step's Adam + EMA update (TrainState.apply_updates): device ms a
step of the span `step.optim` in the captured step (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.step_ms("step.optim")
