"""The step's forward (the renders: renderer, field, encode; and the
loss): device ms a step of the span `step.forward` in the captured
step (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.step_ms("step.forward")
