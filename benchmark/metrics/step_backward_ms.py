"""The step's backward (loss.backward(), the encode's table VJP in it):
device ms a step of the span `step.backward` in the captured step
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.step_ms("step.backward")
