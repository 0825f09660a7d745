"""The step's batch (the provider's train_step_batch, its error-map cells
and the noise draw): device ms a step of the span `step.batch` in the
captured step (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.step_ms("step.batch")
