"""The hash-grid encode's table VJP (span `encode.bwd`, the program's
_HashEncode.backward) in the captured training step: device ms a step
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.step_ms("encode.bwd")
