"""The hash-grid encode's forward (span `encode.fwd`, the program's
_HashEncode.forward) as the window ran it: device ms a step in a training
cell (both renders of the captured step, under `step`), device ms a view
in a render cell (under `render.view`) (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    if run.window.get("steps"):
        return spans.step_ms("encode.fwd")
    return spans.view_ms("encode.fwd", run)
