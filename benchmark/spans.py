"""Device time by layer from the program's span registry
(enerf_torch.utils.profiling.snapshot): each span path's instance count,
instances replayed in a CUDA graph, and device seconds between the marks
the span launches on the card.  A program without the registry, a run
off the card, or a span that did not run gives None.

Training readers take the graphed instances of paths that start at the
span `step` (the captured step, whose paths start at the capture; set-up's
steps after the first and the window replay it), not the eager first step
of a capture (under `window.warmup`), nor calls with no `step` above them
(the hash-grid probe's after the window); a path some of whose instances
ran eagerly is not split, and reads None.  The render reader takes the
instances with `render.view` above them.
"""


def snapshot():
    try:
        from enerf_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else None


def device_s(snap, name, under):
    """Device seconds of the span `name` on the paths `under(parts)` accepts;
    None where there is none, or one has no device time."""
    found = [s for p, s in snap["spans"].items()
             if p.split("/")[-1] == name and under(p.split("/"))]
    if not found or any(s["device_s"] is None for s in found):
        return None
    return sum(s["device_s"] for s in found)


def step_ms(name):
    """ms a step of the span `name` inside the captured training step."""
    snap = snapshot()
    if not snap:
        return None
    step = snap["spans"].get("step")
    inside = [s for p, s in snap["spans"].items() if p.split("/")[0] == "step"]
    if not step or any(not s["graphed"] or s["count"] != s["graphed"] for s in inside):
        return None
    secs = device_s(snap, name, lambda parts: parts[0] == "step")
    return None if secs is None else 1e3 * secs / step["graphed"]


def view_ms(name, run):
    """ms a view of the window's size of the span `name` under
    `render.view`: its device time over the rays rendered (counter
    `render.rays`, set-up's partial view included), times the view's
    pixels."""
    snap, sizes = snapshot(), run.window.get("view_sizes")
    if not snap or not sizes:
        return None
    rays = snap["counters"].get("render.rays")
    secs = device_s(snap, name, lambda parts: "render.view" in parts[:-1])
    if not rays or secs is None:
        return None
    H, W = sizes[0]
    return 1e3 * secs * H * W / rays
