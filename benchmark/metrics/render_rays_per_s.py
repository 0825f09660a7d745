"""Rays of the views finished in the window over the window's seconds."""


def read(run):
    w = run.window
    return w["rays"] / w["seconds"] if w.get("views") else None
