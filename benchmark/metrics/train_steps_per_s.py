"""Training steps completed in the window over the window's seconds."""


def read(run):
    w = run.window
    return w["steps"] / w["seconds"] if w.get("steps") else None
