"""The event provider's host pose precompute, by the program's own load
clock (EventProvider.load_seconds['poses'])."""


def read(run):
    return run.spans.get("pose_precompute")
