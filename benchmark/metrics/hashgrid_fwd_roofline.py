"""The hash-grid encode's forward (the program's hash_encode) on one
render's samples (the training step's, or a view's chunk): its least time
by the roofline over its device time in the profiler's trace, in %; read
only where the window's trace holds every kernel it launches (probes.py)."""

from benchmark import probes, work


def probe(run):
    probes.encode(run)


def read(run):
    enc = run.probes.get("encode")
    peak = work.peaks(run.device_name)
    if not enc or peak is None:
        return None
    least = work.encode_roofline_s(enc["samples"], enc["rows"], run.cfg["num_levels"],
                                   run.cfg["level_dim"], peak)
    return 100.0 * least / enc["seconds"]
