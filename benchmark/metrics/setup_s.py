"""Process start to the first timed step: imports, inputs, the program's
load, the trainer, the first steps and the capture (or the warm-up)."""


def read(run):
    return run.setup_s
