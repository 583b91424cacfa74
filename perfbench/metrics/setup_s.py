"""Seconds from the start of the process to the first timed batch: the
pool of volumes, the model and its weights, kernel builds where the
checkout has none yet, and the warm-up batches (host clock)."""


def read(run):
    return run.setup_s
