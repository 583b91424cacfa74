"""Share of the traced batches' window (first dispatch to last outputs on
the host) in which no operation ran on the card, from the profiler's
device timeline."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
