"""Host synchronisations with the card (stream, device and event syncs, as
the profiler records the runtime calls) inside the program's entry call,
per traced batch."""


def read(run):
    if run.trace is None or run.trace.batches == 0:
        return None
    return run.trace.syncs / run.trace.batches
