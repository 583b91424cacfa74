"""Mean milliseconds per window batch of the mask stage, from CUDA events
the benchmark records around the program's own stage calls (traced run
only; perfbench/entries/<entry>.py names the calls)."""

STAGE = "mask"


def read(run):
    if run.spans is None or not run.spans.per_batch.get(STAGE):
        return None
    ms = run.spans.per_batch[STAGE]
    return sum(ms) / len(ms)
