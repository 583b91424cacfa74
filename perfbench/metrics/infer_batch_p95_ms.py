"""95th percentile of every window batch's milliseconds from dispatch until
its detections and masks are on the host (host clock)."""

import statistics


def read(run):
    if len(run.batch_ms) < 2:
        return None
    return statistics.quantiles(run.batch_ms, n=20)[18]
