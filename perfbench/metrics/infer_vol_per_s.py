"""Volumes whose outputs reached the host in the window, over the window's
seconds (host clock; the window runs from the first batch's dispatch to the
last batch's outputs on the host)."""


def read(run):
    return run.volumes / run.window_s if run.window_s > 0 else None
