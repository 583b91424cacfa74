"""The program's own spans and counters (``m3d_torch/trace.py``) in the
traced run, for the per-layer metrics that read them.

The harness gives a reader no hook before its profiled batches, so this
module turns the program's tracing on when it is first imported, and that
is the one place it is turned on. The harness imports it through the first
reader it loads, and it loads every reader of the cell in
``trace_batches``, to gather their ``CAPTURE`` lists, after the window and
just before the profiled batches: so the program records those batches
and nothing of the window. ``calls(run)`` takes the records into
``run.program`` and turns tracing off; it refuses (None: the metrics are
left out) unless exactly the profiled batches were recorded, so a harness
that loaded its readers earlier or later would show as missing metrics,
not as wrong ones. It serves one traced run a process, as
``perfbench/run.py`` makes. A test
(``perfbench/tests/test_perfbench_program_trace.py``) holds the order:
tracing off through the warm-up and the window, on through the profiled
batches, off after.

The profiled batches run under ``torch.profiler``, whose host overhead
lengthens host-bound stretches: host times read here are those batches',
longer than the window's, and are set beside the same batches' device
time, not beside ``stage_ms.*``.

A program without ``m3d_torch.trace`` records nothing and the metrics are
left out. The untraced run (``--trace 0``) loads no per-layer reader, so
the program's tracing stays off there.
"""

from __future__ import annotations


def _trace():
    try:
        from m3d_torch import trace
    except ImportError:
        return None
    return trace


if _trace() is not None:
    _trace().enable()


def calls(run) -> list | None:
    """Each recorded inference call (root span ``infer``) summed by span
    name (``m3d_torch.trace.totals``); None where the program records
    nothing, or where the records are not one a profiled batch."""
    t = _trace()
    if t is None:
        return None
    t.disable()
    if getattr(run, "program", None) is None:
        run.program = t.take()
    found = [t.totals(c) for c in run.program["calls"] if c["name"] == "infer"]
    profiled = getattr(run.trace, "batches", None)
    if not found or run.program["dropped"] or len(found) != profiled:
        return None
    return found


def mean(run, value) -> float | None:
    """Mean over the recorded calls of ``value(totals)``; None where no
    call has a value."""
    per = [value(c) for c in calls(run) or ()]
    per = [v for v in per if v is not None]
    return sum(per) / len(per) if per else None


def stage_host_ms(run, stage: str) -> float | None:
    """Mean host ms a call spends in the ``stage`` spans, less the host's
    waits in their reads and table copies."""
    return mean(run, lambda c: c[stage]["host_ms"] - c[stage]["wait_ms"]
                if stage in c else None)


def counter(run, stage: str, name: str) -> float | None:
    """Mean of the ``stage`` spans' counter ``name`` a call."""
    return mean(run, lambda c: c[stage]["counters"].get(name, 0)
                if stage in c else None)


def rows_useful_pct(run, stage: str) -> float | None:
    """100 x the ``stage`` spans' ``rows.live`` over their
    ``rows.computed``, over every recorded call."""
    found = [c[stage]["counters"] for c in calls(run) or () if stage in c]
    computed = sum(c.get("rows.computed", 0) for c in found)
    if not computed:
        return None
    return 100.0 * sum(c.get("rows.live", 0) for c in found) / computed
