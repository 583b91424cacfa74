"""Spans and counters of the inference path.

Tracing is off by default, and then ``span``, ``count``, ``waits`` and
``host_read`` check one module flag and record nothing: no profiler range,
no CUDA event, no host read. ``enable()`` turns it on for the process,
``take()`` returns the finished calls' records and clears them, and
``disable()`` turns it off. One thread records at a time.

With tracing on, ``span(name)`` records its name, its parent's name, the
call it belongs to and the host clock at open and close. A call is the
outermost open span: ``adaptive_inference`` and ``MaskRCNN.forward`` open
``infer``. The outermost span and the stage spans (``STAGES``) also record
a CUDA event pair where the call runs on a card (the ``device`` the
outermost span was given). A span opened inside an
open span of the same name records nothing, so a stage reached through two
entry functions is counted once. While a ``torch.profiler`` is active, a
span also opens the range ``m3d.<name>`` and a host wait ``m3d.read.<site>``:
the profiler's trace then names the program's stages and waits. Under
``torch.export`` or ``torch.compile`` nothing records and no range opens,
so a graph traced with tracing on is the graph traced with it off.

``count(name, n)`` adds ``n`` to a counter of the innermost open stage span
(of the call's outermost span where no stage is open). ``n`` may be a
device tensor, whose elements are summed in ``take()``, after the call:
counting adds no host read and no device work to the call.
``host_read(x, site)`` is how the inference path reads a device value on
the host, and ``waits(site)``
marks a block that waits for the device's queue (a table built on the host
and copied to the card, under the site ``table.<function>``). With tracing
on both count the wait under ``host_reads`` and ``host_reads.<site>``,
and add its host time to the ``wait`` of every open span.

``span(name, into=d)`` times its block whether tracing is on or off and
adds the seconds to ``d[name]``: the device seconds between two CUDA events
where ``device`` is a card, else host seconds, where ``sync=True`` first
waits for the card. Evaluation and target generation keep their per-image
stage times with it.
"""

from __future__ import annotations

import contextlib
import time

import torch

STAGES = frozenset(("trunk", "proposals", "classifier", "detection", "mask"))
MAX_CALLS = 1024    # finished calls kept until take(); later ones are dropped

_on = False


_NOOP = contextlib.nullcontext()


class _Store:
    """The process's open spans and finished calls."""

    def __init__(self):
        self.stack: list = []
        self.calls: list = []
        self.dropped = 0
        self.next_id = 0


_store = _Store()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def _in_graph() -> bool:
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "device", "into", "sync", "record", "parent", "root",
                 "counted", "events", "range", "t0", "host_ns",
                 "wait_ns", "counters", "tensors", "spans", "id")

    def __init__(self, name, device, into, sync, record):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.into = into
        self.sync = sync
        self.record = record
        self.events = self.range = None
        self.wait_ns = 0
        self.counters: dict = {}
        self.tensors: list = []

    def __enter__(self):
        st = _store
        self.parent = st.stack[-1] if self.record and st.stack else None
        if self.parent is not None:
            self.root = self.parent.root
            if self.device is None:
                self.device = self.parent.device
        else:
            self.root = self
        self.counted = self.record and (self.parent is None
                                        or self.name in STAGES)
        cuda = self.device is not None and self.device.type == "cuda"
        if cuda and (self.counted or (self.into is not None
                                      and not self.sync)):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        if self.record:
            if self.parent is None:
                self.id = st.next_id
                st.next_id += 1
                self.spans = []
            if _profiling():
                self.range = torch.autograd.profiler.record_function(
                    f"m3d.{self.name}")
                self.range.__enter__()
            st.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.record:
            if self.range is not None:
                self.range.__exit__(None, None, None)
            _store.stack.remove(self)
            self.root.spans.append(self)
            if self.parent is None:
                if len(_store.calls) < MAX_CALLS:
                    _store.calls.append(self)
                else:
                    _store.dropped += 1
        if self.into is not None:
            if self.sync and self.device is not None \
                    and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                t1 = time.perf_counter_ns()
            if self.events is not None and not self.sync:
                self.events[1].synchronize()
                secs = self.events[0].elapsed_time(self.events[1]) / 1e3
            else:
                secs = (t1 - self.t0) / 1e9
            self.into[self.name] = self.into.get(self.name, 0.0) + secs
        self.host_ns = t1 - self.t0
        return False


def span(name: str, *, device=None, into: dict | None = None,
         sync: bool = False):
    """A context manager around one stage or part of one (see the module
    docstring). ``device``: where the call runs (spans inside inherit it);
    ``into``, ``sync``: the timer form."""
    if not _on and into is None:
        return _NOOP
    if _in_graph():
        return _NOOP
    record = _on and all(s.name != name for s in _store.stack)
    if not record and into is None:
        return _NOOP
    return _Span(name, device, into, sync, record)


def _counted_span():
    for s in reversed(_store.stack):
        if s.counted:
            return s
    return None


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or a tensor whose elements are summed in
    ``take()``) to the counter ``name`` of the innermost open stage span."""
    if not _on or _in_graph():
        return
    s = _counted_span()
    if s is None:
        return
    if isinstance(n, torch.Tensor):
        s.tensors.append((name, n.detach()))
    else:
        s.counters[name] = s.counters.get(name, 0) + n


class _Wait:
    __slots__ = ("site", "range", "t0")

    def __init__(self, site):
        self.site = site

    def __enter__(self):
        self.range = None
        if _profiling():
            self.range = torch.autograd.profiler.record_function(
                f"m3d.read.{self.site}")
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(None, None, None)
        for s in _store.stack:
            s.wait_ns += dt
        s = _counted_span()
        if s is not None:
            c = s.counters
            for k in ("host_reads", f"host_reads.{self.site}"):
                c[k] = c.get(k, 0) + 1
        return False


def waits(site: str):
    """A context manager around a block that waits for the device's queue
    (a host read, a table copied to the card)."""
    if not _on or _in_graph():
        return _NOOP
    return _Wait(site)


def host_read(x: torch.Tensor, site: str):
    """``x.item()``: a device value read on the host, counted and timed
    under ``site`` with tracing on."""
    with waits(site):
        return x.item()


def take() -> dict:
    """The finished calls since the last ``take()``, oldest first, and how
    many were dropped past ``MAX_CALLS``; clears them. Each call is
    ``{"id", "name", "spans"}``; each span ``{"name", "parent", "host_ms",
    "wait_ms", "device_ms", "counters"}`` (spans in the order they closed;
    ``device_ms`` None without events)."""
    calls, dropped = _store.calls, _store.dropped
    _store.calls, _store.dropped = [], 0
    out = []
    for root in calls:
        spans = []
        for s in root.spans:
            counters = dict(s.counters)
            for k, t in s.tensors:
                counters[k] = counters.get(k, 0) + t.sum().item()
            device_ms = None
            if s.events is not None:
                s.events[1].synchronize()
                device_ms = s.events[0].elapsed_time(s.events[1])
            spans.append({"name": s.name,
                          "parent": None if s.parent is None
                          else s.parent.name,
                          "host_ms": s.host_ns / 1e6,
                          "wait_ms": s.wait_ns / 1e6,
                          "device_ms": device_ms, "counters": counters})
        out.append({"id": root.id, "name": root.name, "spans": spans})
    return {"calls": out, "dropped": dropped}


def totals(call: dict) -> dict:
    """One call's spans summed by name: ``{name: {"spans", "host_ms",
    "wait_ms", "device_ms", "counters"}}`` (``device_ms`` None where no span
    of the name had events)."""
    out: dict = {}
    for s in call["spans"]:
        t = out.setdefault(s["name"], {"spans": 0, "host_ms": 0.0,
                                       "wait_ms": 0.0, "device_ms": None,
                                       "counters": {}})
        t["spans"] += 1
        t["host_ms"] += s["host_ms"]
        t["wait_ms"] += s["wait_ms"]
        if s["device_ms"] is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + s["device_ms"]
        for k, v in s["counters"].items():
            t["counters"][k] = t["counters"].get(k, 0) + v
    return out
