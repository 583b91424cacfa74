"""Spans and call capture that the benchmark puts around the program's own
calls, in the traced run only.

``StageSpans`` replaces each named stage (an attribute of a module or an
object: a method, or a function that another module calls by its module
global) with a wrapper that opens a ``record_function("stage.<name>")``
range and times the call: by CUDA events on the card (device time between
the call's first and last enqueue; host syncs inside count), by the host
clock elsewhere. ``Capture`` records the arguments of named calls. Both put
everything back on ``restore``.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class StageSpans:
    def __init__(self, targets, cuda: bool):
        """targets: (owner, attribute, stage name) triples."""
        self.cuda = cuda
        self.saved = []
        self.open = []          # (stage, start, end) of the current batch
        self.per_batch = defaultdict(list)
        for owner, attr, stage in targets:
            real = getattr(owner, attr)
            self.saved.append((owner, attr, owner.__dict__.get(attr, None),
                               attr in owner.__dict__))
            setattr(owner, attr, self._wrap(real, stage))

    def _wrap(self, real, stage):
        def span(*args, **kwargs):
            with torch.profiler.record_function(f"stage.{stage}"):
                if self.cuda:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = real(*args, **kwargs)
                    b.record()
                else:
                    a = time.perf_counter()
                    out = real(*args, **kwargs)
                    b = time.perf_counter()
            self.open.append((stage, a, b))
            return out
        return span

    def end_batch(self) -> None:
        """Close the batch (after its outputs reached the host): add each
        stage's ms."""
        sums = defaultdict(float)
        for stage, a, b in self.open:
            sums[stage] += a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        for stage, ms in sums.items():
            self.per_batch[stage].append(ms)
        self.open = []

    def restore(self) -> None:
        for owner, attr, value, own in reversed(self.saved):
            if own:
                setattr(owner, attr, value)
            else:
                delattr(owner, attr)


class Capture:
    """Records the positional arguments of ``module.name`` calls while
    ``on`` is set."""

    def __init__(self, targets):
        """targets: (module, function name) pairs."""
        self.on = False
        self.calls = defaultdict(list)
        self.saved = []
        for module, name in targets:
            real = getattr(module, name)
            self.saved.append((module, name, real))
            setattr(module, name, self._wrap(real, f"{module.__name__}."
                                             f"{name}"))

    def _wrap(self, real, key):
        def spy(*args):
            if self.on:
                self.calls[key].append(args)
            return real(*args)
        return spy

    def restore(self) -> None:
        for module, name, real in reversed(self.saved):
            setattr(module, name, real)
