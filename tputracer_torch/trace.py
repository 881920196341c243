"""Spans and counters: where the port's host time goes, and what it moved.

``with span("graphs.copy_in") as rec: ...; rec.add(bytes=n)`` times a
stretch of the program on the host's clock (``time.perf_counter_ns``) and
keeps a :class:`Record` of it: its name, its id, the id of the span
around it (its parent, 0 for none), the id of the outermost span around
it (its request's root: one ``api.render`` call, one fit step), its start
and end, its counts, and where a span has one its device time in
milliseconds (``device``).

Records go into a ring per name that keeps the newest :data:`RING`, in
one of two bins: *traced*, the records of spans that started while a
``torch.profiler`` was running, and *untraced*, all others.  While a
profiler runs, each span also opens
``torch.profiler.record_function("tputracer.<name>")``, so its interval
lies on the profiler's host timeline beside the device's ops, on the
same clock; with no profiler running no ``record_function`` is made, and
a span costs a flag check, two clock reads and an append.

A :func:`phase` is a span that can also be timed on the device inside a
CUDA graph: while a graph is captured (:func:`capturing`), each phase
brackets its work with two external event nodes (one, where it opens on
the closing node of the phase before it), and each replay of the graph
can then read its device milliseconds (:func:`phase_ms`).  Outside
a capture a phase is a plain span, and a graph whose capture ran no
phase holds no such nodes.

A :func:`device_count` hands a capture a number the device computes (a
count of live lanes, say) without a sync: inside :func:`counting` it
copies the tensor's values into the capture's pinned host buffer, one
device-to-host copy node in the graph, and each replay's record can read
them once the replay is done (:func:`count_values`).  Outside a capture
it does nothing.

There is no exporter: ``cli.py --profile`` writes the profiler's trace,
which holds the spans, and a caller in the process reads the records
with :func:`records`.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _profiler

# the records kept of each name in each bin, newest last
RING = 65_536
PREFIX = "tputracer."

_BINS = ({}, {})              # untraced, traced: name -> deque of Records
_IDS = itertools.count(1)
_LOCAL = threading.local()    # .top: the thread's innermost open span;
                              # .phases: the capture's phases, or None;
                              # .counting: (host buffer, counted), or None
_clock = time.perf_counter_ns
# callables that fill in records whose device times came in late
SETTLERS: list = []


class Record:
    """One span, made by :func:`span`: times in ns on the host's
    ``perf_counter_ns`` clock, ``device`` None or {name: device ms}."""

    __slots__ = ("name", "id", "start_ns", "end_ns", "counts", "device",
                 "traced", "_up", "_fn")

    def __init__(self, name, **counts):
        self.name = name
        self.counts = counts
        self.device = None

    def add(self, **counts):
        """Add to the record's counts."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    @property
    def ms(self):
        """The span's host milliseconds."""
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def parent(self):
        """The id of the span around this one, 0 for none."""
        return 0 if self._up is None else self._up.id

    @property
    def root(self):
        """The id of the outermost span around this one (its own if
        none)."""
        rec = self
        while rec._up is not None:
            rec = rec._up
        return rec.id

    def __enter__(self):
        local = _LOCAL
        self._up = getattr(local, "top", None)
        local.top = self
        self.id = next(_IDS)
        if _profiler._is_profiler_enabled:
            self.traced = True
            self._fn = torch.profiler.record_function(PREFIX + self.name)
            self._fn.__enter__()
        else:
            self.traced = False
        self.start_ns = _clock()
        return self

    def __exit__(self, kind, value, tb):
        self.end_ns = _clock()
        if self.traced:
            self._fn.__exit__(kind, value, tb)
            self._fn = None
        _LOCAL.top = self._up
        rings = _BINS[self.traced]
        try:
            rings[self.name].append(self)
        except KeyError:
            rings[self.name] = deque([self], maxlen=RING)
        return False


# ``with span(name, **counts) as rec``: a Record of the enclosed stretch,
# its counts added to with ``rec.add``
span = Record


class Phase(Record):
    """A span that, inside a graph's capture (:func:`capturing`), records
    an external event on the capturing stream as it opens and another as
    it closes, and hands the pair to the capture.  Opened with ``after``,
    the record of a phase that closed before it in the same capture, it
    opens on that phase's closing event and records none of its own: the
    two share an event node, and work enqueued between them counts as
    this phase's."""

    __slots__ = ("_after", "_end")

    def __init__(self, name, after=None, **counts):
        super().__init__(name, **counts)
        self._after = after

    def __enter__(self):
        phases = getattr(_LOCAL, "phases", None)
        self._end = None
        if phases is not None:
            begin = getattr(self._after, "_end", None)
            if begin is None:
                begin = torch.cuda.Event(enable_timing=True, external=True)
                begin.record()
            self._end = torch.cuda.Event(enable_timing=True, external=True)
            phases.append((self.name, begin, self._end))
        self._after = None
        return super().__enter__()

    def __exit__(self, kind, value, tb):
        if self._end is not None:
            self._end.record()
        return super().__exit__(kind, value, tb)


# ``with phase(name, after=None, **counts) as rec``: a span whose work a
# CUDA graph captured around it can time on the device
phase = Phase


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured in this block: yields the list that
    collects the (name, begin, end) events of each :func:`phase` run in
    it, in the order they ran."""
    outer = getattr(_LOCAL, "phases", None)
    _LOCAL.phases = phases = []
    try:
        yield phases
    finally:
        _LOCAL.phases = outer


@contextlib.contextmanager
def counting(host):
    """While a CUDA graph is captured in this block: yields the list that
    collects each :func:`device_count` run in it, as (name, host number or
    slice of ``host``), ``host`` being a pinned float32 buffer."""
    outer = getattr(_LOCAL, "counting", None)
    counted = []
    _LOCAL.counting = (host, counted)
    try:
        yield counted
    finally:
        _LOCAL.counting = outer


def device_count(name, value):
    """Inside :func:`counting`: a device tensor's values, copied as
    float32 into the next slots of the capture's pinned buffer (a copy
    node in the graph, so each replay refills them), or a host number,
    counted under ``name``.  Outside it: nothing, and no sync."""
    state = getattr(_LOCAL, "counting", None)
    if state is None:
        return
    host, counted = state
    if isinstance(value, torch.Tensor):
        flat = value.detach().reshape(-1).to(torch.float32)
        start = sum(v.stop - v.start for _, v in counted
                    if isinstance(v, slice))
        if start + flat.numel() > host.numel():
            raise RuntimeError(f"device_count({name!r}): the capture's "
                               f"{host.numel()} counted values are taken")
        value = slice(start, start + flat.numel())
        host[value].copy_(flat, non_blocking=True)
    counted.append((name, value))


def count_values(host, counted):
    """{name: number, or list of numbers} of a replay's :func:`counting`
    list, summed over each name's entries (lists element by element);
    the replay must have completed."""
    out = {}
    for name, v in counted:
        x = host[v].tolist() if isinstance(v, slice) else v
        if name in out:
            y = out[name]
            x = [a + b for a, b in zip(y, x, strict=True)] \
                if isinstance(x, list) else y + x
        out[name] = x
    return out


def phase_ms(phases):
    """{name: device ms} of a replay's phases, summed over each name's
    event pairs; the events must have completed."""
    out = {}
    for name, begin, end in phases:
        out[name] = out.get(name, 0.0) + begin.elapsed_time(end)
    return out


def spanned(name):
    """A decorator: each call of the function inside a span of ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with Record(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def records(name, traced=False):
    """The kept records of ``name`` in the traced or untraced bin, oldest
    first; device times that have come in since are filled in first."""
    for settle in SETTLERS:
        settle()
    return list(_BINS[bool(traced)].get(name, ()))


def reset():
    """Forget every record (for tests)."""
    for b in _BINS:
        b.clear()
