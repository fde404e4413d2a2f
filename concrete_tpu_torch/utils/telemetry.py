"""Spans and counters of the port: where a request's host time goes.

Off by default; ``enable()`` and ``disable()`` switch it for the process.
A span marks one stage of the program (``pbs.keyswitch``, ``server.upload``,
``keygen.draws``, ...) with its name, an id, its parent's id, the id of the
request it serves, the rank, the thread, start and end on
``time.perf_counter_ns()``, and a few attributes.  The outermost
``Circuit.run`` or ``Server.run`` of a call opens a request id, which every
span under it carries, also on the dataflow scheduler's threads (its tasks
run in a copy of the submitter's ``contextvars`` context).  Counters add up
quantities at the same boundaries (``bytes.h2d``, ``bytes.d2h``: the
ciphertexts copied between host and card).  Spans stay in memory in a
bounded buffer that counts what it drops; ``snapshot()`` hands spans and
counters out, ``reset()`` empties both.

While tracing is on and a torch profiler runs, each span is also entered
as a ``record_function`` annotation of the same name: the profiler then
stamps it on its own clock, the device trace's, and links the kernels
launched inside it to it by correlation id.

A site costs one read of the module flag while tracing is off::

    with tm.span("pbs.keyswitch") if tm.on else tm.OFF:
        ...
    if tm.on:
        tm.count("bytes.h2d", t.nbytes)

No span synchronises the device or reads a tensor's value.  ``timed``
spans always read the clock, and record only while tracing is on: set-up
timings (``Keys.setup_seconds``) are their durations.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import threading
import time

import torch
import torch.distributed as dist

#: tracing is on: every span site reads this flag first
on = False

#: the spans kept before further ones are dropped (and counted)
CAPACITY = 1 << 18

#: (id of the innermost open span, request id) of this context
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "concrete_tpu_torch_span", default=(None, None))
_IDS = itertools.count(1)


class _Off:
    """The context manager of a span site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Recorder:
    """The spans and counters kept in memory, guarded by one lock."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.lock = threading.Lock()
        self.spans: list = []
        self.counters: collections.Counter = collections.Counter()
        self.dropped = 0

    def add_span(self, record: tuple) -> None:
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(record)
            else:
                self.dropped += 1

    def add(self, name: str, amount) -> None:
        with self.lock:
            self.counters[name] += amount

    def copy(self) -> tuple:
        with self.lock:
            return list(self.spans), dict(self.counters), self.dropped

    def clear(self) -> None:
        with self.lock:
            self.spans, self.dropped = [], 0
            self.counters = collections.Counter()


_RECORDER = Recorder()
_FIELDS = ("name", "id", "parent", "request", "rank", "thread", "start_ns",
           "end_ns", "attrs")


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Span:
    """One stage: entered and left as a context manager.  ``seconds`` is
    its duration once left."""

    __slots__ = ("name", "attrs", "record", "opens_request", "id", "parent",
                 "request", "start_ns", "end_ns", "_token", "_annotation")

    def __init__(self, name: str, attrs: dict, record: bool,
                 opens_request: bool = False):
        self.name, self.attrs, self.record = name, attrs, record
        self.opens_request = opens_request

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        if self.record:
            self.id = next(_IDS)
            self.parent, self.request = _CURRENT.get()
            if self.request is None and self.opens_request:
                self.request = self.id
            self._token = _CURRENT.set((self.id, self.request))
            self._annotation = None
            if torch.autograd._profiler_enabled():
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.record:
            if self._annotation is not None:
                self._annotation.__exit__(*exc)
            _CURRENT.reset(self._token)
            _RECORDER.add_span((self.name, self.id, self.parent,
                                self.request, _rank(),
                                threading.get_ident(), self.start_ns,
                                self.end_ns, self.attrs))
        return False


def span(name: str, **attrs) -> Span:
    """A span to record: call it only while tracing is on."""
    return Span(name, attrs, True)


def request(name: str, **attrs) -> Span:
    """A span that opens a request id where none is open (the outermost
    ``Circuit.run`` or ``Server.run``); inside a request, a plain span."""
    return Span(name, attrs, True, opens_request=True)


def timed(name: str, **attrs) -> Span:
    """A span that reads the clock whether tracing is on or not, and is
    recorded while it is: a set-up stage whose seconds the program
    keeps."""
    return Span(name, attrs, on)


class Stages:
    """Consecutive spans inside one: ``next(name)`` ends the open one and
    starts span `name` (while tracing is on); leaving ends the last."""

    def __init__(self):
        self.open = None

    def next(self, name: str) -> None:
        self.close()
        if on:
            self.open = span(name).__enter__()

    def close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def count(name: str, amount) -> None:
    """Add `amount` to counter `name`: call it only while tracing is on."""
    _RECORDER.add(name, amount)


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def snapshot() -> dict:
    """The spans recorded since the last reset, in the order they ended,
    each a dict of ``name, id, parent, request, rank, thread, start_ns,
    end_ns, attrs``; the counters; and the spans dropped when the buffer
    was full."""
    spans, counters, dropped = _RECORDER.copy()
    return {"spans": [dict(zip(_FIELDS, s)) for s in spans],
            "counters": counters, "dropped": dropped}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _RECORDER.clear()
