"""The port's trace recorder: spans at the serving engine's layer
boundaries and instant request events on the host's clock, device marks
on the card's, in one process-wide fixed-capacity ring (:data:`RECORDER`).

  * A :class:`Span` has a name, an id, its parent's id (the span open
    when it opened), an engine id, ``t0`` and ``t1`` from
    ``time.perf_counter_ns()`` and a few small attributes (``attrs``). It
    enters the ring when it closes.
  * An :class:`Event` is instant: a name, a time and a request uid.
  * The ring keeps the newest :data:`CAPACITY` entries and counts what it
    drops (``dropped``; ``dropped_until`` is the end time of the newest
    entry dropped), so a reader can tell whether an interval it reads is
    whole.
  * While a ``torch.profiler`` runs, each span is also a
    ``record_function("quest.<name>")``, which places the program's spans
    in the device trace on the trace's clock. Otherwise no
    ``record_function`` is built.
  * :class:`DeviceMarks` records timing ``torch.cuda.Event``s on the
    current stream at a tick's work boundaries and reads them after the
    tick's own blocking fetch, so it adds no synchronisation.

The recorder is always on: a tick records a few spans and, on the card,
one event a decode step, against ticks of tens of milliseconds.

:func:`trace_range` is the model's per-stage range: a profiler range
only, never recorded in memory (a decode step opens ~12 a layer).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Callable, Dict, List, Optional

import torch

PROFILER_PREFIX = "quest."
# Entries the ring keeps: about 5000 a 50 s window of the busiest cell
# (~400 ticks of 7 spans, ~4 events a request), so a dozen windows.
CAPACITY = 1 << 16


def trace_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler is active, else a ``nullcontext``: a decode step opens ~12
    ranges a layer, and building them unprofiled would cost host time.
    The ranges open on the host, so a replayed step has none: read them
    under ``engine.graphs.eager()``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Span:
    """One host interval; a context manager made by :meth:`Recorder.span`."""

    __slots__ = ("name", "id", "parent", "engine", "t0", "t1", "attrs",
                 "_rec", "_prof")

    def __init__(self, rec: "Recorder", name: str, engine: Optional[int],
                 attrs: dict):
        self._rec, self.name, self.engine = rec, name, engine
        self.attrs = attrs
        self.id = self.parent = self.t0 = self.t1 = 0
        self._prof = None

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec._open
        self.id = next(rec._ids)
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.engine is None:
                self.engine = top.engine
        stack.append(self)
        self.t0 = rec.clock()
        if torch.autograd._profiler_enabled():
            self._prof = torch.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
        self.t1 = rec.clock()
        rec._open.pop()
        rec._put(self)


class Event:
    """One instant: ``name`` at ``t`` (ns) for request ``uid``."""

    __slots__ = ("name", "t", "uid", "engine")

    def __init__(self, name: str, t: int, uid: int, engine: Optional[int]):
        self.name, self.t, self.uid, self.engine = name, t, uid, engine


class Recorder:
    """A ring of the newest ``capacity`` spans and events (module
    docstring). ``clock`` returns nanoseconds (``time.perf_counter_ns``,
    the clock of ``time.perf_counter``)."""

    def __init__(self, capacity: int = CAPACITY,
                 clock: Callable[[], int] = time.perf_counter_ns):
        self.capacity = capacity
        self.clock = clock
        self._ids = itertools.count(1)
        self._engines = itertools.count(1)
        self._open: List[Span] = []
        self.clear()

    def clear(self) -> None:
        """Forget every entry and the drop counts."""
        self._ring: list = [None] * self.capacity
        self._n = 0
        self.dropped = 0
        self.dropped_until = 0

    def new_engine(self) -> int:
        """A fresh engine id for an engine's spans and events."""
        return next(self._engines)

    def span(self, name: str, engine: Optional[int] = None,
             **attrs) -> Span:
        """``with recorder.span(name, engine, **attrs) as s:`` records the
        block; ``s.attrs`` may be filled before it closes. ``engine``
        defaults to the enclosing span's."""
        return Span(self, name, engine, attrs)

    def event(self, name: str, uid: int, engine: Optional[int] = None) -> None:
        self._put(Event(name, self.clock(), uid, engine))

    def _put(self, entry) -> None:
        i = self._n % self.capacity
        old = self._ring[i]
        if old is not None:
            self.dropped += 1
            self.dropped_until = max(self.dropped_until, old.t1
                                     if isinstance(old, Span) else old.t)
        self._ring[i] = entry
        self._n += 1

    def entries(self) -> list:
        """Every entry kept, oldest first (in the order they closed)."""
        if self._n <= self.capacity:
            return self._ring[:self._n]
        i = self._n % self.capacity
        return self._ring[i:] + self._ring[:i]

    def spans(self, name: Optional[str] = None) -> List[Span]:
        return [e for e in self.entries() if isinstance(e, Span)
                and (name is None or e.name == name)]

    def events(self, name: Optional[str] = None) -> List[Event]:
        return [e for e in self.entries() if isinstance(e, Event)
                and (name is None or e.name == name)]


RECORDER = Recorder()


class DeviceMarks:
    """Timing events on the current stream at one engine's tick
    boundaries. A tick calls :meth:`mark` just before its first launch,
    after each decode step and after its last launch, :meth:`settle`
    once its launches are queued, and :meth:`read` once its own blocking
    fetch has returned (every mark is complete by then). ``read`` puts
    the tick's ``work_ms`` (first mark to last) and ``gap_ms`` (from the
    previous tick's last mark to this tick's first) into its attributes
    at once; the decode steps' ``step_ms`` (one a step: the mark before
    it to the mark after it) are read by the next tick's ``settle``, while
    the device runs that tick's work, or by ``settle`` when the engine
    runs out of work, so the host's serial path reads two times a tick.
    Events are reused from a pool. On a device other than CUDA nothing is
    recorded and nothing read."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on = self.device.type == "cuda"
        self._pool: list = []
        self._tick: list = []
        self._stream = None
        self._last_end = None
        self._pending = None

    def mark(self) -> None:
        if self.on:
            if not self._tick:
                self._stream = torch.cuda.current_stream(self.device)
            ev = (self._pool.pop() if self._pool
                  else torch.cuda.Event(enable_timing=True))
            ev.record(self._stream)
            self._tick.append(ev)

    def read(self, attrs: Dict[str, object]) -> None:
        """The finished tick's device times into ``attrs`` (in ms)."""
        self.settle()
        evs, self._tick = self._tick, []
        if len(evs) < 2:
            self._pool.extend(evs)
            return
        attrs["work_ms"] = evs[0].elapsed_time(evs[-1])
        if self._last_end is not None:
            attrs["gap_ms"] = self._last_end.elapsed_time(evs[0])
            self._pool.append(self._last_end)
        self._last_end = evs[-1]
        if len(evs) > 2:
            self._pending = (evs[:-1], attrs)
        else:
            self._pool.extend(evs[:-1])

    def settle(self) -> None:
        """The step times of the last tick read, into its attributes."""
        if self._pending is not None:
            evs, attrs = self._pending
            self._pending = None
            attrs["step_ms"] = [a.elapsed_time(b)
                                for a, b in zip(evs, evs[1:])]
            self._pool.extend(evs)
