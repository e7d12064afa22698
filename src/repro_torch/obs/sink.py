"""Pluggable event sinks: no-op default, in-memory ring, JSON-lines file.

The contract at every emission site is::

    if self.sink:                      # one truthiness check when disabled
        self.sink.emit(Event(...))     # Event built only when enabled

``NULL`` (the shared no-op sink) is falsy, so the disabled path never even
constructs the event — the near-zero-cost requirement the serving stack's
hot paths rely on.  Real sinks are truthy and thread-safe: sessions emit
under their own lock, but the daemon's pools and widen/warmup threads emit
concurrently into one sink.

Fault isolation: a raising sink (disk-full ``JsonlSink``, a buggy
operator callback) must never break the serving path.  ``as_sink`` wraps
every caller-supplied sink in a ``GuardedSink`` — emission errors are
swallowed and COUNTED (``.errors``), never propagated into a solve — and
``TeeSink`` isolates its fan-out per branch, so one poisoned consumer
cannot starve the others (the daemon's internal aggregator keeps folding
while an operator's file sink fails).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
from typing import Iterable, List, Optional

from repro_torch.obs.events import Event


class Sink:
    """Base sink: truthy, thread-safe ``emit``, optional ``close``."""

    def emit(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Sink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullSink(Sink):
    """The falsy default: ``if sink:`` short-circuits every emission site,
    so a disabled plane costs one truthiness check and nothing else."""

    def emit(self, event: Event) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NULL = NullSink()


class GuardedSink(Sink):
    """Fault-isolation wrapper: ``emit`` never raises.  A sink failure on
    the serving path is counted on ``.errors`` (and the first exception
    kept on ``.last_error``) instead of breaking the plan that was being
    narrated.  Unknown attributes delegate to the wrapped sink, so test
    introspection (``sink.events`` on a ring) keeps working through the
    guard; truthiness follows the inner sink so ``if sink:`` emission
    guards still short-circuit the disabled plane."""

    def __init__(self, inner: Sink):
        # collapse nested guards: one error counter per emission path
        while isinstance(inner, GuardedSink):
            inner = inner.inner
        self.inner = inner
        self.errors = 0
        self.last_error: Optional[BaseException] = None

    def emit(self, event: Event) -> None:
        try:
            self.inner.emit(event)
        except Exception as exc:  # noqa: BLE001 — isolation is the point
            self.errors += 1
            if self.last_error is None:
                self.last_error = exc

    def close(self) -> None:
        try:
            self.inner.close()
        except Exception as exc:  # noqa: BLE001
            self.errors += 1
            if self.last_error is None:
                self.last_error = exc

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __bool__(self) -> bool:
        return bool(self.inner)


def as_sink(sink: Optional[Sink]) -> Sink:
    """Normalize a caller-supplied sink for a serving layer: ``None``
    becomes the falsy no-op, anything else is guarded so its failures
    cannot break the serving path."""
    if sink is None:
        return NULL
    if isinstance(sink, (NullSink, GuardedSink)):
        return sink
    return GuardedSink(sink)


class RingSink(Sink):
    """Bounded in-memory ring (newest ``capacity`` events kept) — the
    cheapest always-on sink, and what tests introspect."""

    def __init__(self, capacity: int = 4096):
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, event: Event) -> None:
        self._ring.append(event)       # deque.append is atomic under the GIL

    @property
    def events(self) -> List[Event]:
        return list(self._ring)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self._ring)


class JsonlSink(Sink):
    """JSON-lines file sink a dashboard can tail: one event per line,
    flushed per event by default so ``tail -f`` sees traffic live."""

    def __init__(self, path: str, *, flush_every: int = 1):
        self.path = path
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        # events that arrived after close() — e.g. a daemon pool racing
        # shutdown. They are dropped (the file is gone) but COUNTED, so
        # operators can see the tape is short rather than trust it blindly.
        self.dropped = 0
        # write/flush failures (disk full, rotated-away file): the event is
        # lost but the serving path is not — counted, never raised
        self.errors = 0

    def emit(self, event: Event) -> None:
        line = json.dumps(event.to_json())
        with self._lock:
            if self._f.closed:
                self.dropped += 1
                return
            try:
                self._f.write(line + "\n")
                self._since_flush += 1
                if self._since_flush >= self._flush_every:
                    self._f.flush()
                    self._since_flush = 0
            except OSError:
                self.errors += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


class TeeSink(Sink):
    """Fan one emission out to several sinks (e.g. the daemon's internal
    aggregator plus an operator-supplied JSON-lines file).  Branches are
    fault-isolated: one raising consumer is counted on ``.errors`` and the
    remaining branches still receive the event."""

    def __init__(self, *sinks: Optional[Sink]):
        self.sinks = tuple(s for s in sinks if s)
        self.errors = 0

    def emit(self, event: Event) -> None:
        for s in self.sinks:
            try:
                s.emit(event)
            except Exception:  # noqa: BLE001 — isolation per branch
                self.errors += 1

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def __bool__(self) -> bool:
        return bool(self.sinks)


class TagSink(Sink):
    """Stamp a pool name onto events passing through (the daemon wraps each
    pool's session sink in one, so session-level events carry the pool
    identity without the session knowing about pools)."""

    def __init__(self, inner: Sink, *, pool: str):
        self.inner = inner
        self.pool = pool

    def emit(self, event: Event) -> None:
        if event.pool is None:
            event = dataclasses.replace(event, pool=self.pool)
        self.inner.emit(event)

    def close(self) -> None:
        self.inner.close()

    def __bool__(self) -> bool:
        return bool(self.inner)


def replay(events: Iterable[Event], sink: Sink) -> int:
    """Feed a recorded stream into a sink (e.g. an aggregator); returns
    the number of events replayed."""
    n = 0
    for e in events:
        if sink:                  # a falsy sink is disabled: emit is a no-op
            sink.emit(e)
        n += 1
    return n
