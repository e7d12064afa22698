"""Causal request traces over the event stream (schema v2).

One *trace* is the causal thread of a single planning request as it
crosses layers: the daemon front door stamps a trace id at ``submit``,
the id rides ``PlanRequest.trace`` into the session / executor /
streaming emission sites, and every event those layers emit about the
request carries it back out on ``Event.trace_id``.  Folding a recorded
stream by trace id reconstructs the per-request span timeline
(submit -> admit -> flush -> solve -> dispatch -> terminal verdict)
that the flat, layer-ordered stream scatters.

Two granularities share one stream:

* **per-request events** (``submit``, ``admission_decision``, ``drop``,
  ``deadline_hit`` / ``deadline_miss``, streaming ``preempt`` /
  ``defer``) carry ``trace_id`` directly; ``parent`` names the span they
  continued from (the predecessor event's type), ``None`` at the root;
* **batch-level events** (``flush``, ``bucket_traced`` / ``cache_hit``,
  ``solve_profile``, ``plan_solved``, ``dispatch``) are emitted once per
  batch — duplicating them per member would double-count every
  aggregator fold — so they list their members under
  ``data["trace_ids"]`` and leave ``Event.trace_id`` null.

``spans(events, tid)`` merges both granularities back into one
chronological chain; ``chain_complete`` is the gate primitive
``bench_daemon --smoke`` asserts on (submit root AND a terminal span for
every daemon-served request).

Inside one batch, the session's ``cache_hit`` / ``bucket_traced`` event
and the daemon's ``dispatch`` event carry the batch's phases under
``data["spans"]``: ``[name, start_ns, end_ns, parent]`` records on
``time.time_ns()`` (the clock ``torch.profiler`` stamps its events on),
``parent`` the name of the enclosing phase or ``None`` at a layer's top.
``span`` records one; ``render_trace`` prints them under their event.

Pure stdlib, like the rest of ``repro_torch.obs`` — usable without jax.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import uuid
from typing import Dict, Iterable, List, Optional, Sequence

from .events import (DEADLINE_HIT, DEADLINE_MISS, DISPATCH, DROP, SUBMIT,
                     Event)

# span types that end a request's chain: a verdict, an exit, or (for
# requests with no deadline to audit) the dispatch that served them
TERMINAL_TYPES = (DEADLINE_HIT, DEADLINE_MISS, DROP)


class TraceIds:
    """Thread-safe factory for short, unique, monotonic trace ids.

    Ids are ``<prefix>-<counter>`` with a per-factory random prefix, so
    ids from two service lifetimes writing the same JSONL file never
    collide, while within one lifetime they sort in submit order.
    """

    def __init__(self, prefix: Optional[str] = None):
        self._prefix = prefix or uuid.uuid4().hex[:8]
        self._count = itertools.count()
        self._lock = threading.Lock()

    def next(self) -> str:
        with self._lock:
            return f"{self._prefix}-{next(self._count):04d}"


@contextlib.contextmanager
def span(record: Optional[list], name: str, parent: Optional[str] = None):
    """Append ``[name, start_ns, end_ns, parent]`` for the ``with`` body to
    ``record`` (nothing where ``record`` is None, or the body raised)."""
    if record is None:
        yield
        return
    t0 = time.time_ns()
    yield
    record.append([name, t0, time.time_ns(), parent])


def member_ids(event: Event) -> Sequence[str]:
    """Trace ids a batch-level event covers (empty for per-request)."""
    ids = event.data.get("trace_ids")
    return tuple(ids) if ids else ()


def spans(events: Iterable[Event], trace_id: str) -> List[Event]:
    """Every event in one request's causal thread, in stream order
    (stable for equal timestamps — events land in emission order)."""
    chain = [e for e in events
             if e.trace_id == trace_id or trace_id in member_ids(e)]
    chain.sort(key=lambda e: e.ts)
    return chain


def trace_ids(events: Iterable[Event]) -> List[str]:
    """All distinct trace ids in a stream, in order of first appearance
    (per-request stamps and batch membership lists both count)."""
    seen: Dict[str, None] = {}
    for e in events:
        if e.trace_id is not None:
            seen.setdefault(e.trace_id, None)
        for tid in member_ids(e):
            seen.setdefault(tid, None)
    return list(seen)


def chain_complete(chain: Sequence[Event]) -> bool:
    """A complete chain starts at a ``submit`` root and reaches a
    terminal span: a deadline verdict, a ``drop``, or — for requests
    that carry no deadline to audit — the ``dispatch`` that served them.
    """
    if not chain or chain[0].type != SUBMIT or chain[0].parent is not None:
        return False
    return any(e.type in TERMINAL_TYPES or e.type == DISPATCH
               for e in chain[1:])


def render_trace(events: Iterable[Event], trace_id: str) -> str:
    """Human-readable span timeline for one trace id."""
    chain = spans(list(events), trace_id)
    if not chain:
        return f"trace {trace_id}: no events"
    t0 = chain[0].ts
    lines = [f"trace {trace_id} "
             f"({'complete' if chain_complete(chain) else 'INCOMPLETE'}, "
             f"{len(chain)} spans)"]
    for e in chain:
        who = e.tenant or (f"batch[{len(member_ids(e))}]"
                           if member_ids(e) else "-")
        extras = []
        for key in ("reason", "cause", "admitted", "bucket", "traced",
                    "warm", "n", "deadline", "completion", "steps_to_best",
                    "mode", "kind", "state", "delay_s", "degraded",
                    "killed", "caps_after"):
            if key in e.data:
                extras.append(f"{key}={e.data[key]}")
        where = f" pool={e.pool}" if e.pool else ""
        lines.append(f"  +{e.ts - t0:10.3f}s  {e.type:<20} {who}{where}"
                     f"  {' '.join(extras)}".rstrip())
        lines.extend(_phase_lines(e.data.get("spans") or ()))
    return "\n".join(lines)


def _phase_lines(records: Sequence[Sequence]) -> List[str]:
    """A batch event's phases, each indented under its parent, in ms."""
    depth: Dict[str, int] = {}
    out = []
    for name, start, end, parent in sorted(records,
                                           key=lambda r: (r[1], -r[2])):
        d = depth[name] = depth.get(parent, -1) + 1 if parent else 0
        out.append(f"{'':16}{'  ' * d}{name:<{24 - 2 * d}}"
                   f"{(end - start) / 1e6:10.3f} ms")
    return out
