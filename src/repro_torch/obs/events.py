"""Typed, schema-versioned events: what the serving stack narrates.

Every layer of the serving stack (``core/session.py``, ``flow/executor.py``,
``flow/streaming.py``, ``flow/daemon.py``) emits these through a pluggable
``Sink`` (see ``repro_torch.obs.sink``) as it works, so SLA / capacity / retrace
claims are checkable IN FLIGHT instead of recomputed post-hoc by
benchmarks.  The full reference — fields, emission sites, exactly-once
guarantees — lives in ``docs/events.md``; keep the two in sync (the schema
golden test in ``tests/test_obs.py`` pins this module's vocabulary).

Design constraints:

* near-zero cost when disabled — emission sites guard with ``if sink:``
  (the no-op sink is falsy), so the OFF path is one truthiness check and
  plans are bit-for-bit identical either way;
* schema-versioned — every event carries ``schema=SCHEMA_VERSION`` so a
  dashboard tailing the JSON-lines sink can reject streams it does not
  understand;
* flat wire format — one JSON object per event, envelope fields at the
  top level, event-specific payload under ``data``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, Mapping, Optional

SCHEMA_VERSION = 2
# older wire versions the reader still folds correctly: v1 events are a
# strict subset of v2 (no trace_id/parent, no solve_profile type), so a
# v1 tape reads as v2 with null causal fields. Anything else is foreign.
SUPPORTED_SCHEMAS = frozenset({1, SCHEMA_VERSION})

# event vocabulary (see docs/events.md for the per-type reference):
#   solver / session layer
PLAN_SOLVED = "plan_solved"            # one live engine dispatch served
BUCKET_TRACED = "bucket_traced"        # a batch added a JIT cache entry
CACHE_HIT = "cache_hit"                # a batch rode the live cache entry
ADMISSION_DECISION = "admission_decision"  # session.admit verdict
SOLVE_PROFILE = "solve_profile"        # in-solve convergence telemetry
#   control plane / executor layer
DISPATCH = "dispatch"                  # a planned batch handed to execution
DEFER = "defer"                        # at-risk tenant waits for residue
PREEMPT = "preempt"                    # best-effort tenant evicted
DROP = "drop"                          # tenant/request exits unserved
CAPACITY_VIOLATION = "capacity_violation"  # realized usage over caps
CAPACITY_AUDIT = "capacity_audit"      # end-of-run realized-headroom sweep
DEADLINE_HIT = "deadline_hit"          # terminal per-tenant verdict
DEADLINE_MISS = "deadline_miss"        # terminal per-tenant verdict
#   serving daemon layer
ENVELOPE_WIDENED = "envelope_widened"  # batch exited the warmed envelope
SUBMIT = "submit"                      # request accepted at the front door
FLUSH = "flush"                        # a queued batch left for the solve
#   fault-tolerance layer (chaos harness / supervised pools)
FAULT_INJECTED = "fault_injected"      # the chaos harness fired one fault
POOL_DEGRADED = "pool_degraded"        # circuit breaker opened: greedy plans
POOL_RECOVERED = "pool_recovered"      # half-open probe solved: breaker shut
CAPACITY_REVOKED = "capacity_revoked"  # spot preemption shrank the caps

EVENT_TYPES = (
    PLAN_SOLVED, BUCKET_TRACED, CACHE_HIT, ADMISSION_DECISION,
    SOLVE_PROFILE,
    DISPATCH, DEFER, PREEMPT, DROP, CAPACITY_VIOLATION, CAPACITY_AUDIT,
    DEADLINE_HIT, DEADLINE_MISS, ENVELOPE_WIDENED, SUBMIT, FLUSH,
    FAULT_INJECTED, POOL_DEGRADED, POOL_RECOVERED, CAPACITY_REVOKED,
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured event on the observability plane.

    Envelope fields (always present on the wire):

    * ``type``   — one of ``EVENT_TYPES``;
    * ``ts``     — seconds on the EMITTING layer's clock (the control
      plane's / daemon's virtual clock for flow events, ``time.monotonic``
      for session-level solver events — see docs/events.md);
    * ``tenant`` / ``pool`` / ``sla`` — identity, where meaningful;
    * ``trace_id`` / ``parent`` — causal thread (schema v2): ``trace_id``
      groups every event one request caused across daemon → session →
      executor; ``parent`` names the preceding span in that thread (the
      emitting layer's view of what it continued from), ``null`` at the
      root. v1 events carry neither and read back as ``None``;
    * ``schema`` — wire-format version (``SCHEMA_VERSION``).

    ``data`` carries the event-type-specific payload and must stay
    JSON-serializable (floats/ints/strings/lists/dicts only).
    """
    type: str
    ts: float
    tenant: Optional[str] = None
    pool: Optional[str] = None
    sla: Optional[str] = None
    data: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    schema: int = SCHEMA_VERSION
    trace_id: Optional[str] = None
    parent: Optional[str] = None

    def __post_init__(self):
        if self.type not in EVENT_TYPES:
            raise ValueError(f"unknown event type {self.type!r} "
                             f"(expected one of {EVENT_TYPES})")

    def to_json(self) -> Dict[str, Any]:
        return {"schema": self.schema, "type": self.type, "ts": self.ts,
                "tenant": self.tenant, "pool": self.pool, "sla": self.sla,
                "trace_id": self.trace_id, "parent": self.parent,
                "data": dict(self.data)}


def event_from_json(obj: Mapping[str, Any]) -> Event:
    schema = int(obj.get("schema", 0))
    if schema not in SUPPORTED_SCHEMAS:
        raise ValueError(f"event schema {schema} not in supported "
                         f"{sorted(SUPPORTED_SCHEMAS)}; refusing to misread "
                         f"the stream")
    return Event(type=obj["type"], ts=float(obj["ts"]),
                 tenant=obj.get("tenant"), pool=obj.get("pool"),
                 sla=obj.get("sla"), data=dict(obj.get("data") or {}),
                 schema=schema, trace_id=obj.get("trace_id"),
                 parent=obj.get("parent"))


def read_jsonl(path: str) -> Iterator[Event]:
    """Stream events back out of a JSON-lines sink file (blank lines are
    tolerated — a dashboard may read a file mid-write)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield event_from_json(json.loads(line))
