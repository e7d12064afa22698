"""Observability plane: typed events, pluggable sinks, one aggregator.

The serving stack narrates what it does (``repro_torch.obs.events``) through a
near-zero-cost sink (``repro_torch.obs.sink``; the no-op default is falsy so
disabled emission sites cost one truthiness check), and everything that
reports — the daemon's ``/v1/stats``, the streaming/daemon benchmark
gates, the ``obs_report`` CLI — folds the same stream with
``EventAggregator`` (``repro_torch.obs.aggregate``).  No jax imports here: the
report/docs path runs on a bare Python.
"""
from repro_torch.obs.aggregate import EventAggregator, finite_or_none
from repro_torch.obs.artifacts import (MISSING_ARTIFACT, load_artifact,
                                       missing_artifact)
from repro_torch.obs.events import (
    ADMISSION_DECISION,
    BUCKET_TRACED,
    CACHE_HIT,
    CAPACITY_AUDIT,
    CAPACITY_VIOLATION,
    DEADLINE_HIT,
    DEADLINE_MISS,
    DEFER,
    DISPATCH,
    DROP,
    ENVELOPE_WIDENED,
    EVENT_TYPES,
    FAULT_INJECTED,
    PLAN_SOLVED,
    POOL_DEGRADED,
    POOL_RECOVERED,
    PREEMPT,
    SCHEMA_VERSION,
    CAPACITY_REVOKED,
    Event,
    event_from_json,
    read_jsonl,
)
from repro_torch.obs.sink import (
    NULL,
    GuardedSink,
    JsonlSink,
    NullSink,
    RingSink,
    Sink,
    TagSink,
    TeeSink,
    as_sink,
    replay,
)

__all__ = [
    "ADMISSION_DECISION", "BUCKET_TRACED", "CACHE_HIT", "CAPACITY_AUDIT",
    "CAPACITY_REVOKED", "CAPACITY_VIOLATION", "DEADLINE_HIT",
    "DEADLINE_MISS", "DEFER", "DISPATCH", "DROP", "ENVELOPE_WIDENED",
    "EVENT_TYPES", "FAULT_INJECTED", "PLAN_SOLVED", "POOL_DEGRADED",
    "POOL_RECOVERED", "PREEMPT", "SCHEMA_VERSION", "Event",
    "event_from_json", "read_jsonl",
    "NULL", "GuardedSink", "JsonlSink", "NullSink", "RingSink", "Sink",
    "TagSink", "TeeSink", "as_sink", "replay",
    "EventAggregator", "finite_or_none",
    "MISSING_ARTIFACT", "load_artifact", "missing_artifact",
]
