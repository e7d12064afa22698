"""Fold the event stream into per-tenant / per-pool serving metrics.

``EventAggregator`` is itself a ``Sink``, so it can ride live traffic
(the daemon keeps one internally and re-derives ``/v1/stats`` from it) or
fold a recorded stream after the fact (``EventAggregator.fold``) — the
``obs_report`` CLI and the ``bench_streaming`` / ``bench_daemon`` gates
run on exactly this fold, so benchmark accounting and serving accounting
are ONE code path.

What it derives (see docs/events.md for the event-type reference):

* SLA hit rate by DECLARED class — ``deadline_hit`` / ``deadline_miss``
  terminal events, finite-deadline tenants only (the same filter as
  ``flow.streaming.deadline_hit_rate``);
* retrace count — ``bucket_traced`` events with ``warming=False`` (the
  zero-retrace contract, observable in flight);
* realized capacity headroom — elementwise min over ``capacity_audit``
  sweeps, plus the ``capacity_violation`` count;
* p50/p99 submit-to-plan latency — the per-request wall latencies carried
  on daemon ``dispatch`` events.
"""
from __future__ import annotations

import collections
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs import events as ev
from repro_torch.obs.events import Event
from repro_torch.obs.sink import Sink


def finite_or_none(x) -> Optional[float]:
    """JSON-safe number: ``inf``/``nan`` (not representable in strict
    JSON) travel as ``null`` on the wire."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default) over an already
    sorted non-empty sequence — stdlib-only so the docs/report path needs
    no array stack."""
    pos = (len(sorted_values) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) \
        * (pos - lo)


class EventAggregator(Sink):
    """Streaming fold of the event plane (thread-safe; the daemon's pools
    emit into one aggregator concurrently)."""

    def __init__(self):
        # reentrant: snapshot() reads derived metrics that re-take the lock
        self._lock = threading.RLock()
        self.counts: collections.Counter = collections.Counter()
        # declared SLA class -> [hits, misses] (finite-deadline tenants)
        self._deadline: Dict[str, List[int]] = {}
        self.retraces = 0                  # non-warming bucket_traced
        self.warmup_traces = 0             # warming bucket_traced
        self.cache_hits = 0
        self.violations = 0
        # fault-tolerance plane: chaos injections, spot revocations, and
        # the set of pools currently serving degraded (greedy) plans
        self.faults = 0
        self.revocations = 0
        self.degraded_pools: set = set()
        self.headroom: Optional[List[float]] = None   # elementwise min
        self.latencies: List[float] = []   # submit-to-plan wall seconds
        # pool -> counter dict (plans/traces/cache_hits/served/...)
        self.pools: Dict[str, collections.Counter] = {}
        # tenant -> terminal verdict (exactly one per tenant when the
        # emitting layer honors its exactly-once contract)
        self.tenants: Dict[str, Dict[str, Any]] = {}
        # per-request convergence roll-ups from solve_profile events
        # (schema v2): the raw material of convergence_stats()
        self.profiles: List[Dict[str, Any]] = []

    # -- Sink ----------------------------------------------------------

    def emit(self, event: Event) -> None:
        with self._lock:
            self._fold(event)

    def _pool(self, name: Optional[str]) -> collections.Counter:
        return self.pools.setdefault(name or "", collections.Counter())

    def _fold(self, e: Event) -> None:
        self.counts[e.type] += 1
        pool = self._pool(e.pool) if e.pool is not None else None
        if e.type == ev.BUCKET_TRACED:
            if e.data.get("warming"):
                self.warmup_traces += 1
            else:
                self.retraces += 1
            if pool is not None:
                pool["traces"] += 1
        elif e.type == ev.CACHE_HIT:
            self.cache_hits += 1
            if pool is not None:
                pool["cache_hits"] += 1
        elif e.type == ev.PLAN_SOLVED:
            if pool is not None:
                pool["plans"] += 1
                pool["served"] += int(e.data.get("n", 1))
        elif e.type == ev.DISPATCH:
            if pool is not None:
                pool["dispatches"] += 1
            self.latencies.extend(float(x) for x in
                                  e.data.get("latency_s", ()))
        elif e.type in (ev.DEADLINE_HIT, ev.DEADLINE_MISS):
            hit = e.type == ev.DEADLINE_HIT
            sla = e.sla or ""
            if e.data.get("deadline") is not None:
                hm = self._deadline.setdefault(sla, [0, 0])
                hm[0 if hit else 1] += 1
            if e.tenant is not None:
                self.tenants[e.tenant] = {
                    "sla": sla, "hit": hit,
                    "deadline": e.data.get("deadline"),
                    "completion": e.data.get("completion"),
                    "reason": e.data.get("reason"),
                }
        elif e.type == ev.SOLVE_PROFILE:
            self.profiles.extend(dict(p) for p in e.data.get("profiles", ()))
            if pool is not None:
                pool["solve_profiles"] += 1
        elif e.type == ev.FAULT_INJECTED:
            self.faults += 1
            if pool is not None:
                pool["faults"] += 1
        elif e.type == ev.POOL_DEGRADED:
            self.degraded_pools.add(e.pool or "")
            if pool is not None:
                pool["degraded_events"] += 1
        elif e.type == ev.POOL_RECOVERED:
            self.degraded_pools.discard(e.pool or "")
            if pool is not None:
                pool["recovered_events"] += 1
        elif e.type == ev.CAPACITY_REVOKED:
            self.revocations += 1
        elif e.type == ev.CAPACITY_VIOLATION:
            self.violations += 1
        elif e.type == ev.CAPACITY_AUDIT:
            head = e.data.get("headroom")
            if head is not None:
                head = [float(x) for x in head]
                if self.headroom is None:
                    self.headroom = head
                else:
                    self.headroom = [min(a, b) for a, b
                                     in zip(self.headroom, head)]

    # -- derived metrics -----------------------------------------------

    def hit_counts(self, sla: str) -> Tuple[int, int]:
        """(hits, misses) of finite-deadline tenants in declared class
        ``sla`` — the event-derived mirror of the post-hoc benchmark
        accounting."""
        with self._lock:
            h, m = self._deadline.get(sla, (0, 0))
        return h, m

    def hit_rate(self, sla: str) -> float:
        """Fraction of finite-deadline ``sla``-class tenants that met
        their deadline (1.0 when none — same convention as
        ``flow.streaming.deadline_hit_rate``)."""
        h, m = self.hit_counts(sla)
        return h / (h + m) if (h + m) else 1.0

    def latency_percentiles(self, qs: Sequence[float] = (50.0, 99.0)
                            ) -> Dict[str, Optional[float]]:
        """Submit-to-plan wall-latency percentiles (seconds) from daemon
        ``dispatch`` events. Before any traffic there is no sample to take
        a percentile of: every quantile is an explicit ``None`` (JSON
        ``null``) — never a fabricated number."""
        with self._lock:
            lat = sorted(self.latencies)
        if not lat:
            return {f"p{q:g}": None for q in qs}
        return {f"p{q:g}": percentile(lat, q) for q in qs}

    def convergence_stats(self, qs: Sequence[float] = (50.0, 99.0)
                          ) -> Dict[str, Any]:
        """Roll-up of the per-request ``solve_profile`` payloads: where the
        annealer's step budget actually went. ``None``s (not zeros) when no
        telemetry-bearing solve has been seen."""
        with self._lock:
            profiles = list(self.profiles)
        out: Dict[str, Any] = {"profiles": len(profiles)}
        if not profiles:
            out["steps_to_best"] = {f"p{q:g}": None for q in qs}
            out["plateau_fraction"] = None
            out["accept_decay"] = None
            return out
        stb = sorted(float(p["steps_to_best"]) for p in profiles)
        out["steps_to_best"] = {f"p{q:g}": percentile(stb, q) for q in qs}
        out["plateau_fraction"] = (
            sum(float(p["plateau_fraction"]) for p in profiles)
            / len(profiles))
        out["accept_decay"] = (
            sum(float(p["accept_decay"]) for p in profiles) / len(profiles))
        return out

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able roll-up: what ``/v1/stats`` serves under
        ``events`` and what ``obs_report`` prints."""
        with self._lock:
            deadline = {sla: {"hits": h, "misses": m,
                              "rate": h / (h + m) if (h + m) else 1.0}
                        for sla, (h, m) in sorted(self._deadline.items())}
            return {
                "schema": ev.SCHEMA_VERSION,
                "events": sum(self.counts.values()),
                "counts": dict(sorted(self.counts.items())),
                "retraces": self.retraces,
                "warmup_traces": self.warmup_traces,
                "cache_hits": self.cache_hits,
                "deadline": deadline,
                "violations": self.violations,
                "faults": self.faults,
                "revocations": self.revocations,
                "degraded_pools": sorted(self.degraded_pools),
                "headroom": self.headroom,
                "latency": self.latency_percentiles(),
                "convergence": self.convergence_stats(),
                "pools": {name: dict(sorted(c.items()))
                          for name, c in sorted(self.pools.items())},
                "tenants": len(self.tenants),
            }

    @classmethod
    def fold(cls, stream: Iterable[Event]) -> "EventAggregator":
        agg = cls()
        for e in stream:
            agg.emit(e)
        return agg
