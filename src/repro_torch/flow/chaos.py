"""Deterministic chaos harness for the serving plane (PyTorch port; numpy
only, a copy of the reference module).

Production serving is defined by its bad days — solver hiccups, slow
solves, full disks under the event tape, and spot preemptions that yank
capacity out from under running work.  This module turns those into a
REPRODUCIBLE schedule: a frozen ``ChaosConfig`` compiles into a
``FaultPlan`` whose decisions come from one seeded RNG (draw-indexed, so
two runs with the same config and the same traffic see the same fault
sequence) plus an explicit, virtual-clock-timed revocation timeline.

One plan is threaded through every layer (``DaemonConfig.chaos``,
``StreamConfig.chaos``, ``FlowConfig.chaos``), so the daemon, the
streaming control plane, and the discrete-event executor can be
exercised under the SAME fault schedule and gated together
(``benchmarks/bench_chaos.py``).

Fault kinds:

* **solver faults** — per-solve error probability (``solver_error_rate``)
  or an explicit list of failing solve indices
  (``solver_error_solves`` — what the circuit-breaker tests and the
  bench's deterministic trip/recover scenario use), plus solve-latency
  spikes (``latency_spike_rate`` / ``latency_spike_s``);
* **sink faults** — per-emission failure probability for a wrapped sink
  (``FaultySink``), proving the sink-isolation guard;
* **capacity revocations** — ``Revocation(at, delta, duration)`` events
  that shrink the cluster caps on the virtual clock (spot preemption),
  optionally restoring after ``duration``.

The chaos-disabled contract: every integration point gates on the config
being ``None`` (the default) — a run with no chaos config attached is
bit-for-bit identical to one on the pre-chaos code, and ``ChaosConfig()``
with zero rates and no revocations injects nothing.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.obs.sink import Sink

__all__ = [
    "ChaosConfig", "FaultPlan", "FaultySink", "InjectedFault", "Revocation",
    "SolveFault",
]


class InjectedFault(RuntimeError):
    """An error the chaos harness raised on purpose (solver or sink).

    Distinct from organic failures so supervision tests can assert the
    failure they observed is the one they scheduled."""


@dataclasses.dataclass(frozen=True)
class Revocation:
    """One spot-preemption event: ``delta`` capacity (per resource)
    disappears at virtual time ``at`` and returns after ``duration``
    (infinite = permanent loss)."""
    at: float
    delta: Tuple[float, ...]
    duration: float = math.inf

    def __post_init__(self):
        assert self.at >= 0.0, self.at
        assert self.duration > 0.0, self.duration
        assert all(d >= 0.0 for d in self.delta), self.delta

    @property
    def until(self) -> float:
        return self.at + self.duration

    def active_at(self, t: float) -> bool:
        return self.at <= t + 1e-12 < self.until


@dataclasses.dataclass(frozen=True)
class SolveFault:
    """The chaos verdict for one solve attempt."""
    kind: str                          # "error" | "delay"
    delay_s: float = 0.0               # virtual seconds, kind == "delay"


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """The frozen fault schedule; ``compile()`` yields the stateful
    ``FaultPlan`` that layers consult at runtime.  All rates are
    per-decision probabilities from ONE seeded stream; revocations and
    the explicit solver-fault indices are deterministic regardless of
    the seed."""
    seed: int = 0
    # solver faults: rate-driven, or explicit solve indices (0-based
    # count of solve attempts across the plan's lifetime) — both compose
    solver_error_rate: float = 0.0
    solver_error_solves: Tuple[int, ...] = ()
    latency_spike_rate: float = 0.0
    latency_spike_s: float = 0.5       # injected solve delay (virtual s)
    sink_error_rate: float = 0.0       # FaultySink per-emission failure
    revocations: Tuple[Revocation, ...] = ()

    def __post_init__(self):
        for r in (self.solver_error_rate, self.latency_spike_rate,
                  self.sink_error_rate):
            assert 0.0 <= r <= 1.0, r

    @property
    def enabled(self) -> bool:
        """Whether this config can inject anything at all."""
        return bool(self.solver_error_rate or self.solver_error_solves
                    or self.latency_spike_rate or self.sink_error_rate
                    or self.revocations)

    def compile(self) -> "FaultPlan":
        return FaultPlan(self)


class FaultPlan:
    """The runtime face of a ``ChaosConfig``: thread-safe, draw-indexed
    fault decisions plus the capacity timeline.

    Determinism contract: the k-th call to ``solve_fault()`` (and,
    independently, to ``sink_fault()``) returns the same verdict for the
    same config on every run — decisions consume a fixed number of draws
    from a per-purpose ``np.random.default_rng`` stream."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._solve_rng = np.random.default_rng([cfg.seed, 0x501])
        self._sink_rng = np.random.default_rng([cfg.seed, 0x51])
        self._solves = 0
        self._emits = 0
        # counters by kind, for reports and the bench artifact
        self.injected = {"solver_error": 0, "solve_delay": 0,
                         "sink_error": 0}

    # -- solver faults -------------------------------------------------

    def solve_fault(self) -> Optional[SolveFault]:
        """Verdict for the next solve attempt: ``None`` (clean), an
        injected error, or a latency spike."""
        with self._lock:
            idx = self._solves
            self._solves += 1
            # two draws per solve, always consumed, so the sequence is a
            # pure function of the solve index
            u_err = float(self._solve_rng.random())
            u_lat = float(self._solve_rng.random())
            if idx in self.cfg.solver_error_solves \
                    or u_err < self.cfg.solver_error_rate:
                self.injected["solver_error"] += 1
                return SolveFault("error")
            if u_lat < self.cfg.latency_spike_rate:
                self.injected["solve_delay"] += 1
                return SolveFault("delay", self.cfg.latency_spike_s)
            return None

    # -- sink faults ---------------------------------------------------

    def sink_fault(self) -> bool:
        """Whether the next sink emission should raise."""
        with self._lock:
            self._emits += 1
            if float(self._sink_rng.random()) < self.cfg.sink_error_rate:
                self.injected["sink_error"] += 1
                return True
            return False

    # -- capacity timeline ---------------------------------------------

    def caps_at(self, t: float, base_caps) -> np.ndarray:
        """Effective capacity vector at virtual time ``t``: the base pool
        minus every active revocation, floored at zero."""
        caps = np.asarray(base_caps, float).copy()
        for r in self.cfg.revocations:
            if r.active_at(t):
                caps -= np.asarray(r.delta, float)
        return np.maximum(caps, 0.0)

    def revocations_in(self, t0: float, t1: float) -> List[Revocation]:
        """Revocations taking effect in ``(t0, t1]`` (chronological)."""
        hits = [r for r in self.cfg.revocations if t0 < r.at <= t1]
        return sorted(hits, key=lambda r: r.at)

    def next_capacity_change(self, t: float) -> float:
        """The next instant after ``t`` at which the effective capacity
        changes (a revocation lands or expires); ``inf`` when none."""
        instants = [x for r in self.cfg.revocations
                    for x in (r.at, r.until) if x > t + 1e-12]
        return min(instants, default=math.inf)

    def stats(self) -> dict:
        """JSON-able injection counters."""
        with self._lock:
            return {"solves": self._solves, "emits": self._emits,
                    "injected": dict(self.injected),
                    "revocations": len(self.cfg.revocations)}


class FaultySink(Sink):
    """A sink that fails on schedule: every emission consults the fault
    plan (or fails unconditionally when built without one).  The tool the
    sink-isolation regression tests and the chaos bench poison the event
    plane with — wrap it in ``GuardedSink`` / ``TeeSink`` and the serving
    path must not notice."""

    def __init__(self, plan: Optional[FaultPlan] = None,
                 inner: Optional[Sink] = None):
        self.plan = plan
        self.inner = inner
        self.emitted = 0
        self.raised = 0

    def emit(self, event) -> None:
        if self.plan is None or self.plan.sink_fault():
            self.raised += 1
            raise InjectedFault("sink fault injected")
        self.emitted += 1
        if self.inner is not None:
            self.inner.emit(event)

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()
