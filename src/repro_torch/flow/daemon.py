"""Planner-serving daemon: the asyncio front door over warmed session pools
(PyTorch port).

``PlannerSession`` made compile-once / serve-many a first-class
object, but a single synchronous Python caller still drove one session at
a time.  ``PlannerService`` turns it into a long-lived service:

* **async submission** — ``await service.submit(request)`` resolves to a
  typed ``PlanResult``; arrivals from many concurrent callers are
  continuously batched so a burst of N submissions costs ONE device
  dispatch, not N.
* **deadline-aware flush** — a pending batch dispatches when it fills the
  next warmed power-of-two bucket, OR when the earliest admitted
  deadline's slack says wait no longer (the tenant's critical-path
  completion floor + measured solve latency + a margin, subtracted from
  its absolute deadline), OR when the oldest request has waited
  ``max_wait_s``.  ``DaemonConfig(flush="fill")`` is the ablation that
  only fills — the benchmark gate shows it strictly worse.
* **warmed session pool** — one ``PlannerSession`` per ``PoolSpec``
  (shared/isolated × bucket schedule × mesh), each warmed ahead of
  traffic; requests route by explicit pool name or the config's router.
  Solves run on per-pool executor threads so the event loop (and every
  other pool) keeps serving while one pool's batch is on device.
* **load shedding** — provably infeasible guaranteed arrivals are shed at
  submission through ``session.admit`` (same provable-only rejections as
  the streaming control plane), and a full queue sheds instead of growing
  an unbounded backlog.  Shed submissions raise ``LoadShedError``.
* **envelope auto-widening** — a batch that exits the warmed ``(bucket,
  Jmax, Omax)`` envelope is served on the dedicated widen thread (the
  trace happens OFF the per-pool serving executors, which keep serving
  warm traffic), and the next bucket up is pre-warmed in the background
  so sustained growth never pays the compile inline again.
* **supervised pools with graceful degradation** — a raising dispatch is
  caught, the pool's serving executor recycled, and the solve retried
  once before anything user-visible happens; a crashed flusher restarts
  in place with its queue intact.  A per-pool circuit breaker counts
  consecutive bad solves (errors, or successes slower than
  ``breaker_latency_s``): past ``breaker_threshold`` the pool DEGRADES —
  batches are served greedy airflow-style fallback plans (flagged
  ``PlanResult.degraded``) instead of being shed — and after
  ``breaker_cooldown_s`` one half-open probe batch decides whether the
  solver is trusted again.  ``DaemonConfig.chaos`` attaches the
  deterministic fault harness (``repro_torch.flow.chaos``) that drills exactly
  these paths, including capacity revocations narrowed into every solve.

A thin JSON-over-HTTP adapter (``PlannerHTTPServer``) serves non-Python
callers; ``python -m repro_torch.launch.serve_planner`` is the CLI entry.
In the port a "trace" is a solve signature run for the first time
(``trace_count``); the text below keeps the reference's vocabulary.

Clocks: deadlines, DAG release times and solver timelines share ONE
"virtual" clock supplied by ``DaemonConfig.clock`` (defaults to
``time.monotonic``, i.e. real time).  ``time_scale`` says how many
virtual seconds pass per wall second, so benchmarks can replay hours of
trace in seconds of wall time; production leaves both at the default.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.core.dag import DAG, Task, TaskOption
from repro_torch.core.objectives import Goal
from repro_torch.core.session import (SLA_CLASSES, SLA_GUARANTEED,
                                      SLA_STANDARD, AdmissionDecision,
                                      PlanRequest, PlanResult,
                                      _normalize_request, check_demands)
from repro_torch.flow.chaos import InjectedFault
from repro_torch.obs import events as obs
from repro_torch.obs.aggregate import EventAggregator, finite_or_none
from repro_torch.obs.events import Event
from repro_torch.obs.sink import TagSink, TeeSink
from repro_torch.obs.trace import TraceIds

__all__ = [
    "PoolSpec", "DaemonConfig", "DaemonStats", "LoadShedError",
    "PlanServiceError", "PlannerService", "PlannerHTTPServer",
    "dag_to_json", "dag_from_json", "plan_result_to_json",
    "request_from_json", "metrics_text",
]


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One warmed-session flavor in the pool.

    A pool entry pins one static solve signature (capacity model, bucket
    schedule, mesh, default goal) exactly the way ``agora.session(...)``
    does; the service owns one session + one serving thread per entry.
    """
    name: str
    shared_capacity: bool = True
    bucket_p: Union[int, bool] = True
    mesh: Any = "inherit"              # "inherit" -> the Agora's mesh
    goal: Optional[Goal] = None


@dataclasses.dataclass(frozen=True)
class DaemonConfig:
    """Service knobs (see module docstring for the flush policy)."""
    pools: Tuple[PoolSpec, ...] = (PoolSpec("shared"),)
    max_batch: int = 8                 # bucket-fill flush target (= the
    #                                    largest warmed bucket)
    max_wait_s: float = 30.0           # flush a non-empty queue after this
    #                                    long (virtual s) regardless
    slack_margin_s: float = 10.0       # deadline-flush safety margin on top
    #                                    of the completion floor (virtual s)
    flush: str = "deadline"            # "deadline" | "fill" (the ablation:
    #                                    ignore deadline slack, only fill /
    #                                    max_wait flushes)
    admission_control: bool = True     # shed provably infeasible guaranteed
    #                                    arrivals at submission
    max_queue: int = 64                # per-pool backlog ceiling (shed past)
    auto_widen: bool = True            # pre-warm the next bucket after an
    #                                    envelope exit, off the serving path
    guaranteed_w: float = 0.9          # SLA->goal mapping for requests that
    best_effort_w: float = 0.15        # carry no explicit goal (mirrors
    deadline_weight: float = 8.0       # flow.streaming.sla_goal)
    # virtual clock: deadlines / release times / solver timelines live on
    # clock(); time_scale = virtual seconds per wall second
    clock: Callable[[], float] = time.monotonic
    time_scale: float = 1.0
    router: Optional[Callable[[PlanRequest], str]] = None
    # optional operator sink (e.g. JsonlSink) teed with the service's
    # always-on internal EventAggregator; None = aggregator only
    sink: Any = None
    # -- fault-tolerance plane -----------------------------------------
    # deterministic chaos harness (repro_torch.flow.chaos.ChaosConfig); None
    # (default) injects nothing and keeps the serving path bit-for-bit
    chaos: Any = None
    # serve greedy fallback plans (flagged PlanResult.degraded) while a
    # pool's breaker is open or every solve attempt failed, instead of
    # failing the batch's futures — availability over plan quality
    degraded_serve: bool = True
    breaker_threshold: int = 3         # consecutive bad solves that open
    #                                    the pool's circuit breaker
    breaker_latency_s: float = math.inf  # a success slower than this
    #                                    (wall s) counts as a breach
    breaker_cooldown_s: float = 60.0   # virtual seconds open before one
    #                                    half-open probe solve is allowed
    solve_retries: int = 1             # extra solve attempts per batch,
    #                                    each on a recycled pool executor
    max_flusher_restarts: int = 3      # supervised flusher revivals per
    #                                    pool before failing loudly

    def __post_init__(self):
        assert self.flush in ("deadline", "fill"), self.flush
        assert self.pools, "need at least one PoolSpec"
        assert self.max_batch >= 1 and self.max_queue >= 1
        assert self.breaker_threshold >= 1 and self.breaker_cooldown_s > 0
        assert self.solve_retries >= 0 and self.max_flusher_restarts >= 0
        names = [p.name for p in self.pools]
        assert len(set(names)) == len(names), f"duplicate pool names {names}"


class LoadShedError(RuntimeError):
    """Raised by ``submit`` when a request is shed instead of planned:
    either the pool's backlog is full, or admission control proved the
    guaranteed deadline infeasible (``decision`` carries the proof)."""

    def __init__(self, reason: str,
                 decision: Optional[AdmissionDecision] = None):
        super().__init__(reason)
        self.reason = reason
        self.decision = decision


class PlanServiceError(RuntimeError):
    """Typed terminal failure for a submitted request: its batch's solve
    raised, the in-batch retry (on a recycled pool executor) failed too,
    and the degraded fallback was disabled or also failed.  ``cause``
    keeps the last underlying exception."""

    def __init__(self, reason: str, cause: Optional[BaseException] = None):
        super().__init__(reason)
        self.reason = reason
        self.cause = cause


@dataclasses.dataclass
class DaemonStats:
    """Service-level counters (session-level stats ride each pool's
    ``session.stats``; ``PlannerService.stats()`` aggregates both)."""
    submitted: int = 0
    served: int = 0
    shed_queue: int = 0
    shed_admission: int = 0
    batches: int = 0
    flush_fill: int = 0                # batches flushed on bucket fill
    flush_deadline: int = 0            # ... on deadline slack expiry
    flush_wait: int = 0                # ... on the max_wait timer
    flush_drain: int = 0               # ... on shutdown drain
    widen_events: int = 0              # batches that exited the warmed
    #                                    envelope (served on the widen
    #                                    thread, next bucket pre-warmed)
    errors: int = 0                    # solve attempts that raised
    pool_restarts: int = 0             # serving executors recycled after
    #                                    a raising dispatch
    flusher_restarts: int = 0          # supervised flusher revivals
    degraded_served: int = 0           # requests served by the greedy
    #                                    fallback (breaker open or every
    #                                    solve attempt failed)
    faults_injected: int = 0           # chaos-harness injections observed
    revocations: int = 0               # capacity revocations applied to
    #                                    the serving capacity vector


@dataclasses.dataclass
class _Pending:
    """One queued submission awaiting its flush."""
    request: PlanRequest
    future: "asyncio.Future[PlanResult]"
    submit_v: float                    # virtual submission time
    submit_wall: float                 # wall submission time (latency acct)
    cp_dur: float = 0.0                # critical-path completion floor
    #                                    (duration, virtual s) — what the
    #                                    deadline flush subtracts


class _Breaker:
    """Per-pool circuit breaker on the service's virtual clock.

    closed -> (``threshold`` consecutive bad solves: errors, or successes
    slower than ``latency_s``) -> open -> (``cooldown_s`` virtual seconds)
    -> half_open (ONE probe batch solves for real) -> closed on a clean
    probe, straight back to open on a failed one.  While open, ``allow``
    answers "degrade": the pool serves greedy fallback plans instead of
    shedding."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int, latency_s: float, cooldown_s: float):
        self.threshold = int(threshold)
        self.latency_s = float(latency_s)
        self.cooldown_s = float(cooldown_s)
        self.state = self.CLOSED
        self.failures = 0              # consecutive bad solves
        self.opened_v = -math.inf      # virtual instant the breaker opened

    def allow(self, now_v: float) -> str:
        """"serve" (closed), "degrade" (open, still cooling down) or
        "probe" (cooled down: this batch may try the solver again)."""
        if self.state == self.CLOSED:
            return "serve"
        if now_v - self.opened_v >= self.cooldown_s:
            self.state = self.HALF_OPEN
            return "probe"
        return "degrade"

    def record_failure(self, now_v: float) -> bool:
        """Count one bad solve; True when this one OPENS the breaker
        (a failed half-open probe re-opens it)."""
        self.failures += 1
        if self.state == self.HALF_OPEN or (
                self.state == self.CLOSED
                and self.failures >= self.threshold):
            self.state = self.OPEN
            self.opened_v = now_v
            return True
        if self.state == self.OPEN:
            self.opened_v = now_v      # keep cooling from the LAST failure
        return False

    def record_success(self, now_v: float,
                       latency_s: float) -> Optional[str]:
        """Count one served solve: ``"recovered"`` when it closes the
        breaker, ``"opened"`` when the success was a latency breach that
        tripped it, ``None`` otherwise."""
        if latency_s > self.latency_s:
            return "opened" if self.record_failure(now_v) else None
        was = self.state
        self.state = self.CLOSED
        self.failures = 0
        return "recovered" if was != self.CLOSED else None


class _PoolEntry:
    """Session + queue + serving thread + breaker for one ``PoolSpec``."""

    def __init__(self, spec: PoolSpec, session, breaker: _Breaker):
        self.spec = spec
        self.session = session
        self.breaker = breaker
        self.pending: Deque[_Pending] = collections.deque()
        self.event: Optional[asyncio.Event] = None   # created on start()
        self.executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"planner-{spec.name}")
        self.flusher: Optional[asyncio.Task] = None
        self.restarts = 0              # supervised flusher revivals


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


class PlannerService:
    """Async planner-serving daemon over a pool of warmed sessions
    (see module docstring).

    Lifecycle::

        service = PlannerService(agora, DaemonConfig(...))
        service.warmup(template_dag, max_p=8)     # compile ahead of traffic
        async with service:                       # start() ... stop()
            result = await service.submit(PlanRequest(dag=dag))
    """

    def __init__(self, agora, cfg: Optional[DaemonConfig] = None):
        self.agora = agora
        self.cfg = cfg or DaemonConfig()
        # always-on event plane: the internal aggregator re-derives
        # /v1/stats and the latency percentiles from the SAME stream an
        # operator sink (cfg.sink, e.g. a JSON-lines file) tails
        self.aggregator = EventAggregator()
        self.sink = TeeSink(self.aggregator, self.cfg.sink)
        self.entries: Dict[str, _PoolEntry] = {}
        for spec in self.cfg.pools:
            session = agora.session(
                shared_capacity=spec.shared_capacity, bucket_p=spec.bucket_p,
                mesh=spec.mesh, goal=spec.goal,
                sink=TagSink(self.sink, pool=spec.name))
            self.entries[spec.name] = _PoolEntry(spec, session, _Breaker(
                self.cfg.breaker_threshold, self.cfg.breaker_latency_s,
                self.cfg.breaker_cooldown_s))
        self.default_pool = self.cfg.pools[0].name
        self.stats_counters = DaemonStats()
        # chaos harness: ONE compiled fault plan shared by every pool, so
        # the injected sequence is a pure function of the config; None
        # (the default) keeps every consultation site on its fast path
        self._fault_plan = (self.cfg.chaos.compile()
                            if self.cfg.chaos is not None
                            and getattr(self.cfg.chaos, "enabled", False)
                            else None)
        self._base_caps = np.asarray(agora.cluster.caps, float)
        self._revoked_seen: set = set()
        # causal traces: every submission is stamped with a trace id at the
        # front door; the id rides PlanRequest.trace through session /
        # executor emissions so `obs_report --trace` can rebuild the
        # submit -> ... -> terminal span chain per request
        self._trace_ids = TraceIds()
        # one dedicated thread traces out-of-envelope signatures so the
        # per-pool serving executors never stall behind a compile
        self._widen_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="planner-widen")
        self._dispatches: set = set()
        self._running = False

    # -- clock ---------------------------------------------------------

    def _now(self) -> float:
        return float(self.cfg.clock())

    def _to_wall(self, virtual_delta: float) -> float:
        return max(virtual_delta, 0.0) / self.cfg.time_scale

    # -- warmup --------------------------------------------------------

    def warmup(self, template: Union[PlanRequest, DAG], *,
               buckets: Optional[Sequence[int]] = None,
               max_p: Optional[int] = None,
               pools: Optional[Sequence[str]] = None
               ) -> Dict[str, Dict[int, float]]:
        """Trace/compile every pool's bucket schedule ahead of traffic
        (synchronous; call before ``start`` or from an executor).  Returns
        ``{pool: {bucket: wall_seconds}}``."""
        max_p = max_p if max_p is not None else self.cfg.max_batch
        out: Dict[str, Dict[int, float]] = {}
        for name in (pools or list(self.entries)):
            out[name] = self.entries[name].session.warmup(
                template, buckets=buckets, max_p=max_p)
        return out

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> "PlannerService":
        assert not self._running, "service already started"
        self._running = True
        for entry in self.entries.values():
            entry.event = asyncio.Event()
            entry.flusher = asyncio.create_task(
                self._flusher(entry), name=f"flusher-{entry.spec.name}")
        return self

    async def stop(self, *, drain: bool = True) -> None:
        """Stop serving: drain (default) or shed the remaining backlog,
        join the flushers and dispatches, release the executors."""
        if not self._running:
            return
        self._running = False
        for entry in self.entries.values():
            if not drain:
                while entry.pending:
                    p = entry.pending.popleft()
                    if not p.future.done():
                        p.future.set_exception(
                            LoadShedError("service shutting down"))
            entry.event.set()
        await asyncio.gather(*(e.flusher for e in self.entries.values()
                               if e.flusher))
        if self._dispatches:
            await asyncio.gather(*list(self._dispatches),
                                 return_exceptions=True)
        for entry in self.entries.values():
            entry.executor.shutdown(wait=True)
        self._widen_pool.shutdown(wait=True)

    async def __aenter__(self) -> "PlannerService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- submission ----------------------------------------------------

    def _route(self, request: PlanRequest, pool: Optional[str]) -> _PoolEntry:
        name = pool or (self.cfg.router(request) if self.cfg.router
                        else self.default_pool)
        if name not in self.entries:
            raise ValueError(f"unknown pool {name!r} "
                             f"(have {sorted(self.entries)})")
        return self.entries[name]

    def _emit_shed(self, entry: _PoolEntry, request: PlanRequest,
                   reason: str) -> None:
        """One ``drop`` per shed submission — plus the terminal
        ``deadline_miss`` for deadline-bearing requests, so event-derived
        hit rates count sheds exactly the way the benchmarks do."""
        if not self.sink:
            return
        now_v = self._now()
        pool = entry.spec.name
        self.sink.emit(Event(obs.DROP, ts=now_v, tenant=request.name,
                             pool=pool, sla=request.sla,
                             trace_id=request.trace, parent=obs.SUBMIT,
                             data={"reason": reason}))
        if math.isfinite(request.deadline):
            self.sink.emit(Event(
                obs.DEADLINE_MISS, ts=now_v, tenant=request.name,
                pool=pool, sla=request.sla,
                trace_id=request.trace, parent=obs.DROP,
                data={"deadline": request.deadline, "completion": None,
                      "reason": reason, "failed": True}))

    async def submit(self, request: Union[PlanRequest, DAG], *,
                     pool: Optional[str] = None) -> PlanResult:
        """Submit one planning request; resolves to its ``PlanResult``
        once the batch it rode in has been served.

        Raises ``LoadShedError`` when the request is shed (full queue, or
        admission control proved the guaranteed deadline infeasible) and
        ``ValueError`` on a malformed request."""
        if not self._running:
            raise RuntimeError("PlannerService is not running "
                               "(use 'async with service:' or await start())")
        request = _normalize_request(request, 0)
        check_demands(request)
        entry = self._route(request, pool)
        self.stats_counters.submitted += 1
        now_v = self._now()
        # stamp the causal trace id BEFORE the queue-full check, so shed
        # submissions still get a complete submit -> drop (-> miss) chain
        if request.trace is None:
            request = dataclasses.replace(request,
                                          trace=self._trace_ids.next())
        if self.sink:
            self.sink.emit(Event(
                obs.SUBMIT, ts=now_v, tenant=request.name,
                pool=entry.spec.name, sla=request.sla,
                trace_id=request.trace,
                data={"deadline": finite_or_none(request.deadline)}))
        if len(entry.pending) >= self.cfg.max_queue:
            self.stats_counters.shed_queue += 1
            self._emit_shed(entry, request, "queue_full")
            raise LoadShedError(
                f"pool {entry.spec.name!r}: backlog full "
                f"({len(entry.pending)} >= {self.cfg.max_queue})")
        cp_dur = 0.0
        if math.isfinite(request.deadline):
            # the same provable floor admission uses: release-aware
            # critical path of best-case durations against the full pool.
            # Off the loop thread: admit touches the session lock, which a
            # solve in flight can hold for the whole device dispatch
            decision = await asyncio.get_running_loop().run_in_executor(
                None, lambda: entry.session.admit(request, now=now_v))
            cp_dur = max(decision.completion_lower_bound - now_v, 0.0)
            if not math.isfinite(cp_dur):
                cp_dur = 0.0           # structurally doomed; don't let an
                #                        inf floor force an instant flush
            if (self.cfg.admission_control and not decision.admitted
                    and request.sla == SLA_GUARANTEED):
                self.stats_counters.shed_admission += 1
                self._emit_shed(entry, request, "admission")
                raise LoadShedError(
                    f"admission: {decision.reason}", decision)
        fut = asyncio.get_running_loop().create_future()
        # wall clock: submit_wall is wall-latency p50/p99 accounting
        entry.pending.append(_Pending(request, fut, now_v, time.monotonic(),
                                      cp_dur))
        entry.event.set()
        return await fut

    # -- flush policy --------------------------------------------------

    def _solve_estimate_v(self, entry: _PoolEntry, n: int) -> float:
        """Expected solve wall time for a batch of ``n``, in virtual
        seconds — the warmed bucket's measured steady latency when known,
        its warmup latency otherwise (an unwarmed flush will trace)."""
        bs = entry.session.stats.buckets.get(entry.session.bucket_for(n))
        for secs in ((bs.steady_seconds, bs.warmup_seconds) if bs else ()):
            if math.isfinite(secs):
                return secs * self.cfg.time_scale
        return 0.0

    def _flush_at(self, entry: _PoolEntry) -> Tuple[float, str]:
        """(virtual flush time, cause) for the current backlog — the
        earliest of the max-wait timer and (in "deadline" mode) the
        tightest admitted deadline's dispatch-by time."""
        cfg = self.cfg
        cands = [(entry.pending[0].submit_v + cfg.max_wait_s, "wait")]
        if cfg.flush == "deadline":
            est = self._solve_estimate_v(entry, len(entry.pending))
            for p in entry.pending:
                if math.isfinite(p.request.deadline):
                    cands.append((p.request.deadline - p.cp_dur - est
                                  - cfg.slack_margin_s, "deadline"))
        return min(cands)

    async def _flusher(self, entry: _PoolEntry) -> None:
        # supervised: a crashed flusher is restarted IN PLACE — the queue
        # deque survives, so no pending future is stranded and nothing is
        # re-submitted (the zero-retrace contract holds across a restart).
        # Past max_flusher_restarts the pending futures are failed loudly
        # and the exception re-raised so stop() surfaces the bug.
        while True:
            try:
                return await self._flusher_loop(entry)
            except asyncio.CancelledError:
                raise
            except BaseException as exc:
                if entry.restarts >= self.cfg.max_flusher_restarts:
                    while entry.pending:
                        p = entry.pending.popleft()
                        if not p.future.done():
                            p.future.set_exception(RuntimeError(
                                f"pool {entry.spec.name!r} flusher died: "
                                f"{exc!r}"))
                    raise
                entry.restarts += 1
                self.stats_counters.flusher_restarts += 1

    async def _flusher_loop(self, entry: _PoolEntry) -> None:
        cfg = self.cfg
        while True:
            if not entry.pending:
                entry.event.clear()
                if not self._running:
                    return
                await entry.event.wait()
                continue
            if len(entry.pending) >= cfg.max_batch:
                self._flush(entry, "fill")
                continue
            if not self._running:
                self._flush(entry, "drain")
                continue
            flush_at, cause = self._flush_at(entry)
            now_v = self._now()
            if now_v >= flush_at:
                self._flush(entry, cause)
                continue
            # sleep until the flush moment, but wake on any new submission
            # (it may fill the bucket or bring a tighter deadline)
            entry.event.clear()
            try:
                await asyncio.wait_for(entry.event.wait(),
                                       self._to_wall(flush_at - now_v))
            except asyncio.TimeoutError:
                pass

    def _flush(self, entry: _PoolEntry, cause: str) -> None:
        batch = [entry.pending.popleft()
                 for _ in range(min(len(entry.pending), self.cfg.max_batch))]
        setattr(self.stats_counters, f"flush_{cause}",
                getattr(self.stats_counters, f"flush_{cause}") + 1)
        self.stats_counters.batches += 1
        if self.sink:
            # batch-level span: members under data["trace_ids"] (see
            # repro_torch.obs.trace for the two-granularity convention)
            self.sink.emit(Event(
                obs.FLUSH, ts=self._now(), pool=entry.spec.name,
                data={"cause": cause, "n": len(batch),
                      "trace_ids": [p.request.trace for p in batch
                                    if p.request.trace]}))
        task = asyncio.create_task(
            self._dispatch(entry, batch, cause, time.time_ns()),
            name=f"dispatch-{entry.spec.name}-{self.stats_counters.batches}")
        self._dispatches.add(task)
        task.add_done_callback(self._dispatches.discard)

    # -- dispatch ------------------------------------------------------

    def _goal_for(self, request: PlanRequest, now_v: float) -> Optional[Goal]:
        """SLA class -> per-tenant goal for requests that carry none
        (mirrors ``flow.streaming.sla_goal``); deadlines are absolute on
        the service clock, the solver plans relative to the dispatch."""
        if request.goal is not None or request.sla == SLA_STANDARD:
            return request.goal
        base = self.agora.goal
        if request.sla == SLA_GUARANTEED:
            return dataclasses.replace(
                base, w=self.cfg.guaranteed_w,
                deadline=max(request.deadline - now_v, 1e-6),
                deadline_weight=self.cfg.deadline_weight)
        return dataclasses.replace(base, w=self.cfg.best_effort_w)

    @staticmethod
    def _batch_envelope(requests: Sequence[PlanRequest]) -> Tuple[int, int]:
        jmax = max(sum(d.num_tasks for d in r.dags) for r in requests)
        omax = max(len(t.options) for r in requests
                   for d in r.dags for t in d.tasks)
        return jmax, omax

    def _restart_pool(self, entry: _PoolEntry) -> None:
        """Recycle the pool's serving executor after a raising dispatch:
        the old worker thread may be wedged (a chaos delay, a poisoned
        solve), so the replacement starts clean and the old one drains in
        the background."""
        old = entry.executor
        entry.executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"planner-{entry.spec.name}")
        old.shutdown(wait=False)
        self.stats_counters.pool_restarts += 1

    def _revoked_capacity(self, now_v: float) -> Optional[np.ndarray]:
        """The chaos-shrunken capacity vector at ``now_v``, or ``None``
        when nothing is revoked (the default path passes no capacity, so
        it stays bit-for-bit).  The first observation of each revocation
        emits one ``capacity_revoked`` event."""
        fp = self._fault_plan
        if fp is None or not fp.cfg.revocations:
            return None
        for i, r in enumerate(fp.cfg.revocations):
            if i not in self._revoked_seen and r.active_at(now_v):
                self._revoked_seen.add(i)
                self.stats_counters.revocations += 1
                if self.sink:
                    self.sink.emit(Event(
                        obs.CAPACITY_REVOKED, ts=now_v,
                        data={"delta": [float(d) for d in r.delta],
                              "until": finite_or_none(r.until),
                              "caps_after": [
                                  float(c) for c in
                                  fp.caps_at(now_v, self._base_caps)]}))
        caps = fp.caps_at(now_v, self._base_caps)
        if np.allclose(caps, self._base_caps):
            return None
        return caps

    def _degraded_results(self, entry: _PoolEntry,
                          requests: Sequence[PlanRequest],
                          capacity=None) -> List[PlanResult]:
        """Greedy fallback plans: the airflow-style SGS baseline against
        the (possibly revoked) capacity — milliseconds of host work, no
        solver involvement.  Valid schedules, not annealed ones; every
        result is flagged ``degraded``."""
        from repro_torch.core.agora import Plan
        from repro_torch.core.annealer import reference_point
        from repro_torch.core.baselines import airflow_plan
        from repro_torch.core.dag import flatten

        t0 = time.monotonic()  # wall clock: degraded-path wall solve timing
        cluster = entry.session._cluster_for(capacity)
        out = []
        for i, r in enumerate(requests):
            problem = flatten(list(r.dags), cluster.num_resources)
            sol = airflow_plan(problem, cluster)
            plan = Plan(problem, sol, r.goal or entry.session.goal, cluster,
                        reference_point(problem, cluster))
            out.append(PlanResult(plan, r, index=i, bucket=0,
                                  # wall clock: wall solve seconds
                                  solve_seconds=time.monotonic() - t0,
                                  degraded=True))
        return out

    def _finish_batch(self, entry: _PoolEntry, batch: List[_Pending],
                      results: Sequence[PlanResult], cause: str, *,
                      warm: bool, degraded: bool = False,
                      phases: Optional[Tuple[int, int, int]] = None) -> None:
        """Resolve the batch's futures and narrate the outcome: one
        dispatch event (wall latencies feed the aggregator's p50/p99),
        plus the per-request plan-level deadline verdict — virtual
        delivery time + planned completion vs the absolute deadline, the
        same verdict the benchmarks compute post-hoc. ``phases`` are the
        ``time.time_ns()`` of the flush and of the solving attempt's start
        and end on the pool's worker thread (so ``daemon.wait`` holds any
        failed attempts and injected delays before it)."""
        t_back = time.time_ns()
        pool = entry.spec.name
        wall = time.monotonic()  # wall clock: dispatch wall latency (p50/p99)
        done_v = self._now()
        latencies = [wall - p.submit_wall for p in batch]
        for p, res in zip(batch, results):
            if not p.future.done():
                p.future.set_result(res)
        self.stats_counters.served += len(batch)
        if degraded:
            self.stats_counters.degraded_served += len(batch)
        if self.sink:
            data = {"mode": "daemon", "cause": cause, "n": len(batch),
                    "warm": warm, "latency_s": latencies,
                    "trace_ids": [p.request.trace for p in batch
                                  if p.request.trace]}
            if degraded:
                data["degraded"] = True
            if phases is not None:
                t_flush, t_run, t_ret = phases
                data["spans"] = [["daemon.wait", t_flush, t_run, None],
                                 ["daemon.solve", t_run, t_ret, None],
                                 ["daemon.return", t_ret, t_back, None]]
            self.sink.emit(Event(obs.DISPATCH, ts=done_v, pool=pool,
                                 data=data))
            for p, res in zip(batch, results):
                if math.isfinite(p.request.deadline):
                    completion = done_v + float(
                        res.plan.solution.finish.max())
                    hit = completion <= p.request.deadline + 1e-6
                    self.sink.emit(Event(
                        obs.DEADLINE_HIT if hit else obs.DEADLINE_MISS,
                        ts=done_v, tenant=p.request.name, pool=pool,
                        sla=p.request.sla,
                        trace_id=p.request.trace, parent=obs.DISPATCH,
                        data={"deadline": p.request.deadline,
                              "completion": completion, "failed": False}))

    async def _dispatch(self, entry: _PoolEntry, batch: List[_Pending],
                        cause: str, flushed_ns: int) -> None:
        now_v = self._now()
        pool = entry.spec.name
        tids = [p.request.trace for p in batch if p.request.trace]
        requests = [
            dataclasses.replace(p.request, goal=self._goal_for(p.request,
                                                               now_v))
            if p.request.goal is None else p.request
            for p in batch]
        capacity = self._revoked_capacity(now_v)

        # circuit breaker: while the pool is open and still cooling down,
        # the solver is not trusted — serve the greedy fallback instead of
        # shedding the batch.  (A fallback failure falls through to the
        # solve path: degradation must never strand a future.)
        if (entry.breaker.allow(now_v) == "degrade"
                and self.cfg.degraded_serve):
            try:
                results = self._degraded_results(entry, requests, capacity)
            except Exception:  # noqa: BLE001 — fall through to the solver
                pass
            else:
                self._finish_batch(entry, batch, results, cause,
                                   warm=True, degraded=True)
                return

        jmax, omax = self._batch_envelope(requests)
        warm = entry.session.is_warm(len(requests), jmax, omax)
        executor = entry.executor
        if not warm:
            # envelope exit: trace on the widen thread so this pool's
            # serving executor keeps flowing warm batches, and pre-warm
            # the NEXT bucket so sustained growth stays ahead of traffic
            self.stats_counters.widen_events += 1
            if self.sink:
                self.sink.emit(Event(
                    obs.ENVELOPE_WIDENED, ts=now_v, pool=pool,
                    data={"bucket": entry.session.bucket_for(len(requests)),
                          "jmax": jmax, "omax": omax,
                          "warmed": sorted(entry.session.envelopes)}))
            executor = self._widen_pool
        loop = asyncio.get_running_loop()
        exc: Optional[BaseException] = None
        results = None

        def solve():
            # the worker thread's start and end of the solve, on the
            # profiler's clock
            t_run = time.time_ns()
            res = entry.session.plan(requests, capacity=capacity)
            return res, t_run, time.time_ns()

        t0 = time.monotonic()  # wall clock: breaker latency is wall seconds
        for attempt in range(1 + self.cfg.solve_retries):
            # chaos verdict, one draw per ATTEMPT (retries re-roll): an
            # injected solver error or a solve-latency spike
            fault = (self._fault_plan.solve_fault()
                     if self._fault_plan is not None else None)
            if fault is not None:
                self.stats_counters.faults_injected += 1
                if self.sink:
                    self.sink.emit(Event(
                        obs.FAULT_INJECTED, ts=self._now(), pool=pool,
                        data={"kind": f"solver_{fault.kind}",
                              "delay_s": fault.delay_s,
                              "attempt": attempt, "trace_ids": tids}))
                if fault.kind == "delay":
                    await asyncio.sleep(self._to_wall(fault.delay_s))
            t0 = time.monotonic()  # wall clock: per-attempt wall solve timing
            try:
                if fault is not None and fault.kind == "error":
                    raise InjectedFault("chaos: solver error")
                results, t_run, t_ret = await loop.run_in_executor(
                    executor, solve)
                break
            except Exception as e:  # noqa: BLE001 — supervised below
                exc = e
                self.stats_counters.errors += 1
                if entry.breaker.record_failure(self._now()) and self.sink:
                    self.sink.emit(Event(
                        obs.POOL_DEGRADED, ts=self._now(), pool=pool,
                        parent=(obs.FAULT_INJECTED
                                if isinstance(e, InjectedFault) else None),
                        data={"state": entry.breaker.state,
                              "failures": entry.breaker.failures,
                              "error": repr(e), "trace_ids": tids}))
                # the worker thread may be wedged: recycle the pool
                # executor before the retry (the shared widen thread is
                # left alone)
                if executor is entry.executor:
                    self._restart_pool(entry)
                    executor = entry.executor

        if results is not None:
            note = entry.breaker.record_success(self._now(),
                                                # wall clock: wall seconds
                                                time.monotonic() - t0)
            if self.sink and note == "recovered":
                # the probe's chain carries the recovery span
                self.sink.emit(Event(
                    obs.POOL_RECOVERED, ts=self._now(), pool=pool,
                    data={"state": entry.breaker.state,
                          "trace_ids": tids}))
            elif self.sink and note == "opened":
                self.sink.emit(Event(
                    obs.POOL_DEGRADED, ts=self._now(), pool=pool,
                    data={"state": entry.breaker.state,
                          "failures": entry.breaker.failures,
                          "reason": "latency",
                          # wall clock: breaker wall latency
                          "latency_s": time.monotonic() - t0,
                          "trace_ids": tids}))
            self._finish_batch(entry, batch, results, cause, warm=warm,
                               phases=(flushed_ns, t_run, t_ret))
            if not warm and self.cfg.auto_widen and self._running:
                self._pre_warm_next(entry, requests, jmax, omax)
            return

        # every solve attempt failed: degraded fallback when allowed,
        # typed per-future errors otherwise — NEVER a stranded future
        if self.cfg.degraded_serve:
            try:
                dres = self._degraded_results(entry, requests, capacity)
            except Exception as e:  # noqa: BLE001 — fall through, typed
                exc = e
            else:
                self._finish_batch(entry, batch, dres, cause,
                                   warm=warm, degraded=True)
                return
        if self.sink:
            for p in batch:
                self.sink.emit(Event(
                    obs.DROP, ts=self._now(), tenant=p.request.name,
                    pool=pool, sla=p.request.sla,
                    trace_id=p.request.trace, parent=obs.FLUSH,
                    data={"reason": "solve_error", "error": repr(exc)}))
        err = PlanServiceError(
            f"pool {pool!r}: batch solve failed after "
            f"{1 + self.cfg.solve_retries} attempts: {exc!r}", exc)
        for p in batch:
            if not p.future.done():
                p.future.set_exception(err)

    def _pre_warm_next(self, entry: _PoolEntry,
                       requests: Sequence[PlanRequest],
                       jmax: int, omax: int) -> None:
        """Background-compile the next bucket up at this batch's shape —
        only meaningful when a single request reproduces the envelope
        (heterogeneous shapes can't be warmed from one template)."""
        nxt = entry.session.bucket_for(len(requests)) << 1
        for r in requests:
            if (sum(d.num_tasks for d in r.dags) == jmax
                    and max(len(t.options) for d in r.dags
                            for t in d.tasks) == omax):
                entry.session.warmup_async(
                    dataclasses.replace(r, goal=None),
                    buckets=[nxt], executor=self._widen_pool)
                return

    # -- observability -------------------------------------------------

    def latency_percentiles(self,
                            qs: Sequence[float] = (50.0, 99.0)
                            ) -> Dict[str, float]:
        """Submit-to-plan WALL latency percentiles, seconds — derived
        from the event plane (the ``dispatch`` events' latency payloads),
        not a separate counter."""
        return self.aggregator.latency_percentiles(qs)

    def stats(self) -> Dict[str, Any]:
        """One aggregated snapshot: daemon counters, wall-latency
        percentiles, every pool session's zero-retrace evidence, and the
        event-plane roll-up (``events`` block, from the same aggregator
        the benchmarks gate on)."""
        pools = {}
        trace_count = cache_hits = warmups = 0
        for name, entry in self.entries.items():
            st = entry.session.stats
            trace_count += st.trace_count
            cache_hits += st.cache_hits
            warmups += st.warmups
            pools[name] = {
                "trace_count": st.trace_count,
                "cache_hits": st.cache_hits,
                "plans": st.plans,
                "warmups": st.warmups,
                "pending": len(entry.pending),
                "breaker": entry.breaker.state,
                "breaker_failures": entry.breaker.failures,
                "flusher_restarts": entry.restarts,
                "envelopes": sorted(entry.session.envelopes),
                "buckets": {
                    str(b): {"plans": bs.plans, "traces": bs.traces,
                             "cache_hits": bs.cache_hits,
                             "warmup_s": bs.warmup_seconds,
                             "steady_s": bs.steady_seconds}
                    for b, bs in sorted(st.buckets.items())},
            }
        return {
            "running": self._running,
            "trace_count": trace_count,
            "cache_hits": cache_hits,
            "warmups": warmups,
            "latency": self.latency_percentiles(),
            **dataclasses.asdict(self.stats_counters),
            "pools": pools,
            "events": self.aggregator.snapshot(),
        }


# ---------------------------------------------------------------------------
# Prometheus exposition (GET /v1/metrics)
# ---------------------------------------------------------------------------


def _prom_escape(value: Any) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _prom(name: str, value: Any,
          labels: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """One sample line, or ``None`` when there is no value to expose
    (Prometheus has no null — absent beats fabricated)."""
    if value is None:
        return None
    lab = ""
    if labels:
        lab = ("{" + ",".join(f'{k}="{_prom_escape(v)}"'
                              for k, v in labels.items()) + "}")
    return f"{name}{lab} {float(value):g}"


def _quantile_label(pkey: str) -> str:
    # aggregator keys are "p50" / "p99"; Prometheus wants 0.5 / 0.99
    return f"{float(pkey[1:]) / 100.0:g}"


def metrics_text(stats: Dict[str, Any]) -> str:
    """Render one ``PlannerService.stats()`` snapshot in the Prometheus
    text exposition format (0.0.4) — the body of ``GET /v1/metrics``.

    A pure function of the snapshot dict, so tests and offline tooling
    render recorded snapshots without a live daemon.  Quantiles with no
    samples yet (the aggregator's explicit ``None``s) are omitted, never
    faked as zeros."""
    ev_block: Dict[str, Any] = stats.get("events") or {}
    lines: List[str] = []

    def family(name: str, help_: str, type_: str,
               samples: Sequence[Optional[str]]) -> None:
        kept = [s for s in samples if s is not None]
        if not kept:
            return
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {type_}")
        lines.extend(kept)

    family("planner_up", "Whether the planner service is running.", "gauge",
           [_prom("planner_up", 1.0 if stats.get("running") else 0.0)])
    for key, help_ in (
            ("submitted", "Requests submitted at the front door."),
            ("served", "Requests served with a plan."),
            ("shed_queue", "Requests shed on a full backlog."),
            ("shed_admission", "Requests shed by admission control."),
            ("batches", "Batches flushed to the solver."),
            ("widen_events", "Batches that exited the warmed envelope."),
            ("errors", "Solve attempts that raised."),
            ("pool_restarts",
             "Serving executors recycled after a raising dispatch."),
            ("flusher_restarts", "Supervised flusher revivals."),
            ("degraded_served",
             "Requests served by the greedy fallback path."),
            ("faults_injected", "Chaos-harness fault injections."),
            ("revocations", "Capacity revocations applied."),
    ):
        family(f"planner_{key}_total", help_, "counter",
               [_prom(f"planner_{key}_total", stats.get(key, 0))])
    family("planner_flush_total", "Batch flushes by cause.", "counter",
           [_prom("planner_flush_total", stats.get(f"flush_{cause}", 0),
                  {"cause": cause})
            for cause in ("fill", "deadline", "wait", "drain")])
    family("planner_retraces_total",
           "Non-warming JIT traces (zero-retrace contract violations "
           "when > 0 inside the warmed envelope).", "counter",
           [_prom("planner_retraces_total", ev_block.get("retraces"))])
    family("planner_warmup_traces_total", "Warming JIT traces.", "counter",
           [_prom("planner_warmup_traces_total",
                  ev_block.get("warmup_traces"))])
    family("planner_cache_hits_total", "Batches served off warmed cache "
           "entries.", "counter",
           [_prom("planner_cache_hits_total", ev_block.get("cache_hits"))])
    family("planner_events_total",
           "Observability events folded, by type.", "counter",
           [_prom("planner_events_total", n, {"type": t})
            for t, n in sorted((ev_block.get("counts") or {}).items())])
    family("planner_latency_seconds",
           "Submit-to-plan wall latency (from dispatch events).", "summary",
           [_prom("planner_latency_seconds", v,
                  {"quantile": _quantile_label(q)})
            for q, v in sorted((stats.get("latency") or {}).items())])
    deadline = ev_block.get("deadline") or {}
    family("planner_deadline_hits_total",
           "Finite-deadline requests that met their deadline, by declared "
           "SLA class.", "counter",
           [_prom("planner_deadline_hits_total", d.get("hits"), {"sla": sla})
            for sla, d in sorted(deadline.items())])
    family("planner_deadline_misses_total",
           "Finite-deadline requests that missed, by declared SLA class.",
           "counter",
           [_prom("planner_deadline_misses_total", d.get("misses"),
                  {"sla": sla}) for sla, d in sorted(deadline.items())])
    family("planner_deadline_hit_rate",
           "Deadline hit rate by declared SLA class.", "gauge",
           [_prom("planner_deadline_hit_rate", d.get("rate"), {"sla": sla})
            for sla, d in sorted(deadline.items())])
    conv = ev_block.get("convergence") or {}
    family("planner_solve_profiles_total",
           "Per-request convergence profiles folded from solve_profile "
           "events.", "counter",
           [_prom("planner_solve_profiles_total", conv.get("profiles"))])
    family("planner_convergence_steps_to_best",
           "Annealer sweeps until the final best energy was first reached.",
           "summary",
           [_prom("planner_convergence_steps_to_best", v,
                  {"quantile": _quantile_label(q)})
            for q, v in sorted((conv.get("steps_to_best") or {}).items())])
    family("planner_convergence_plateau_fraction",
           "Mean fraction of sampled sweeps already at the final best "
           "energy (high = budget wasted on a plateau).", "gauge",
           [_prom("planner_convergence_plateau_fraction",
                  conv.get("plateau_fraction"))])
    family("planner_convergence_accept_decay",
           "Mean first-to-last acceptance-rate drop across the schedule.",
           "gauge",
           [_prom("planner_convergence_accept_decay",
                  conv.get("accept_decay"))])
    pools = stats.get("pools") or {}
    family("planner_pool_pending", "Queued submissions per pool.", "gauge",
           [_prom("planner_pool_pending", p.get("pending"), {"pool": name})
            for name, p in sorted(pools.items())])
    family("planner_pool_degraded",
           "Whether the pool's circuit breaker is open (1 = serving "
           "greedy fallback plans).", "gauge",
           [_prom("planner_pool_degraded",
                  0.0 if p.get("breaker", "closed") == "closed" else 1.0,
                  {"pool": name}) for name, p in sorted(pools.items())])
    family("planner_pool_traces_total", "JIT traces per pool session.",
           "counter",
           [_prom("planner_pool_traces_total", p.get("trace_count"),
                  {"pool": name}) for name, p in sorted(pools.items())])
    family("planner_pool_cache_hits_total",
           "Warmed-cache hits per pool session.", "counter",
           [_prom("planner_pool_cache_hits_total", p.get("cache_hits"),
                  {"pool": name}) for name, p in sorted(pools.items())])
    family("planner_pool_plans_total", "Solved batches per pool session.",
           "counter",
           [_prom("planner_pool_plans_total", p.get("plans"),
                  {"pool": name}) for name, p in sorted(pools.items())])
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# JSON wire format (the non-Python adapter's schema)
# ---------------------------------------------------------------------------


def dag_to_json(dag: DAG) -> dict:
    return {
        "name": dag.name,
        "release_time": dag.release_time,
        "tasks": [{
            "name": t.name,
            "default_option": t.default_option,
            "options": [{"label": o.label, "duration": o.duration,
                         "demands": list(o.demands), "cost": o.cost}
                        for o in t.options],
        } for t in dag.tasks],
        "edges": [[a, b] for a, b in dag.edges],
    }


def dag_from_json(obj: dict) -> DAG:
    tasks = [Task(t["name"],
                  [TaskOption(o["label"], float(o["duration"]),
                              tuple(float(d) for d in o["demands"]),
                              float(o["cost"]))
                   for o in t["options"]],
                  default_option=int(t.get("default_option", 0)))
             for t in obj["tasks"]]
    edges = [(int(a), int(b)) for a, b in obj.get("edges", [])]
    return DAG(obj["name"], tasks, edges,
               release_time=float(obj.get("release_time", 0.0)))


def request_from_json(obj: dict) -> PlanRequest:
    if "dags" in obj:
        dag = tuple(dag_from_json(d) for d in obj["dags"])
    else:
        dag = dag_from_json(obj["dag"])
    deadline = obj.get("deadline")
    sla = obj.get("sla", SLA_STANDARD)
    if sla not in SLA_CLASSES:
        raise ValueError(f"unknown SLA class {sla!r}")
    return PlanRequest(dag=dag, sla=sla,
                       deadline=math.inf if deadline is None
                       else float(deadline),
                       trace=obj.get("trace"))


def plan_result_to_json(res: PlanResult) -> dict:
    sol = res.plan.solution
    prob = res.plan.problem
    return {
        "request": res.request.name if res.request else None,
        "bucket": res.bucket,
        "traced": bool(res.traced),
        "solve_seconds": res.solve_seconds,
        "makespan": float(res.makespan),
        "cost": float(res.cost),
        "tasks": [t.name for t in prob.tasks],
        "option_idx": np.asarray(sol.option_idx).tolist(),
        "option_labels": [t.options[int(o)].label for t, o in
                          zip(prob.tasks, np.asarray(sol.option_idx))],
        "start": np.asarray(sol.start, float).tolist(),
        "finish": np.asarray(sol.finish, float).tolist(),
        "errors": res.plan.validate(),
    }


# ---------------------------------------------------------------------------
# Thin JSON-over-HTTP adapter
# ---------------------------------------------------------------------------


class PlannerHTTPServer:
    """Minimal HTTP/1.1 front for ``PlannerService`` (stdlib-only; one
    request per connection).

    * ``POST /v1/plan``  — body ``{"dag": {...}}`` (or ``"dags"``), plus
      optional ``"sla"``, ``"deadline"``, ``"pool"``; 200 with the plan
      JSON, 429 when shed, 400 on malformed input.
    * ``GET /v1/stats``  — the aggregated ``PlannerService.stats()``.
    * ``GET /v1/metrics`` — the same snapshot in Prometheus text
      exposition format (``text/plain; version=0.0.4``), scrapable.
    * ``GET /healthz``   — liveness.

    Hardened against slow and oversized clients: a connection that has
    not delivered its full request within ``read_timeout_s`` gets 408 (a
    stalled peer must not pin the handler), and a declared body larger
    than ``max_body`` gets 413 without reading it.
    """

    def __init__(self, service: PlannerService, host: str = "127.0.0.1",
                 port: int = 0, *, read_timeout_s: float = 30.0,
                 max_body: int = 1 << 20):
        self.service = service
        self.host = host
        self.port = port
        self.read_timeout_s = float(read_timeout_s)
        self.max_body = int(max_body)
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            status, payload = await self._respond(reader)
        except Exception as exc:  # noqa: BLE001 — wire errors -> 500
            status, payload = 500, {"error": str(exc)}
        if isinstance(payload, str):
            # pre-rendered text body (the Prometheus exposition)
            body = payload.encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            body = json.dumps(payload).encode()
            ctype = "application/json"
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  408: "Request Timeout", 413: "Payload Too Large",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        try:
            await writer.drain()
        finally:
            writer.close()

    async def _read_request(self, reader: asyncio.StreamReader):
        """Parse one request off the wire; returns ``(parsed, error)``
        where exactly one is non-None.  Enforces ``max_body`` BEFORE
        reading the body — an oversized declaration costs no memory."""
        request_line = (await reader.readline()).decode("latin-1").strip()
        if not request_line:
            return None, (400, {"error": "empty request"})
        try:
            method, path, _ = request_line.split(" ", 2)
        except ValueError:
            return None, (400, {"error": f"malformed request line "
                                         f"{request_line!r}"})
        headers: Dict[str, str] = {}
        while True:
            line = (await reader.readline()).decode("latin-1").strip()
            if not line:
                break
            key, _, value = line.partition(":")
            headers[key.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            return None, (400, {"error": "malformed content-length"})
        if length > self.max_body:
            return None, (413, {"error": f"body of {length} bytes exceeds "
                                         f"max_body {self.max_body}"})
        body = await reader.readexactly(length) if length > 0 else b""
        return (method, path, headers, body), None

    async def _respond(self, reader: asyncio.StreamReader
                       ) -> Tuple[int, Union[dict, str]]:
        # the timeout covers the READ only — a legitimate long-running
        # plan solve after parsing is not a slow client
        try:
            parsed, err = await asyncio.wait_for(
                self._read_request(reader), self.read_timeout_s)
        except asyncio.TimeoutError:
            return 408, {"error": f"request not received within "
                                  f"{self.read_timeout_s:g}s"}
        except asyncio.IncompleteReadError:
            return 400, {"error": "connection closed mid-body"}
        if err is not None:
            return err
        method, path, headers, body = parsed

        if method == "GET" and path == "/healthz":
            return 200, {"ok": True, "running": self.service._running}
        if method == "GET" and path == "/v1/stats":
            return 200, self.service.stats()
        if method == "GET" and path == "/v1/metrics":
            return 200, metrics_text(self.service.stats())
        if method == "POST" and path == "/v1/plan":
            if not self.service._running:
                return 503, {"error": "service not running"}
            try:
                obj = json.loads(body or b"{}")
                request = request_from_json(obj)
            except (ValueError, KeyError, TypeError) as exc:
                return 400, {"error": f"malformed request: {exc}"}
            try:
                result = await self.service.submit(request,
                                                   pool=obj.get("pool"))
            except LoadShedError as exc:
                return 429, {"error": str(exc), "shed": True}
            except ValueError as exc:
                return 400, {"error": str(exc)}
            return 200, plan_result_to_json(result)
        return 404, {"error": f"no route {method} {path}"}
