"""Workflow executor — the Airflow analogue that runs AGORA plans (PyTorch
port).

Two modes share one event loop:

* simulated  — discrete-event virtual clock (the paper's macro-benchmark
  mode): durations come from the plan, perturbed by injected noise /
  stragglers / failures.
* real       — tasks carry Python callables (e.g. PyTorch train steps)
  executed on a worker thread pool; the virtual clock follows wall time.

Fault tolerance:
  * retries with capped exponential backoff on task failure;
  * speculative re-execution: a task running past ``speculate_factor`` x its
    predicted duration gets a duplicate; first finisher wins (straggler
    mitigation);
  * workflow state checkpointing (JSON) for restart-after-crash; completed
    tasks are never re-run;
  * elastic + straggler re-planning via ``Agora.replan`` when the resource
    pool resizes or predictions drift (re-plan triggers of §5.5.1).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import math
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.agora import Agora, Plan
from repro_torch.core.session import PlanRequest
from repro_torch.obs import events as obs
from repro_torch.obs.events import Event
from repro_torch.obs.trace import TraceIds


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    mode: str = "sim"                  # "sim" | "real"
    max_retries: int = 2
    retry_backoff: float = 0.0         # base delay; doubles per attempt
    retry_backoff_cap: float = 300.0   # ceiling on the backoff delay
    failure_rate: float = 0.0          # sim: per-attempt failure probability
    straggler_rate: float = 0.0        # sim: probability of a slow attempt
    straggler_slowdown: float = 4.0
    speculate_factor: float = 2.0      # duplicate when runtime > f * predicted
    speculation: bool = True
    noise_sigma: float = 0.0           # sim: lognormal duration noise
    seed: int = 0
    state_path: Optional[str] = None   # workflow checkpoint file
    replan_on_straggler: bool = False
    # streaming control plane: first launches at virtual time >= the horizon
    # are withheld (tasks already launched run to completion, retries and
    # speculative duplicates included) so the control plane can re-plan the
    # unlaunched remainder on the next arrival instead of draining the batch
    launch_horizon: float = math.inf
    # tasks exempt from the horizon (guaranteed-class tenants keep
    # launching through a cut: yielding is for classes that can afford it)
    horizon_exempt: Tuple[int, ...] = ()
    # gate launches on ACTUAL pool availability at dispatch time (planned
    # starts alone cannot protect the pool once runtime noise inflates a
    # predecessor's duration past its planned window)
    enforce_capacity: bool = False
    # decorrelate retry storms: stretch each backoff delay by a seeded
    # factor in [1, 1 + retry_jitter].  The draw is keyed by (seed, caller
    # key, attempt), never shortens a delay, and the default 0.0 keeps the
    # historical delays bit-for-bit.
    retry_jitter: float = 0.0
    # chaos harness (repro_torch.flow.chaos.ChaosConfig): its revocation
    # timeline shrinks the capacity vector mid-run, killing enough running
    # work to fit and re-enqueueing it through the standard retry/backoff
    # machinery.  None (default) = the pre-chaos executor, bit-for-bit.
    chaos: Optional[Any] = None
    # hard launch cut (a capacity-revocation instant): NO first launches at
    # or past it, ``horizon_exempt`` included — unlike ``launch_horizon``,
    # which guaranteed-class tenants may cross.  The streaming control
    # plane replans everything beyond the cut against the shrunken pool.
    hard_horizon: float = math.inf


def _backoff_delay(cfg: FlowConfig, attempt: int, key: int = 0) -> float:
    """Capped exponential retry backoff, shared by task-level retries
    (FlowRunner), plan-level retries (MultiTenantRunner), and the
    streaming requeue/preemption delays.  ``key`` decorrelates the
    optional jitter across callers (task index, crc32 of a tenant name);
    with ``cfg.retry_jitter == 0`` it is inert."""
    if cfg.retry_backoff <= 0:
        return 0.0
    delay = min(cfg.retry_backoff_cap,
                cfg.retry_backoff * 2.0 ** (attempt - 1))
    if cfg.retry_jitter > 0.0:
        rng = np.random.default_rng(
            [int(cfg.seed) & 0xFFFFFFFF, int(key) & 0xFFFFFFFF,
             int(attempt) & 0xFFFFFFFF, 0xB0FF])
        delay *= 1.0 + cfg.retry_jitter * float(rng.random())
    return delay


def _jitter_key(name: str) -> int:
    """Stable per-tenant jitter key (crc32, NOT ``hash`` — that one is
    process-salted and would break run-to-run reproducibility)."""
    return zlib.crc32(name.encode())


@dataclasses.dataclass
class TaskRun:
    task: int
    attempt: int
    start: float
    expected_end: float
    speculative: bool = False
    # set when a capacity revocation kills this run mid-flight: its queued
    # finish/fail/speculate events are stale and must be ignored on pop
    dead: bool = False


@dataclasses.dataclass
class FlowResult:
    makespan: float
    cost: float
    task_start: Dict[int, float]
    task_finish: Dict[int, float]
    retries: int
    speculations: int
    replans: int
    events: List[str]
    # per-task accounting (lets a joint shared-cluster run be split back
    # into per-tenant records)
    task_retries: Dict[int, int] = dataclasses.field(default_factory=dict)
    task_speculations: Dict[int, int] = dataclasses.field(default_factory=dict)
    task_cost: Dict[int, float] = dataclasses.field(default_factory=dict)
    # tasks withheld by cfg.launch_horizon: never launched, not billed —
    # the streaming control plane re-plans and re-dispatches them later
    unlaunched: List[int] = dataclasses.field(default_factory=list)
    # running attempts killed by capacity revocations (spot preemption);
    # each kill also counts as a retry on the task that lost the work
    kills: int = 0


class FlowRunner:
    def __init__(self, plan: Plan, cfg: Optional[FlowConfig] = None,
                 fns: Optional[Dict[int, Callable[[], Any]]] = None,
                 agora: Optional[Agora] = None):
        self.plan = plan
        self.cfg = cfg or FlowConfig()
        self.fns = fns or {}
        self.agora = agora
        self.rng = np.random.default_rng(self.cfg.seed)
        self.events: List[str] = []
        self.done: Dict[int, float] = {}     # task -> finish time
        self.started: Dict[int, float] = {}
        self.retries = 0
        self.speculations = 0
        self.replans = 0
        self.kills = 0

    # ------------------------------------------------------------------

    def _log(self, t: float, msg: str):
        self.events.append(f"[t={t:9.1f}] {msg}")

    def _load_state(self):
        p = self.cfg.state_path
        if p and os.path.exists(p):
            with open(p) as f:
                st = json.load(f)
            self.done = {int(k): v for k, v in st.get("done", {}).items()}
            self.started = {int(k): v for k, v in st.get("started", {}).items()}
            self._log(0.0, f"restored workflow state: {len(self.done)} tasks done")

    def _save_state(self):
        p = self.cfg.state_path
        if p:
            tmp = p + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"done": self.done, "started": self.started}, f)
            os.replace(tmp, p)

    # ------------------------------------------------------------------

    def _duration(self, j: int) -> float:
        sol = self.plan.solution
        base = float(sol.finish[j] - sol.start[j])
        if self.cfg.mode == "real":
            return base
        d = base
        if self.cfg.noise_sigma > 0:
            d *= float(self.rng.lognormal(0.0, self.cfg.noise_sigma))
        if self.rng.random() < self.cfg.straggler_rate:
            d *= self.cfg.straggler_slowdown
        return d

    def _attempt_fails(self) -> bool:
        return (self.cfg.mode == "sim"
                and self.rng.random() < self.cfg.failure_rate)

    def run(self) -> FlowResult:
        cfg = self.cfg
        problem = self.plan.problem
        J = problem.num_tasks
        preds = [[] for _ in range(J)]
        for a, b in problem.edges:
            preds[b].append(a)
        self._load_state()

        oi = self.plan.solution.option_idx
        task_dem = problem.chosen_options(oi)[1]
        base_caps = np.asarray(self.plan.cluster.caps, float)
        # chaos revocation timeline (None when no chaos attached — the
        # default path never consults it): ``caps`` is rebound at every
        # revocation instant, and the closures below read the live value
        chaos_plan = (cfg.chaos.compile()
                      if cfg.chaos is not None
                      and getattr(cfg.chaos, "revocations", ()) else None)
        caps = (chaos_plan.caps_at(0.0, base_caps)
                if chaos_plan is not None else base_caps)
        usage = np.zeros(len(caps))        # live demand of running attempts

        clock = 0.0
        # event heap: (time, seq, kind, payload)
        heap: List[Tuple[float, int, str, Any]] = []
        seq = 0
        attempts: Dict[int, int] = {j: 0 for j in range(J)}
        task_retries: Dict[int, int] = {j: 0 for j in range(J)}
        task_specs: Dict[int, int] = {j: 0 for j in range(J)}
        running: Dict[int, List[TaskRun]] = {}
        backing_off: set = set()           # tasks waiting out a retry delay
        backoff_idle: Dict[int, float] = {}  # per-task accumulated delay
        capacity_waiting: set = set()      # ready tasks the pool cannot fit

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        def ready_tasks():
            out = []
            for j in range(J):
                if (j in self.done or j in running or j in backing_off
                        or j in capacity_waiting):
                    continue
                if all(p in self.done for p in preds[j]):
                    if float(problem.release[j]) <= clock + 1e-9:
                        out.append(j)
                    else:
                        push(float(problem.release[j]), "release", j)
            return out

        def horizon_open(j):
            # the launch horizon withholds FIRST launches only: an already
            # launched task keeps its retries/duplicates so it always runs
            # to completion within this dispatch
            if attempts[j] == 0 and clock >= cfg.hard_horizon - 1e-9:
                # the hard cut admits NO first launches, exemptions
                # included: past it the pool may already be revoked
                return False
            return (clock < cfg.launch_horizon - 1e-9 or attempts[j] > 0
                    or j in cfg.horizon_exempt)

        def fits(j):
            if not cfg.enforce_capacity:
                return True
            if np.all(usage + task_dem[j] <= caps + 1e-6):
                return True
            # an empty pool is the best the executor can offer: a task too
            # large for the whole cluster must not deadlock the workflow
            return not running

        def launch(j, speculative=False):
            nonlocal usage
            attempts[j] += 1
            dur = self._duration(j)
            fail = self._attempt_fails()
            run = TaskRun(j, attempts[j], clock, clock + dur, speculative)
            running.setdefault(j, []).append(run)
            usage = usage + task_dem[j]
            if self.cfg.mode == "real" and j in self.fns:
                # real mode runs user callables on the host: measured wall
                # durations ARE the ground truth here, not virtual time
                t0 = time.monotonic()  # wall clock: real-mode wall measurement
                try:
                    self.fns[j]()
                    dur = time.monotonic() - t0  # wall clock: real-mode wall
                    fail = False
                except Exception as e:  # noqa: BLE001
                    dur = time.monotonic() - t0  # wall clock: real-mode wall
                    fail = True
                    self._log(clock, f"task {j} raised: {e}")
                run.expected_end = clock + dur
            kind = "fail" if fail else "finish"
            push(clock + dur, kind, run)
            if cfg.speculation and not speculative:
                predicted = float(self.plan.solution.finish[j]
                                  - self.plan.solution.start[j])
                push(clock + cfg.speculate_factor * predicted, "speculate", run)
            self.started.setdefault(j, clock)
            self._log(clock, f"launch task {j} attempt {attempts[j]}"
                             f"{' (speculative)' if speculative else ''}")

        def try_launch(j):
            """Dispatch-time gates: launch horizon, then ACTUAL pool
            availability (cfg.enforce_capacity) — planned starts alone
            cannot protect the pool once realized durations drift."""
            if not horizon_open(j):
                return
            if not fits(j):
                if j not in capacity_waiting:
                    capacity_waiting.add(j)
                    self._log(clock, f"task {j} waits for pool capacity")
                return
            capacity_waiting.discard(j)
            launch(j)

        def release_usage(runs):
            nonlocal usage
            for r in runs:
                usage = usage - task_dem[r.task]

        def rescan_capacity():
            # deterministic wake order: planned start, then index
            for j in sorted(capacity_waiting,
                            key=lambda x: (float(self.plan.solution.start[x]),
                                           x)):
                if (j not in self.done and j not in running
                        and j not in backing_off and horizon_open(j)
                        and all(p in self.done for p in preds[j])
                        and fits(j)):
                    capacity_waiting.discard(j)
                    launch(j)

        if chaos_plan is not None:
            # one heap event per capacity change: the revocation landing
            # and (when finite) its expiry — both re-derive ``caps`` from
            # the timeline, so overlapping revocations compose correctly
            for r in cfg.chaos.revocations:
                if r.at > 0.0:
                    push(float(r.at), "revoke", r)
                if math.isfinite(r.until):
                    push(float(r.until), "revoke", r)

        for j in ready_tasks():
            try_launch(j)

        while heap:
            clock, _, kind, payload = heapq.heappop(heap)
            if kind == "revoke":
                caps = chaos_plan.caps_at(clock, base_caps)
                # spot preemption: kill running work (latest expected
                # finish first — it has the most left to lose anyway) until
                # the survivors fit the shrunken pool, and re-enqueue the
                # victims through the standard retry/backoff machinery
                while running and np.any(usage > caps + 1e-6):
                    jk = max(running, key=lambda x: (
                        max(r.expected_end for r in running[x]), x))
                    runs = running.pop(jk)
                    for r in runs:
                        r.dead = True
                    release_usage(runs)
                    self.retries += 1
                    self.kills += 1
                    task_retries[jk] += 1
                    self._log(clock, f"task {jk} killed: capacity revoked")
                    delay = _backoff_delay(cfg, attempts[jk], key=jk)
                    if delay > 0:
                        backing_off.add(jk)
                        backoff_idle[jk] = backoff_idle.get(jk, 0.0) + delay
                    push(clock + delay, "retry", jk)
                # an expiring revocation RESTORES capacity: wake waiters
                rescan_capacity()
                continue
            if kind in ("release", "retry"):
                if kind == "retry":
                    backing_off.discard(payload)
                if payload not in self.done and payload not in running \
                        and payload not in backing_off \
                        and payload not in capacity_waiting \
                        and all(p in self.done for p in preds[payload]):
                    try_launch(payload)
                continue
            run = payload
            j = run.task
            if run.dead:
                continue  # killed by a revocation; its events are stale
            if kind == "speculate":
                if j in self.done or j not in running:
                    continue
                still = [r for r in running[j] if r.attempt == run.attempt]
                if still and cfg.mode == "sim" and fits(j):
                    self.speculations += 1
                    task_specs[j] += 1
                    self._log(clock, f"speculative duplicate of task {j}")
                    launch(j, speculative=True)
                    if cfg.replan_on_straggler and self.agora is not None:
                        self.replans += 1
                continue
            if j in self.done:
                continue  # a duplicate already finished
            if kind == "fail":
                release_usage([r for r in running[j] if r is run])
                running[j] = [r for r in running[j] if r is not run]
                self.retries += 1
                task_retries[j] += 1
                self._log(clock, f"task {j} attempt {run.attempt} FAILED")
                if attempts[j] > cfg.max_retries + 1:
                    raise RuntimeError(f"task {j} exceeded retries")
                if not running[j]:
                    del running[j]
                    # capped exponential backoff before the next attempt
                    delay = _backoff_delay(cfg, run.attempt, key=j)
                    if delay > 0:
                        self._log(clock, f"task {j} backoff {delay:.1f}s")
                        backing_off.add(j)
                        backoff_idle[j] = backoff_idle.get(j, 0.0) + delay
                        push(clock + delay, "retry", j)
                    else:
                        try_launch(j)
                rescan_capacity()
                continue
            # finish
            self.done[j] = clock
            release_usage(running.get(j, ()))
            running.pop(j, None)
            self._log(clock, f"task {j} finished")
            self._save_state()
            rescan_capacity()
            for k in ready_tasks():
                try_launch(k)

        makespan = max(self.done.values()) - float(problem.release.min()) \
            if self.done else 0.0
        # realized cost: demands * realized duration * prices
        prices = self.plan.cluster.prices_per_sec
        cost = 0.0
        task_cost: Dict[int, float] = {}
        for j in sorted(self.done):
            # backoff windows hold no resources -> not billed
            d = self.done[j] - self.started[j] - backoff_idle.get(j, 0.0)
            task_cost[j] = float((task_dem[j] * prices).sum() * d)
            cost += task_cost[j]
        unlaunched = sorted(j for j in range(J) if j not in self.done)
        if unlaunched:
            self._log(clock, f"{len(unlaunched)} tasks withheld at the "
                             f"launch horizon")
        return FlowResult(makespan, cost, dict(self.started), dict(self.done),
                          self.retries, self.speculations, self.replans,
                          self.events, task_retries, task_specs, task_cost,
                          unlaunched, self.kills)


# ---------------------------------------------------------------------------
# Multi-tenant rolling-horizon loop (§5.5.1 serving mode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantRecord:
    """Outcome for one tenant DAG across the rolling-horizon run."""
    name: str
    submitted: float       # original submission (release) time
    planned_at: float      # planning-round start that batched it
    finished: float        # virtual completion time
    turnaround: float      # finished - submitted (queueing + execution)
    planned_makespan: float
    realized_makespan: float
    cost: float
    retries: int
    speculations: int
    plan_retries: int = 0  # planning rounds lost to failed joint validation
    failed: bool = False   # dropped after exhausting planning retries


class MultiTenantRunner:
    """Airflow-style serving loop: DAG submissions stream in; every planning
    round batches the pending set through one ``PlannerSession`` (ONE device
    dispatch for the whole batch) and dispatches the resulting plans to the
    discrete-event executor. DAGs arriving mid-round queue for the next
    round — the re-plan trigger re-batches the still-pending set, so a burst
    of N submissions costs one solve, not N.

    Two capacity models:

    * isolated (default) — each DAG is planned and simulated against the
      full cluster (per-tenant capacity quota), which is what lets the batch
      solve stay embarrassingly parallel on device.
    * ``shared_cluster=True`` — the batch is planned by a
      ``shared_capacity`` session (one coupled solve against the global
      capacity vector) and dispatched as ONE joint workflow drawing
      from a single capacity pool: planned start times gate task launches so
      the executed schedule honors the co-scheduled capacity staggering. The
      next round replans at the later of the pool draining (completion) and
      the next arrival.

    A tenant whose plan fails validation (individually, or implicated by the
    joint check) is NOT dropped: it is re-enqueued into the next planning
    round after a capped exponential backoff (``cfg.retry_backoff`` doubling
    per failed round, capped at ``cfg.retry_backoff_cap``), and only marked
    failed after ``cfg.max_retries`` extra rounds.
    """

    def __init__(self, agora: Agora, dags, cfg: Optional[FlowConfig] = None,
                 window: float = 900.0, shared_cluster: bool = False,
                 bucket_p=None, sink=None):
        self.agora = agora
        self.dags = sorted(dags, key=lambda d: d.release_time)
        self.cfg = cfg or FlowConfig()
        self.window = float(window)      # min spacing of planning rounds
        self.shared_cluster = shared_cluster
        # every planning round rides ONE PlannerSession: the solve
        # signature (engine, VecConfig, mesh, bucket schedule) is pinned
        # once and the session's stats expose the trace/cache behavior of
        # the whole run.  The sink is shared with the session, so solver
        # and control-plane events interleave in one stream (flow events
        # carry the VIRTUAL clock in ``ts``; see docs/events.md).
        self.session = agora.session(shared_capacity=shared_cluster,
                                     bucket_p=bucket_p, sink=sink)
        self.sink = self.session.sink
        self.rounds: List[int] = []      # batch size per planning round
        self.events: List[str] = []
        # causal traces (schema v2): one id per tenant submission, keyed
        # by tenant name; rides PlanRequest.trace into session emissions
        self._trace_ids = TraceIds()
        self._traces: Dict[str, str] = {}

    # ------------------------------------------------------------------

    def _invalid_tenants(self, plans: List) -> List[int]:
        """Indices of batch tenants whose plan cannot be dispatched."""
        bad = [i for i, p in enumerate(plans) if p.validate()]
        if not bad and plans and plans[0].joint_errors:
            # joint violation with no individual culprit: conservatively
            # retry the whole batch rather than dispatch an invalid schedule
            bad = list(range(len(plans)))
        return bad

    def run(self) -> List[TenantRecord]:
        pending = list(self.dags)
        self._traces = {d.name: self._trace_ids.next() for d in self.dags}
        if self.sink:
            # one submit root per tenant at its release instant — the
            # anchor of the causal chain its later events continue
            for d in self.dags:
                self.sink.emit(Event(
                    obs.SUBMIT, ts=d.release_time, tenant=d.name,
                    trace_id=self._traces[d.name], data={}))
        submitted = {d.name: d.release_time for d in self.dags}
        plan_attempts: Dict[str, int] = {}
        records: List[TenantRecord] = []
        tenant_seq = 0                   # per-tenant fault-stream index
        clock = 0.0
        first = True
        while pending:
            earliest = min(d.release_time for d in pending)
            clock = earliest if first else max(clock + self.window, earliest)
            first = False
            batch = [d for d in pending if d.release_time <= clock + 1e-9]
            pending = [d for d in pending if d.release_time > clock + 1e-9]
            # re-anchor each tenant's plan at the round start
            now_dags = [dataclasses.replace(d, release_time=0.0) for d in batch]
            plans = [r.plan for r in self.session.plan(
                [PlanRequest(dag=d, trace=self._traces.get(d.name))
                 for d in now_dags])]
            self.rounds.append(len(batch))
            self.events.append(
                f"[t={clock:9.1f}] round {len(self.rounds)}: planned "
                f"{len(batch)} DAGs in one batch "
                f"({sum(p.problem.num_tasks for p in plans)} tasks)")

            # failed joint validation -> re-enqueue into the next planning
            # round with capped exponential backoff instead of dropping
            bad = set(self._invalid_tenants(plans))
            good: List[Tuple[Any, Any]] = []     # (dag, plan)
            for i, (dag, plan) in enumerate(zip(batch, plans)):
                if i not in bad:
                    good.append((dag, plan))
                    continue
                n = plan_attempts.get(dag.name, 0) + 1
                plan_attempts[dag.name] = n
                if n > self.cfg.max_retries:
                    self.events.append(
                        f"[t={clock:9.1f}] tenant {dag.name}: plan invalid "
                        f"after {n} rounds — dropped")
                    if self.sink:
                        self.sink.emit(Event(
                            obs.DROP, ts=clock, tenant=dag.name,
                            trace_id=self._traces.get(dag.name),
                            parent=obs.SUBMIT,
                            data={"reason": "invalid_plan", "rounds": n}))
                    records.append(TenantRecord(
                        name=dag.name, submitted=submitted[dag.name],
                        planned_at=clock, finished=math.inf,
                        turnaround=math.inf, planned_makespan=math.inf,
                        realized_makespan=math.inf, cost=0.0, retries=0,
                        speculations=0, plan_retries=n, failed=True))
                    continue
                delay = _backoff_delay(self.cfg, n, key=_jitter_key(dag.name))
                self.events.append(
                    f"[t={clock:9.1f}] tenant {dag.name}: plan failed joint "
                    f"validation — re-enqueued (backoff {delay:.1f}s)")
                pending.append(dataclasses.replace(
                    dag, release_time=clock + max(delay, 1e-6)))
            pending.sort(key=lambda d: d.release_time)

            if not good:
                continue
            if bad and self.shared_cluster:
                # the surviving tenants were co-scheduled AROUND the invalid
                # ones' usage — re-plan the reduced batch so the dispatched
                # joint schedule doesn't inherit stale staggering
                redo = [dataclasses.replace(d, release_time=0.0)
                        for d, _ in good]
                good = list(zip(
                    [d for d, _ in good],
                    [r.plan for r in self.session.plan(
                        [PlanRequest(dag=d, trace=self._traces.get(d.name))
                         for d in redo])]))
                self.events.append(
                    f"[t={clock:9.1f}] re-planned {len(good)} valid tenants "
                    f"after excluding {len(bad)}")
            if self.shared_cluster:
                completion = self._dispatch_shared(clock, good, plan_attempts,
                                                   submitted, records)
            else:
                completion = self._dispatch_isolated(clock, good, tenant_seq,
                                                     plan_attempts, submitted,
                                                     records)
            tenant_seq += len(good)
            if self.shared_cluster and pending:
                # shared pool: replan on completion/arrival, not on a fixed
                # cadence — the pool must drain before the next joint batch
                clock = max(completion - self.window, clock)
        return records

    # ------------------------------------------------------------------

    def _tenant_cfg(self, name: str, seq: int) -> FlowConfig:
        # per-tenant noise stream (seeded by the global tenant index so
        # rounds don't replay each other's fault sequences) AND per-tenant
        # checkpoint file — tenants must never restore each other's indices
        state = (f"{self.cfg.state_path}.{name}"
                 if self.cfg.state_path else None)
        return dataclasses.replace(self.cfg, seed=self.cfg.seed + 7919 * seq,
                                   state_path=state)

    def _dispatch_isolated(self, clock, good, tenant_seq, plan_attempts,
                           submitted, records) -> float:
        if self.sink:
            self.sink.emit(Event(
                obs.DISPATCH, ts=clock,
                data={"mode": "isolated", "n": len(good),
                      "tenants": [d.name for d, _ in good],
                      "trace_ids": [self._traces[d.name] for d, _ in good
                                    if d.name in self._traces]}))
        completion = clock
        for k, (dag, plan) in enumerate(good):
            res = FlowRunner(plan,
                             self._tenant_cfg(dag.name, tenant_seq + k)).run()
            records.append(TenantRecord(
                name=dag.name, submitted=submitted[dag.name],
                planned_at=clock, finished=clock + res.makespan,
                turnaround=clock + res.makespan - submitted[dag.name],
                planned_makespan=plan.makespan,
                realized_makespan=res.makespan, cost=res.cost,
                retries=res.retries, speculations=res.speculations,
                plan_retries=plan_attempts.get(dag.name, 0)))
            completion = max(completion, clock + res.makespan)
        return completion

    def _dispatch_shared(self, clock, good, plan_attempts, submitted,
                         records) -> float:
        """Execute the whole round as ONE joint workflow against the shared
        capacity pool, then split the result back into per-tenant records."""
        from repro_torch.core.agora import combine_plans
        if self.sink:
            self.sink.emit(Event(
                obs.DISPATCH, ts=clock,
                data={"mode": "shared", "n": len(good),
                      "tenants": [d.name for d, _ in good],
                      "trace_ids": [self._traces[d.name] for d, _ in good
                                    if d.name in self._traces]}))
        joint = combine_plans([plan for _, plan in good])
        # planned starts gate launches: the joint schedule's staggering IS
        # the capacity arbitration, so the executor must honor it
        joint.problem.release = np.asarray(joint.solution.start, float).copy()
        rnd = len(self.rounds)
        res = FlowRunner(joint, self._tenant_cfg(f"joint{rnd}", rnd)).run()
        self.events.append(
            f"[t={clock:9.1f}] joint dispatch: {joint.problem.num_tasks} "
            f"tasks, makespan {res.makespan:.1f}s, retries={res.retries}")
        off = 0
        completion = clock
        for dag, plan in good:
            J = plan.problem.num_tasks
            idx = range(off, off + J)
            t_done = max(res.task_finish[j] for j in idx)
            records.append(TenantRecord(
                name=dag.name, submitted=submitted[dag.name],
                planned_at=clock, finished=clock + t_done,
                turnaround=clock + t_done - submitted[dag.name],
                planned_makespan=plan.makespan,
                realized_makespan=t_done,
                cost=sum(res.task_cost[j] for j in idx),
                retries=sum(res.task_retries[j] for j in idx),
                speculations=sum(res.task_speculations[j] for j in idx),
                plan_retries=plan_attempts.get(dag.name, 0)))
            completion = max(completion, clock + t_done)
            off += J
        return completion
