"""SLA-aware streaming control plane over the shared capacity pool (PyTorch
port).

The third pillar of the multi-tenant story (after batched planning and
shared-capacity co-scheduling): tenants now ARRIVE over time,
carry an SLA class, and the control plane re-plans the live batch instead
of draining fixed rolling-horizon windows.

Three mechanisms compose:

* bucketed admission — every planning round is served by ONE
  ``PlannerSession`` pinned to a power-of-two bucket schedule
  (``agora.session(bucket_p=...)``): a tenant arriving mid-stream re-plans
  under the SAME solve signature (no new signature, observable through
  ``session.stats.trace_count``) as long as it lands inside the current bucket.
  Padded slots are fully masked and bit-for-bit inert.  Guaranteed
  arrivals additionally pass ``session.admit`` — provably infeasible
  deadlines are rejected (or downgraded) up front, with the verdict
  recorded on ``StreamRecord.admission``.
* deadline classes — each tenant's SLA class maps to a per-tenant ``Goal``
  (``guaranteed`` carries a deadline hinge term, ``standard`` the base
  blend, ``best_effort`` a cost-leaning blend) carried on its typed
  ``PlanRequest`` into the coupled annealer's per-tenant energy.
* preemptive re-planning — each dispatch runs only until the next arrival
  (``FlowConfig.launch_horizon``): in-flight tasks drain, not-yet-launched
  tasks return to the control plane and are re-planned together with the
  arrival.  When a guaranteed tenant's planned completion would overshoot
  its deadline, not-yet-launched best-effort tenants are preempted out of
  the round and re-enqueued under the executor's capped-exponential
  backoff machinery.

The FIFO no-SLA baseline (``StreamConfig(sla_aware=False,
replan_on_arrival=False)``) degenerates to ``MultiTenantRunner``'s
rolling-horizon loop: equal goals, full-drain rounds, no preemption — the
comparison the ``bench_streaming`` deadline-hit-rate gate is built on.

Fault tolerance (``StreamConfig.chaos``): the control plane consumes a
chaos revocation timeline (``repro_torch.flow.chaos``) as spot preemption —
dispatches hard-stop at the next capacity change, running work on
revoked capacity is killed and re-enqueued (``_apply_revocations``),
survivors re-plan against the shrunken pool, and the capacity audit
sweeps against the time-varying ceiling.  With no chaos config attached
the loop is bit-for-bit identical to the pre-chaos code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.agora import Agora, Plan, combine_plans
from repro_torch.core.dag import DAG, Task, TaskOption, flatten
from repro_torch.core.objectives import Goal
# SLA classes live with the typed request surface now; re-exported here for
# compatibility with existing callers
from repro_torch.core.session import (SLA_BEST_EFFORT, SLA_CLASSES,
                                      SLA_GUARANTEED, SLA_STANDARD,
                                      PlanRequest)
from repro_torch.flow.executor import (FlowConfig, FlowResult, FlowRunner,
                                       MultiTenantRunner, TenantRecord,
                                       _backoff_delay, _jitter_key)
from repro_torch.obs import events as obs
from repro_torch.obs.aggregate import finite_or_none
from repro_torch.obs.events import Event
from repro_torch.obs.trace import TraceIds


@dataclasses.dataclass(frozen=True)
class TenantRequest:
    """A tenant DAG submission with its SLA class.

    ``deadline`` is an ABSOLUTE virtual time (same clock as
    ``dag.release_time``); guaranteed-class requests must carry one.
    """
    dag: DAG
    sla: str = SLA_STANDARD
    deadline: float = math.inf

    def __post_init__(self):
        assert self.sla in SLA_CLASSES, self.sla
        if self.sla == SLA_GUARANTEED:
            assert math.isfinite(self.deadline), (
                "guaranteed-class requests need a finite deadline")

    @property
    def name(self) -> str:
        return self.dag.name

    @property
    def submit(self) -> float:
        return self.dag.release_time


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Control-plane knobs (planning-side; executor noise lives in
    ``FlowConfig``)."""
    bucket_p: int | bool = True        # power-of-two admission buckets
    sla_aware: bool = True             # False -> FIFO no-SLA baseline goals
    replan_on_arrival: bool = True     # False -> full-drain rounds (FIFO)
    overlap_rounds: bool = True        # admit at the cut, planning against
    #                                    caps minus in-flight residual;
    #                                    False -> quiesce until drain (FIFO)
    guaranteed_w: float = 0.9          # makespan weight for guaranteed class
    best_effort_w: float = 0.15        # cost-leaning weight for best effort
    deadline_weight: float = 8.0       # hinge scale of the deadline term
    deadline_margin: float = 0.0       # preempt when planned completion
    #                                    > deadline - margin
    preempt_backoff: float = 30.0      # base backoff for preempted tenants
    #                                    (cfg.retry_backoff wins when set)
    max_preemptions: int = 8           # per-tenant preemption cap
    max_deferrals: int = 4             # at-risk guaranteed tenants may wait
    #                                    for in-flight residue this many
    #                                    times before dispatching anyway
    # admission control (PlannerSession.admit): guaranteed arrivals whose
    # deadline is PROVABLY infeasible (critical-path lower bound against
    # the committed load) are rejected — or downgraded to standard class —
    # instead of best-effort missed; the decision rides StreamRecord
    admission_control: bool = True
    admission: str = "reject"          # "reject" | "downgrade"
    # monotonic clock progress per (tenant, round): every re-enqueue —
    # invalid-plan backoff or preemption — moves the tenant's ready_at
    # forward by at least this much, so a tenant with no in-flight residue
    # to wait for (``_next_release`` infinite) burns its retry budget at
    # DISTINCT clock times instead of back-to-back rounds at one instant
    min_requeue_delta: float = 1.0
    # fault-tolerance plane: a ``repro_torch.flow.chaos.ChaosConfig`` whose
    # revocation timeline the control plane consumes — running tasks on
    # revoked capacity are killed (truncated and billed at the revocation
    # instant) and re-enqueued through the standard backoff machinery, and
    # survivors re-plan against the shrunken pool.  None (the default)
    # keeps the loop bit-for-bit identical to the pre-chaos code.
    chaos: Optional[Any] = None
    # experimental: re-admit a tenant BEFORE its own in-flight work drains,
    # pinning live predecessors into the re-solve as zero-demand phantom
    # tasks of their remaining duration (dependents are edge-sequenced
    # behind them; capacity stays conservatively reserved through the
    # in-flight residue accounting, so phantoms cannot cause violations).
    # Off by default: phantom counts vary per round, which can add solve
    # signatures beyond the warmed set.
    pin_inflight: bool = False


def sla_goal(req: TenantRequest, base: Goal, now: float,
             sc: StreamConfig) -> Goal:
    """Map a request's SLA class to its per-tenant planning goal.

    Deadlines are absolute; the solver plans relative to the round start,
    so the goal carries the REMAINING budget ``deadline - now``."""
    if not sc.sla_aware or req.sla == SLA_STANDARD:
        return base
    if req.sla == SLA_GUARANTEED:
        remaining = max(req.deadline - now, 1e-6)
        return dataclasses.replace(base, w=sc.guaranteed_w,
                                   deadline=remaining,
                                   deadline_weight=sc.deadline_weight)
    return dataclasses.replace(base, w=sc.best_effort_w)


@dataclasses.dataclass
class StreamRecord(TenantRecord):
    """Per-tenant outcome, extended with the SLA verdict."""
    sla: str = SLA_STANDARD
    deadline: float = math.inf
    deadline_met: bool = True
    preemptions: int = 0
    rounds: int = 0                    # planning rounds the tenant rode in
    # admission-control verdict: "admitted", "rejected" (provably
    # infeasible, never planned) or "downgraded" (served as standard class;
    # sla/deadline report the ORIGINAL guaranteed request)
    admission: str = "admitted"


@dataclasses.dataclass(eq=False)
class _TenantState:
    """Mutable control-plane state for one tenant across rounds.

    Identity equality (``eq=False``): states live in batch/pending lists
    that are filtered with ``in``/``remove``, and value equality would
    recurse into Plan/FlatProblem numpy fields (ambiguous truth value) —
    and could evict the WRONG tenant when two submissions carry identical
    DAG content."""
    req: TenantRequest
    remaining: List[int]               # original task ids still unlaunched
    ready_at: float                    # earliest next admission time
    done: Dict[int, float] = dataclasses.field(default_factory=dict)
    started: Dict[int, float] = dataclasses.field(default_factory=dict)
    cost: float = 0.0
    retries: int = 0
    specs: int = 0
    plan_retries: int = 0              # rounds lost to failed validation
    preemptions: int = 0
    deferrals: int = 0                 # waits for in-flight residue
    rounds: int = 0
    first_planned: float = math.inf
    last_plan_makespan: float = math.nan
    admission: str = "admitted"
    admission_checked: bool = False
    declared_sla: str = ""             # original class (survives downgrade)
    declared_deadline: float = math.nan
    trace: Optional[str] = None        # causal trace id (schema v2)

    def __post_init__(self):
        if not self.declared_sla:
            self.declared_sla = self.req.sla
            self.declared_deadline = self.req.deadline

    @property
    def name(self) -> str:
        return self.req.name

    def remainder_dag(self) -> DAG:
        """The not-yet-launched subgraph, re-anchored at release 0 (the
        control plane re-anchors every round at its own clock)."""
        d0 = self.req.dag
        remap = {o: i for i, o in enumerate(self.remaining)}
        tasks = [d0.tasks[o] for o in self.remaining]
        edges = [(remap[a], remap[b]) for a, b in d0.edges
                 if a in remap and b in remap]
        return DAG(d0.name, tasks, edges, release_time=0.0)


class StreamingRunner(MultiTenantRunner):
    """Arrival-driven serving loop (streaming counterpart of the rolling-
    horizon ``MultiTenantRunner`` it extends — invalid-plan re-enqueue and
    backoff machinery are inherited unchanged).

    Each round admits every pending tenant into one bucketed batch, plans
    it with per-tenant SLA goals, and dispatches the joint plan with a
    launch horizon at the next arrival.  Launched tasks drain; unlaunched
    remainders and preempted best-effort tenants come back as fresh
    (reduced) submissions.  Every task is executed and accounted exactly
    once across rounds."""

    def __init__(self, agora: Agora, requests: Sequence[TenantRequest],
                 cfg: Optional[FlowConfig] = None,
                 stream: Optional[StreamConfig] = None,
                 shared_cluster: bool = True, sink=None):
        requests = sorted(requests, key=lambda r: r.submit)
        # ONE session for the whole stream (built by the parent): the
        # bucket schedule and engine are pinned here, residual-capacity
        # snapshots flow through session.plan(capacity=...) per round, and
        # session.stats carries the zero-retrace evidence the bench gates
        # assert
        self.stream = stream or StreamConfig()
        super().__init__(agora, [r.dag for r in requests], cfg,
                         window=0.0, shared_cluster=shared_cluster,
                         bucket_p=self.stream.bucket_p, sink=sink)
        self.requests = requests
        self.preempt_events = 0
        self.arrival_replans = 0
        # chaos revocation timeline: compiled once; only the
        # capacity half of the chaos config is consumed here — solver/sink
        # faults belong to the daemon and the obs plane respectively
        self._fault_plan = (self.stream.chaos.compile()
                            if self.stream.chaos is not None
                            and getattr(self.stream.chaos, "revocations", ())
                            else None)
        self.revocation_kills = 0
        # truncated intervals of revocation-killed runs (abs_start, kill_t,
        # demand): the victims really held that capacity, so the residual
        # accounting and the violation audit both include these windows
        self._truncated: List[Tuple[float, float, np.ndarray]] = []
        self._revoked_emitted: set = set()
        # causal traces: each tenant is stamped at arrival; the id rides
        # its PlanRequests and every per-tenant event across rounds
        self._trace_ids = TraceIds()
        # (round_clock, [(tenant_name, plan)], FlowResult) per dispatch —
        # the audit trail the capacity gates sweep
        self.dispatches: List[Tuple[float, List[Tuple[str, Plan]],
                                    FlowResult]] = []

    # ------------------------------------------------------------------

    def _preempt_delay(self, state: _TenantState) -> float:
        """Backoff for a preempted tenant via the executor's capped-
        exponential machinery; the stream-level base applies when the
        flow config carries no retry backoff of its own."""
        cfg = self.cfg
        if cfg.retry_backoff <= 0:
            cfg = dataclasses.replace(cfg,
                                      retry_backoff=self.stream.preempt_backoff)
        return max(_backoff_delay(cfg, state.preemptions,
                                  key=_jitter_key(state.name)),
                   self.stream.min_requeue_delta)

    def _plan_batch(self, clock: float, batch: List[_TenantState],
                    caps_round: Optional[np.ndarray] = None):
        """One bucketed, SLA-weighted planning round for the batch: typed
        requests through the session, planned against the ROUND's free
        capacity (the pool minus in-flight residue).  Capacity is data, not
        part of the solve signature, so round-to-round snapshots never run
        a new one."""
        sc = self.stream
        dags = ([self._pinned_dag(s, clock) for s in batch]
                if sc.pin_inflight
                else [(s.remainder_dag(), 0) for s in batch])
        requests = [PlanRequest(dag=dag,
                                goal=sla_goal(s.req, self.agora.goal, clock,
                                              sc),
                                sla=s.req.sla, deadline=s.req.deadline,
                                trace=s.trace)
                    for s, (dag, _) in zip(batch, dags)]
        results = self.session.plan(requests, capacity=caps_round)
        return [self._strip_phantoms(s, r.plan, k)
                for s, (_, k), r in zip(batch, dags, results)]

    def _pinned_dag(self, s: _TenantState, clock: float) -> Tuple[DAG, int]:
        """Remainder DAG with the tenant's still-running predecessors
        pinned in front as ZERO-DEMAND phantom tasks of their remaining
        duration (``pin_inflight``): the re-solve sees WHEN in-flight work
        finishes and sequences dependents behind it via edges, while the
        in-flight demand itself stays reserved through the residual-
        capacity accounting — so phantoms cannot cause violations, only
        correct timing.  Returns (dag, phantom_count); phantoms occupy the
        first ``phantom_count`` slots and are stripped before dispatch."""
        d0 = s.req.dag
        rem_set = set(s.remaining)
        live = sorted(o for o, f in s.done.items()
                      if f > clock + 1e-9
                      and any(a == o and b in rem_set for a, b in d0.edges))
        k = len(live)
        if k == 0:
            return s.remainder_dag(), 0
        M = self.agora.cluster.num_resources
        phantoms = [Task(f"{d0.tasks[o].name}#inflight",
                         [TaskOption("pinned", max(s.done[o] - clock, 1e-6),
                                     (0.0,) * M, 0.0)])
                    for o in live]
        pmap = {o: i for i, o in enumerate(live)}
        remap = {o: k + i for i, o in enumerate(s.remaining)}
        tasks = phantoms + [d0.tasks[o] for o in s.remaining]
        edges = [(remap[a], remap[b]) for a, b in d0.edges
                 if a in remap and b in remap]
        edges += [(pmap[a], remap[b]) for a, b in d0.edges
                  if a in pmap and b in remap]
        return DAG(d0.name, tasks, edges, release_time=0.0), k

    def _strip_phantoms(self, s: _TenantState, plan: Plan, k: int) -> Plan:
        """Drop the ``k`` leading phantom slots from a pinned plan: the
        dispatched plan covers exactly ``s.remaining`` (phantom work is
        already running — re-executing it would double-account), with the
        solved starts/finishes preserved so dependents still launch after
        their live predecessors drain."""
        if k == 0:
            return plan
        problem = flatten([s.remainder_dag()],
                          self.agora.cluster.num_resources)
        sol = plan.solution
        finish = np.asarray(sol.finish[k:], float).copy()
        stripped = dataclasses.replace(
            sol,
            option_idx=np.asarray(sol.option_idx[k:]).copy(),
            start=np.asarray(sol.start[k:], float).copy(),
            finish=finish,
            makespan=float(finish.max()) if problem.num_tasks else 0.0)
        from repro_torch.core.annealer import reference_point
        return Plan(problem, stripped, plan.goal, plan.cluster,
                    reference_point(problem, plan.cluster),
                    joint_errors=plan.joint_errors)

    def _completion(self, plan: Plan) -> float:
        """Planned completion of one tenant, relative to the round start
        (shared-capacity plans live on one joint timeline)."""
        if not plan.problem.num_tasks:
            return 0.0
        return float(plan.solution.finish.max())

    def _at_risk(self, clock: float, state: _TenantState,
                 plan: Plan) -> bool:
        if state.req.sla != SLA_GUARANTEED:
            return False
        return (clock + self._completion(plan)
                > state.req.deadline - self.stream.deadline_margin)

    # ------------------------------------------------------------------

    def _base_caps(self, clock: float) -> np.ndarray:
        """The pool's capacity vector at ``clock`` — the static cluster
        caps, shrunk by any chaos revocation active at that instant."""
        caps = np.asarray(self.agora.cluster.caps, float)
        if self._fault_plan is not None:
            return self._fault_plan.caps_at(clock, caps)
        return caps.copy()

    def _residual_caps(self, clock: float) -> np.ndarray:
        """Free capacity at ``clock``: the pool minus every in-flight task
        committed by earlier dispatches (launched tasks run to completion
        — or are truncated at a revocation — so their demand is reserved
        until their realized finish)."""
        caps = self._base_caps(clock)
        for _, f, dem in self._executed:
            if f > clock + 1e-9:
                caps -= dem
        return caps

    def _next_release(self, clock: float) -> float:
        """Next instant at which in-flight residue frees capacity."""
        return min((f for _, f, _ in self._executed if f > clock + 1e-9),
                   default=math.inf)

    def _next_capacity_gain(self, clock: float) -> float:
        """Next instant at which revoked capacity RETURNS (a revocation
        expiry); ``inf`` with no chaos plan or only permanent losses.  A
        tenant that cannot fit the revoked pool waits for this instead of
        burning its plan-retry budget against capacity that is not
        there."""
        if self._fault_plan is None:
            return math.inf
        return min((r.until for r in self._fault_plan.cfg.revocations
                    if math.isfinite(r.until) and r.until > clock + 1e-9),
                   default=math.inf)

    @staticmethod
    def _structurally_fits(state: _TenantState,
                           caps_round: np.ndarray) -> bool:
        """Every remaining task has at least one option that fits the
        round's free capacity — planning a tenant into a narrower sliver
        can only fail validation and burn its retry budget."""
        for o in state.remaining:
            task = state.req.dag.tasks[o]
            if not any(np.all(np.asarray(opt.demands) <= caps_round + 1e-9)
                       for opt in task.options):
                return False
        return True

    def run(self) -> List[StreamRecord]:
        sc = self.stream
        states = [
            _TenantState(req=r, remaining=list(range(r.dag.num_tasks)),
                         ready_at=r.submit, trace=self._trace_ids.next())
            for r in self.requests
        ]
        if self.sink:
            # one submit root per tenant at its arrival instant — the
            # anchor of its causal chain (ts on the virtual clock, like
            # every other control-plane event)
            for s in states:
                self.sink.emit(Event(
                    obs.SUBMIT, ts=s.req.submit, tenant=s.name,
                    sla=s.declared_sla, trace_id=s.trace,
                    data={"deadline": finite_or_none(s.req.deadline)}))
        pending: List[_TenantState] = list(states)
        records: List[StreamRecord] = []
        self._executed: List[Tuple[float, float, np.ndarray]] = []
        clock = 0.0
        self._clock = 0.0              # round clock, for terminal events
        drain_end = 0.0
        while pending:
            clock = max(clock, min(s.ready_at for s in pending))
            if not sc.overlap_rounds:
                # FIFO quiesce: the next round waits for the pool to drain
                clock = max(clock, drain_end)
            else:
                # overlapped rounds: admit at the cut, but step past
                # instants where the in-flight residue saturates the pool
                while True:
                    if np.all(self._residual_caps(clock) > 1e-9):
                        break
                    nxt = min((f for _, f, _ in self._executed
                               if f > clock + 1e-9), default=clock)
                    if nxt <= clock:
                        break
                    clock = nxt
            caps_round = np.maximum(self._residual_caps(clock), 0.0)
            self._clock = clock
            batch = [s for s in pending if s.ready_at <= clock + 1e-9]
            pending = [s for s in pending if s.ready_at > clock + 1e-9]
            # admission control: a fresh guaranteed arrival whose deadline
            # is PROVABLY infeasible (session.admit's critical-path lower
            # bound against the committed load) is rejected — or downgraded
            # to standard class — up front, instead of burning rounds and
            # preemptions on a tenant no policy can save
            if sc.sla_aware and sc.admission_control:
                for s in list(batch):
                    if s.admission_checked or s.req.sla != SLA_GUARANTEED:
                        continue
                    s.admission_checked = True
                    avail = clock
                    if not self._structurally_fits(s, caps_round):
                        release = self._next_release(clock)
                        if math.isfinite(release):
                            avail = release
                    decision = self.session.admit(
                        PlanRequest(dag=s.remainder_dag(), sla=s.req.sla,
                                    deadline=s.req.deadline),
                        now=clock, available_at=avail)
                    if decision.admitted:
                        continue
                    if sc.admission == "downgrade":
                        s.admission = "downgraded"
                        s.req = dataclasses.replace(s.req, sla=SLA_STANDARD)
                        self.events.append(
                            f"[t={clock:9.1f}] tenant {s.name}: guaranteed "
                            f"deadline provably infeasible "
                            f"({decision.reason}) — downgraded to standard")
                    else:
                        s.admission = "rejected"
                        batch.remove(s)
                        self.events.append(
                            f"[t={clock:9.1f}] tenant {s.name}: guaranteed "
                            f"deadline provably infeasible "
                            f"({decision.reason}) — rejected at admission")
                        if self.sink:
                            self.sink.emit(Event(
                                obs.DROP, ts=clock, tenant=s.name,
                                sla=s.declared_sla,
                                trace_id=s.trace, parent=obs.SUBMIT,
                                data={"reason": "admission_rejected"}))
                        records.append(self._record(s, math.inf, failed=True))
            # capacity-fragmentation guard: a tenant none of whose options
            # fit the round's free sliver waits for the next residue
            # release — or for revoked capacity to return — instead of
            # burning its plan-retry budget
            release = min(self._next_release(clock),
                          self._next_capacity_gain(clock))
            if math.isfinite(release):
                blocked = [s for s in batch
                           if not self._structurally_fits(s, caps_round)]
                for s in blocked:
                    s.ready_at = release
                    pending.append(s)
                batch = [s for s in batch if s not in blocked]
            if not batch:
                continue
            for s in batch:
                s.rounds += 1
                s.first_planned = min(s.first_planned, clock)
            plans = self._plan_batch(clock, batch, caps_round)
            self.rounds.append(len(batch))
            self.events.append(
                f"[t={clock:9.1f}] round {len(self.rounds)}: planned "
                f"{len(batch)} tenants in one bucketed batch "
                f"({sum(p.problem.num_tasks for p in plans)} tasks, "
                f"free caps {np.round(caps_round, 1).tolist()})")

            # ---- plan -> validate -> adjust, to a stable batch ---------
            # every adjustment (invalid exclusion, preemption, deferral)
            # removes a tenant and re-plans the survivors, and the NEW
            # plan set is validated and risk-checked again — the batch
            # that dispatches is always a validated fixed point.  The loop
            # terminates because each iteration shrinks the batch.
            good: List[Tuple[_TenantState, Plan]] = list(zip(batch, plans))
            while good:
                changed = False
                # (a) invalid plans: re-enqueue with backoff (inherited)
                bad = set(self._invalid_tenants([p for _, p in good]))
                if bad:
                    changed = True
                    kept: List[Tuple[_TenantState, Plan]] = []
                    for i, (s, plan) in enumerate(good):
                        if i not in bad:
                            kept.append((s, plan))
                            continue
                        s.plan_retries += 1
                        if s.plan_retries > self.cfg.max_retries:
                            self.events.append(
                                f"[t={clock:9.1f}] tenant {s.name}: plan "
                                f"invalid after {s.plan_retries} rounds — "
                                f"dropped")
                            if self.sink:
                                self.sink.emit(Event(
                                    obs.DROP, ts=clock, tenant=s.name,
                                    sla=s.declared_sla,
                                    trace_id=s.trace, parent=obs.SUBMIT,
                                    data={"reason": "invalid_plan",
                                          "rounds": s.plan_retries}))
                            records.append(
                                self._record(s, math.inf, failed=True))
                            continue
                        # backoff floored at the next residue release:
                        # retrying an invalid plan against the same free
                        # sliver cannot succeed.  The floor is
                        # min_requeue_delta, NOT an epsilon: with no
                        # residue in flight (release infinite) an epsilon
                        # floor re-admitted the tenant at effectively the
                        # same clock and drained max_retries in one instant
                        delay = max(
                            _backoff_delay(self.cfg, s.plan_retries,
                                           key=_jitter_key(s.name)),
                            sc.min_requeue_delta)
                        release = min(self._next_release(clock),
                                      self._next_capacity_gain(clock))
                        ready = max(
                            clock + delay,
                            release if math.isfinite(release) else clock)
                        self.events.append(
                            f"[t={clock:9.1f}] tenant {s.name}: plan failed "
                            f"joint validation — re-enqueued (t={ready:.1f})")
                        s.ready_at = ready
                        pending.append(s)
                    good = kept
                # (b) deadline risk: preempt ONE not-yet-launched best-
                # effort tenant (the largest planned load frees the most
                # capacity), then re-plan and re-check — fresh plans decide
                # whether further evictions are actually needed
                if not changed and sc.sla_aware and good:
                    risky = [s for s, p in good
                             if self._at_risk(clock, s, p)]
                    victims = [(s, p) for s, p in good
                               if s.req.sla == SLA_BEST_EFFORT
                               and s.preemptions < sc.max_preemptions]
                    if risky and victims:
                        changed = True
                        victim, _ = max(victims,
                                        key=lambda t: t[1].solution.cost)
                        good = [(s, p) for s, p in good if s is not victim]
                        victim.preemptions += 1
                        self.preempt_events += 1
                        delay = self._preempt_delay(victim)
                        victim.ready_at = clock + delay
                        pending.append(victim)
                        if self.sink:
                            self.sink.emit(Event(
                                obs.PREEMPT, ts=clock, tenant=victim.name,
                                sla=victim.declared_sla,
                                trace_id=victim.trace, parent=obs.SUBMIT,
                                data={"reason": "deadline_risk",
                                      "at_risk": [s.name for s in risky],
                                      "backoff": delay}))
                        self.events.append(
                            f"[t={clock:9.1f}] preempted best-effort tenant "
                            f"{victim.name} for deadline risk of "
                            f"{[s.name for s in risky]} "
                            f"(backoff {delay:.1f}s)")
                # (c) still at risk with residue in flight: wait for it.
                # A static capacity snapshot cannot see the pool refilling
                # as in-flight tasks drain, so an at-risk guaranteed tenant
                # defers to the next residue-release event and re-plans
                # with the freed capacity (bounded by max_deferrals)
                if (not changed and sc.sla_aware and sc.overlap_rounds
                        and good):
                    residue_next = self._next_release(clock)
                    if math.isfinite(residue_next):
                        for s, p in list(good):
                            if (s.req.sla == SLA_GUARANTEED
                                    and s.deferrals < sc.max_deferrals
                                    and self._at_risk(clock, s, p)
                                    and residue_next < s.req.deadline):
                                changed = True
                                good.remove((s, p))
                                s.deferrals += 1
                                s.ready_at = residue_next
                                pending.append(s)
                                if self.sink:
                                    self.sink.emit(Event(
                                        obs.DEFER, ts=clock, tenant=s.name,
                                        sla=s.declared_sla,
                                        trace_id=s.trace, parent=obs.SUBMIT,
                                        data={"until": residue_next,
                                              "deferrals": s.deferrals}))
                                self.events.append(
                                    f"[t={clock:9.1f}] deferred guaranteed "
                                    f"tenant {s.name} to "
                                    f"t={residue_next:.1f} (at risk; "
                                    f"waiting for in-flight residue)")
                if not changed:
                    break
                if good:
                    # survivors were co-scheduled around evicted tenants'
                    # usage — re-plan so the next validation/risk check
                    # sees the actual dispatchable staggering
                    replans = self._plan_batch(
                        clock, [s for s, _ in good], caps_round)
                    good = list(zip([s for s, _ in good], replans))
                    self.arrival_replans += 1
                    self.events.append(
                        f"[t={clock:9.1f}] re-planned {len(good)} tenants "
                        f"after preemption/exclusion")
            if not good:
                continue

            # ---- dispatch until the next deadline-bearing arrival -----
            # only fresh GUARANTEED submissions cut the horizon: yielding
            # the pool costs the yielding tenants real time, so the cut is
            # paid exactly when it buys deadline protection.  Backoff
            # returns of preempted/re-enqueued tenants never cut — they
            # wait for the next natural round.
            fresh = [s for s in pending if s.rounds == 0]
            if sc.sla_aware:
                cuts = [s.ready_at for s in fresh
                        if s.req.sla == SLA_GUARANTEED]
            else:
                cuts = [s.ready_at for s in fresh]
            next_cut = min(cuts, default=math.inf)
            horizon = math.inf
            if sc.replan_on_arrival and math.isfinite(next_cut):
                horizon = max(next_cut - clock, 0.0)
            # capacity revocations HARD-cut the dispatch: no FIRST launch
            # crosses the next capacity-change instant (no exemptions, not
            # even guaranteed tenants), so everything that would start on
            # post-revocation capacity is withheld and re-planned against
            # the pool that actually exists then.  This is also what makes
            # the kill surgery in _apply_revocations causally safe: no
            # dependent of a victim ever launched.
            cap_change = (self._fault_plan.next_capacity_change(clock)
                          if self._fault_plan is not None else math.inf)
            hard = (max(cap_change - clock, 0.0)
                    if math.isfinite(cap_change) else math.inf)
            n_trunc = len(self._truncated)
            res = self._dispatch(clock, good, horizon, hard)
            kill_floors = self._apply_revocations(clock, good, res)
            if self.sink:
                self.sink.emit(Event(
                    obs.DISPATCH, ts=clock,
                    data={"mode": "stream", "n": len(good),
                          "tenants": [s.name for s, _ in good],
                          "trace_ids": [s.trace for s, _ in good
                                        if s.trace],
                          "tasks": sum(p.problem.num_tasks
                                       for _, p in good),
                          "horizon": finite_or_none(horizon),
                          "finished": len(res.task_finish),
                          "withheld": len(res.unlaunched),
                          "free_caps": caps_round.tolist()}))
            if res.task_finish:
                drain_end = clock + max(res.task_finish.values())
            else:
                # nothing cleared the horizon (all planned starts beyond
                # the cut — or beyond the capacity change): jump forward
                # so the next round makes progress
                drain_end = min(next_cut, cap_change)
            # commit this round's realized intervals: later rounds reserve
            # the in-flight residue out of their planning capacity (same
            # accounting the zero-violation gate audits).  Truncated
            # windows of revocation-killed runs count too — the victims
            # held that capacity until the kill.
            self._executed.extend(self._intervals_of(*self.dispatches[-1]))
            self._executed.extend(self._truncated[n_trunc:])
            requeue_at = min(next_cut, cap_change)
            if not math.isfinite(requeue_at):
                requeue_at = drain_end
            requeued = self._merge(clock, good, res, requeue_at, records)
            for s in requeued:
                # revocation-killed work backs off past the kill instant
                if id(s) in kill_floors:
                    s.ready_at = max(s.ready_at, kill_floors[id(s)])
            pending.extend(requeued)
        if self.sink:
            self.capacity_audit()
        return records

    def _apply_revocations(self, clock: float, good,
                           res: FlowResult) -> Dict[int, float]:
        """Spot preemption against a live dispatch: every
        revocation landing inside this dispatch's window kills enough of
        its running work — latest realized finish first — that the total
        committed usage fits the post-revocation caps.

        Victims are truncated at the revocation instant: the window they
        actually held stays billed and audited (``self._truncated``), and
        the task itself is simply no longer "finished" in ``res``, so
        ``_merge`` re-enqueues it through the standard retry machinery.
        Dependents are safe by construction — the dispatch's hard horizon
        blocked every first launch past the first capacity change, so
        nothing downstream of a victim ever ran.  Returns per-state
        ``ready_at`` floors (``id(state) -> time``): killed work backs off
        past the kill instant.
        """
        fp = self._fault_plan
        floors: Dict[int, float] = {}
        if fp is None or not res.task_finish:
            return floors
        # joint-slot demand vectors and owning states, in dispatch order
        dem: List[np.ndarray] = []
        owner: List[_TenantState] = []
        for s, plan in good:
            for r in plan.problem.chosen_options(
                    plan.solution.option_idx)[1]:
                dem.append(r)
                owner.append(s)
        base = np.asarray(self.agora.cluster.caps, float)
        prices = np.asarray(self.agora.cluster.prices_per_sec, float)
        end = clock + max(res.task_finish.values())
        for r in fp.revocations_in(clock, end):
            caps_r = fp.caps_at(r.at, base)
            # committed residue from EARLIER dispatches still running at
            # the revocation instant (each earlier dispatch already shed
            # its own overage when IT processed this revocation)
            usage = np.zeros(len(base))
            for t0, t1, d in self._executed:
                if t0 <= r.at + 1e-9 < t1:
                    usage = usage + d
            active = [jj for jj in list(res.task_finish)
                      if clock + res.task_start[jj] <= r.at + 1e-9
                      and clock + res.task_finish[jj] > r.at + 1e-9]
            for jj in active:
                usage = usage + dem[jj]
            killed: List[_TenantState] = []
            while active and np.any(usage > caps_r + 1e-6):
                jj = max(active, key=lambda x: (res.task_finish[x], x))
                active.remove(jj)
                usage = usage - dem[jj]
                s = owner[jj]
                t_start = clock + res.task_start[jj]
                # the victim really held its demand until the kill: bill
                # the truncated window and keep it in the audit sweep
                s.cost += float((dem[jj] * prices).sum() * (r.at - t_start))
                self._truncated.append((t_start, float(r.at), dem[jj]))
                s.retries += 1
                self.revocation_kills += 1
                del res.task_finish[jj]
                del res.task_start[jj]
                res.task_cost.pop(jj, None)
                killed.append(s)
                delay = max(_backoff_delay(self.cfg, s.retries,
                                           key=_jitter_key(s.name)),
                            self.stream.min_requeue_delta)
                floors[id(s)] = max(floors.get(id(s), 0.0),
                                    float(r.at) + delay)
                self.events.append(
                    f"[t={r.at:9.1f}] tenant {s.name}: running task killed "
                    f"by capacity revocation — re-enqueued")
            if self.sink and (killed or r not in self._revoked_emitted):
                self._revoked_emitted.add(r)
                self.sink.emit(Event(
                    obs.CAPACITY_REVOKED, ts=float(r.at),
                    data={"delta": [float(d) for d in r.delta],
                          "until": finite_or_none(r.until),
                          "caps_after": caps_r.tolist(),
                          "killed": len(killed),
                          "trace_ids": sorted({s.trace for s in killed
                                               if s.trace})}))
        return floors

    def capacity_audit(self) -> Tuple[List[str], np.ndarray]:
        """Sweep every realized interval against the global caps: returns
        (violations, realized headroom = elementwise min of caps - usage
        over the run).  Emits one ``capacity_violation`` event per error
        and one ``capacity_audit`` event carrying the headroom — the
        single accounting the bench gate and ``/v1``-style reporting
        share."""
        caps = np.asarray(self.agora.cluster.caps, float)
        start, finish, demands = self.realized_intervals()
        caps_at = None
        extra: Tuple[float, ...] = ()
        if self._fault_plan is not None:
            # revocation-aware sweep: capacity is a step function of time,
            # and every revocation instant is a sweep point of its own
            # (usage is constant there but the ceiling drops)
            fp = self._fault_plan
            caps_at = lambda t: fp.caps_at(t, caps)  # noqa: E731
            extra = tuple(x for r in fp.cfg.revocations
                          for x in (r.at, r.until) if math.isfinite(x))
        errs = capacity_violations(start, finish, demands, caps,
                                   caps_at=caps_at, extra_points=extra)
        headroom = realized_headroom(start, finish, demands, caps,
                                     caps_at=caps_at, extra_points=extra)
        if self.sink:
            now = getattr(self, "_clock", 0.0)
            for e in errs:
                self.sink.emit(Event(obs.CAPACITY_VIOLATION, ts=now,
                                     data={"error": e}))
            self.sink.emit(Event(
                obs.CAPACITY_AUDIT, ts=now,
                data={"headroom": headroom.tolist(),
                      "caps": caps.tolist(),
                      "intervals": int(len(start)),
                      "revocation_kills": self.revocation_kills}))
        return errs, headroom

    # ------------------------------------------------------------------

    def _dispatch(self, clock: float, good, horizon: float,
                  hard_horizon: float = math.inf) -> FlowResult:
        rnd = len(self.rounds)
        # guaranteed tenants launch through the cut: their plan IS the
        # deadline protection, so only lower classes yield at the horizon
        exempt: List[int] = []
        if self.stream.sla_aware:
            off = 0
            for s, p in good:
                if s.req.sla == SLA_GUARANTEED:
                    exempt.extend(range(off, off + p.problem.num_tasks))
                off += p.problem.num_tasks
        fcfg = dataclasses.replace(self._tenant_cfg(f"round{rnd}", rnd),
                                   launch_horizon=horizon,
                                   horizon_exempt=tuple(exempt),
                                   hard_horizon=hard_horizon)
        if self.shared_cluster:
            joint = combine_plans([p for _, p in good])
            # planned starts gate launches: the joint schedule's staggering
            # IS the capacity arbitration (and with enforce_capacity the
            # executor re-checks the pool at dispatch time)
            joint.problem.release = np.asarray(joint.solution.start,
                                               float).copy()
            res = FlowRunner(joint, fcfg).run()
        else:
            res = self._run_isolated(good, fcfg)
        self.dispatches.append((clock, [(s.name, p) for s, p in good], res))
        self.events.append(
            f"[t={clock:9.1f}] dispatch: {sum(p.problem.num_tasks for _, p in good)} "
            f"tasks, horizon={horizon:.1f}s, finished={len(res.task_finish)}, "
            f"withheld={len(res.unlaunched)}, retries={res.retries}")
        return res

    def _run_isolated(self, good, fcfg: FlowConfig) -> FlowResult:
        """Isolated-quota dispatch: per-tenant runs merged into one joint-
        indexed FlowResult so the accounting path is shared."""
        off = 0
        merged = FlowResult(0.0, 0.0, {}, {}, 0, 0, 0, [])
        for k, (s, plan) in enumerate(good):
            guaranteed = (self.stream.sla_aware
                          and s.req.sla == SLA_GUARANTEED)
            res = FlowRunner(plan, dataclasses.replace(
                fcfg, seed=fcfg.seed + 7919 * k,
                horizon_exempt=tuple(range(plan.problem.num_tasks))
                if guaranteed else ())).run()
            for j, t in res.task_finish.items():
                merged.task_finish[off + j] = t
                merged.task_start[off + j] = res.task_start[j]
                merged.task_cost[off + j] = res.task_cost[j]
                merged.task_retries[off + j] = res.task_retries[j]
                merged.task_speculations[off + j] = res.task_speculations[j]
            merged.unlaunched.extend(off + j for j in res.unlaunched)
            merged.retries += res.retries
            merged.speculations += res.speculations
            merged.makespan = max(merged.makespan, res.makespan)
            merged.cost += res.cost
            off += plan.problem.num_tasks
        return merged

    def _merge(self, clock: float, good, res: FlowResult, requeue_at: float,
               records: List[StreamRecord]) -> List[_TenantState]:
        """Fold one dispatch back into tenant states — each task accounted
        EXACTLY once across rounds — and return re-enqueued remainders."""
        requeue: List[_TenantState] = []
        off = 0
        for s, plan in good:
            Jr = plan.problem.num_tasks
            for li, orig in enumerate(s.remaining):
                j = off + li
                if j not in res.task_finish:
                    continue
                assert orig not in s.done, (s.name, orig)
                s.done[orig] = clock + res.task_finish[j]
                s.started[orig] = clock + res.task_start[j]
                s.cost += res.task_cost[j]
                s.retries += res.task_retries.get(j, 0)
                s.specs += res.task_speculations.get(j, 0)
            s.remaining = [o for o in s.remaining if o not in s.done]
            s.last_plan_makespan = plan.makespan
            off += Jr
            if s.remaining:
                # unlaunched remainder: back to the control plane, eligible
                # at the cut — but never before its own in-flight
                # predecessors drain (re-planning a task ahead of a live
                # pred would break causality).  Under pin_inflight the
                # drain wait is dropped: live predecessors ride the next
                # solve as pinned phantoms instead.
                floor = max(s.done.values(), default=0.0)
                if self.stream.pin_inflight:
                    floor = 0.0
                s.ready_at = max(requeue_at, floor)
                requeue.append(s)
            else:
                records.append(self._record(s, max(s.done.values())))
        return requeue

    def _record(self, s: _TenantState, finished: float,
                failed: bool = False) -> StreamRecord:
        req = s.req
        realized = (finished - min(s.started.values()) if s.started
                    else math.inf)
        rec = StreamRecord(
            name=s.name, submitted=req.submit,
            planned_at=s.first_planned if math.isfinite(s.first_planned)
            else req.submit,
            finished=finished,
            turnaround=finished - req.submit,
            planned_makespan=s.last_plan_makespan,
            realized_makespan=realized,
            cost=s.cost, retries=s.retries, speculations=s.specs,
            plan_retries=s.plan_retries, failed=failed,
            # downgraded tenants report the ORIGINAL guaranteed request
            sla=s.declared_sla, deadline=s.declared_deadline,
            deadline_met=(not failed)
            and finished <= s.declared_deadline + 1e-6,
            preemptions=s.preemptions, rounds=s.rounds,
            admission=s.admission)
        # _record is the exactly-once terminal point of every tenant
        # (rejected, dropped, or served), so the terminal deadline verdict
        # rides it: one deadline_hit/deadline_miss event per tenant
        if self.sink:
            self.sink.emit(Event(
                obs.DEADLINE_HIT if rec.deadline_met else obs.DEADLINE_MISS,
                ts=getattr(self, "_clock", 0.0), tenant=rec.name,
                sla=rec.sla, trace_id=s.trace,
                parent=obs.DROP if rec.failed else obs.DISPATCH,
                data={"deadline": finite_or_none(rec.deadline),
                      "completion": finite_or_none(rec.finished),
                      "failed": rec.failed,
                      "admission": rec.admission}))
        return rec

    # ------------------------------------------------------------------

    @staticmethod
    def _intervals_of(clock: float, plans, res: FlowResult):
        """(abs_start, abs_finish, demand) for every task one dispatch
        executed; ``plans`` is the [(name, Plan)] list in joint slot
        order.  Single source of truth for BOTH the residual-capacity
        reservation (``_executed``) and the violation audit
        (``realized_intervals``)."""
        out: List[Tuple[float, float, np.ndarray]] = []
        off = 0
        for _, plan in plans:
            prob = plan.problem
            task_dem = prob.chosen_options(plan.solution.option_idx)[1]
            for j in range(prob.num_tasks):
                jj = off + j
                if jj in res.task_finish:
                    out.append((clock + res.task_start[jj],
                                clock + res.task_finish[jj],
                                task_dem[j]))
            off += prob.num_tasks
        return out

    def realized_intervals(self):
        """All executed task intervals across rounds, on the absolute
        clock: (start (N,), finish (N,), demands (N, M)) — including the
        truncated windows of revocation-killed runs, which held capacity
        until the kill.  The zero-violation gate sweeps these against the
        (possibly time-varying) capacity."""
        triples = [t for disp in self.dispatches
                   for t in self._intervals_of(*disp)]
        triples.extend(self._truncated)
        M = self.agora.cluster.num_resources
        if not triples:
            return (np.zeros(0), np.zeros(0), np.zeros((0, M)))
        return (np.asarray([t[0] for t in triples]),
                np.asarray([t[1] for t in triples]),
                np.asarray([t[2] for t in triples]))


def _sweep_points(start: np.ndarray, finish: np.ndarray,
                  extra_points: Sequence[float] = ()) -> np.ndarray:
    """Every instant at which realized usage OR capacity can change."""
    pts = [start, finish]
    if len(extra_points):
        pts.append(np.asarray(extra_points, float))
    return np.unique(np.concatenate(pts)) if pts else np.zeros(0)


def capacity_violations(start: np.ndarray, finish: np.ndarray,
                        demands: np.ndarray, caps: np.ndarray,
                        caps_at=None,
                        extra_points: Sequence[float] = ()) -> List[str]:
    """Event-exact sweep of realized intervals against the capacity.

    ``caps_at(t)`` optionally supplies a TIME-VARYING capacity vector
    (chaos revocations); ``extra_points`` adds sweep instants where the
    ceiling moves without any task starting or finishing."""
    errs: List[str] = []
    for pt in _sweep_points(start, finish, extra_points):
        active = (start <= pt + 1e-12) & (pt + 1e-12 < finish)
        usage = (demands[active].sum(axis=0) if active.any()
                 else np.zeros(len(caps)))
        cap_t = caps if caps_at is None else np.asarray(caps_at(pt), float)
        if np.any(usage > cap_t + 1e-6):
            over = np.flatnonzero(usage > cap_t + 1e-6)
            errs.append(f"realized capacity violated at t={pt} "
                        f"(resources {over.tolist()})")
            break
    return errs


def realized_headroom(start: np.ndarray, finish: np.ndarray,
                      demands: np.ndarray, caps: np.ndarray,
                      caps_at=None,
                      extra_points: Sequence[float] = ()) -> np.ndarray:
    """Realized capacity headroom: elementwise min over the run's event
    points of ``caps - usage`` (the full caps when nothing executed).
    With ``caps_at`` the minuend is the effective capacity at each sweep
    point, so revocation windows show up as shrunken headroom."""
    caps = np.asarray(caps, float)
    head = caps.copy()
    for pt in _sweep_points(start, finish, extra_points):
        active = (start <= pt + 1e-12) & (pt + 1e-12 < finish)
        if active.any() or caps_at is not None:
            cap_t = (caps if caps_at is None
                     else np.asarray(caps_at(pt), float))
            usage = (demands[active].sum(axis=0) if active.any()
                     else np.zeros(len(caps)))
            head = np.minimum(head, cap_t - usage)
    return head


def deadline_hit_rate(records: Sequence[StreamRecord],
                      sla: str = SLA_GUARANTEED) -> float:
    """Fraction of ``sla``-class tenants that met their deadline."""
    cls = [r for r in records if getattr(r, "sla", None) == sla
           and math.isfinite(r.deadline)]
    if not cls:
        return 1.0
    return sum(r.deadline_met for r in cls) / len(cls)
