"""PlannerSession: the compile-once / serve-many front door (PyTorch port).

In the port "compile" is signature accounting: each device engine counts
the distinct solve signatures it has run (``core/vectorized.py``), and
``trace_count`` counts batches that ran a signature for the first time.
The text below keeps the reference's vocabulary.

The zero-retrace bucket contract (pack to a power-of-two problem bucket,
keep every shape-bearing knob in one static JIT signature, serve arrivals
out of the live cache entry) grew up as emergent behavior that every
caller of ``Agora.plan_many`` re-implemented.  A ``PlannerSession`` makes
it a first-class API object:

* ``agora.session(shared_capacity=..., bucket_p=..., mesh=...)`` pins the
  static solve signature ONCE — solver engine (``SolveSpec`` resolved
  against the engine registry in ``core/vectorized.py``), ``VecConfig``,
  device mesh, and bucket schedule;
* ``session.warmup(template)`` traces/compiles each power-of-two bucket
  ahead of traffic, so the first tenant of the day pays microseconds, not
  the XLA compile;
* ``session.plan(requests)`` serves typed ``PlanRequest`` batches — within
  a warmed bucket and the template's task-shape envelope it re-traces
  nothing, by construction, and ``session.stats`` proves it
  (``trace_count`` / ``cache_hits`` / per-bucket warmup vs steady-state
  latency) instead of tests poking ``_cache_size()`` on private jit
  wrappers;
* ``session.replan(...)`` re-solves a plan's remainder mid-flight on the
  same pinned signature, and ``session.admit(request)`` runs the cheap
  structural-feasibility precheck (critical-path lower bound vs deadline
  against committed load) the streaming control plane gates guaranteed
  arrivals on.

``Agora.plan`` / ``plan_many`` / ``replan`` remain as thin compatibility
wrappers over a default session (see docs/api.md for the migration table).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from repro_torch.core.dag import DAG, FlatProblem, bucket_size, flatten
from repro_torch.core.objectives import Goal, Solution
from repro_torch.core.vectorized import (SolveBatch, SolveSpec,
                                         VecConfig, resolve_engine)
from repro_torch.device import resolve_device
from repro_torch.obs import events as obs
from repro_torch.obs.aggregate import finite_or_none
from repro_torch.obs.events import Event
from repro_torch.obs.sink import as_sink
from repro_torch.obs.trace import span

# SLA classes (the streaming control plane re-exports these)
SLA_GUARANTEED = "guaranteed"
SLA_STANDARD = "standard"
SLA_BEST_EFFORT = "best_effort"
SLA_CLASSES = (SLA_GUARANTEED, SLA_STANDARD, SLA_BEST_EFFORT)


class PlannerDeprecationWarning(DeprecationWarning):
    """Emitted by the legacy ``Agora.plan_many`` / ``Agora.replan``
    compatibility wrappers.  Still a ``DeprecationWarning`` (generic
    tooling keeps seeing it), but CI's no-internal-callers gate errors on
    THIS subclass specifically, so a third-party library deprecating
    something can never fail the job."""


# ---------------------------------------------------------------------------
# Typed request / result surface
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One planning request: a tenant DAG (or several DAGs co-scheduled
    into ONE plan), its objective, and its SLA envelope.

    Replaces the parallel ``dags``/``goals``/``refs`` list kwargs of the
    legacy ``Agora.plan_many``:

    * ``goal`` — per-tenant objective; ``None`` means the session default.
    * ``sla`` / ``deadline`` — the SLA class and ABSOLUTE deadline used by
      ``PlannerSession.admit`` (the solver-side deadline hinge still rides
      in ``goal.deadline``; see ``flow.streaming.sla_goal``).
    * ``ref`` — (makespan, cost) reference point of Eq. 1; ``None`` means
      "compute it for me" (per request, so a mixed list is fine).
    * ``trace`` — causal trace id (schema v2): stamped once at the front
      door (daemon ``submit`` / streaming arrival), carried through every
      layer that handles the request, and echoed on the events they emit
      (``Event.trace_id`` / batch ``data["trace_ids"]``) so
      ``obs_report --trace`` can reconstruct the request's span timeline.
    """
    dag: Union[DAG, Tuple[DAG, ...]]
    goal: Optional[Goal] = None
    sla: str = SLA_STANDARD
    deadline: float = math.inf
    ref: Optional[Tuple[float, float]] = None
    trace: Optional[str] = None

    @property
    def dags(self) -> Tuple[DAG, ...]:
        return (self.dag,) if isinstance(self.dag, DAG) else tuple(self.dag)

    @property
    def name(self) -> str:
        return "+".join(d.name for d in self.dags)


@dataclasses.dataclass(frozen=True)
class ConvergenceTrace:
    """The strided in-solve convergence telemetry of ONE request's problem,
    folded from the solver's aux outputs (``VecConfig.telemetry``).

    ``steps`` are the sampled sweep indices; ``best_e`` the incumbent
    (best-so-far) energy at each sample — monotone non-increasing;
    ``accept`` the Metropolis acceptance fraction across chains at the
    sample sweep; ``migrations`` the cumulative replica-exchange count.
    """
    steps: np.ndarray
    best_e: np.ndarray
    accept: np.ndarray
    migrations: np.ndarray
    iters: int = 0                     # total SA sweeps of the solve
    chains: int = 0

    @classmethod
    def from_telemetry(cls, tel) -> Optional["ConvergenceTrace"]:
        """Fold the raw per-problem aux dict a batched solver attached to
        its Solution (``None`` in, ``None`` out — host solvers and
        telemetry-off solves carry no aux)."""
        if not tel:
            return None
        return cls(steps=np.asarray(tel["steps"]),
                   best_e=np.asarray(tel["best_e"], float),
                   accept=np.asarray(tel["accept"], float),
                   migrations=np.asarray(tel["migrations"]),
                   iters=int(tel["iters"]), chains=int(tel["chains"]))

    @property
    def steps_to_best(self) -> int:
        """First sampled sweep at which the incumbent had already reached
        its final energy — the budget the solve actually needed."""
        at_final = self.best_e <= self.best_e[-1]
        return int(self.steps[int(np.argmax(at_final))])

    @property
    def plateau_fraction(self) -> float:
        """Fraction of the sampled trace spent flat at the final incumbent
        (1.0 = the whole recorded trace was plateau — step budget wasted)."""
        return float(np.mean(self.best_e <= self.best_e[-1]))

    @property
    def accept_decay(self) -> float:
        """Acceptance-rate drop from the first to the last sample (positive
        = the cooling schedule is biting; ~0 = still random-walking)."""
        return float(self.accept[0] - self.accept[-1])

    def summary(self) -> Dict[str, object]:
        """JSON-safe roll-up — the ``solve_profile`` event payload."""
        return {"steps_to_best": self.steps_to_best,
                "plateau_fraction": self.plateau_fraction,
                "accept_first": float(self.accept[0]),
                "accept_last": float(self.accept[-1]),
                "accept_decay": self.accept_decay,
                "best_e": float(self.best_e[-1]),
                "migrations": int(self.migrations[-1]),
                "samples": int(len(self.steps)),
                "iters": self.iters, "chains": self.chains}


@dataclasses.dataclass
class PlanResult:
    """One served plan plus its serving context (which request, which
    bucket, whether this batch traced or rode the warm cache).
    ``convergence`` carries the request's in-solve telemetry when the
    session's ``VecConfig.telemetry`` flag is on (else ``None``)."""
    plan: "Plan"                       # noqa: F821 — repro_torch.core.agora.Plan
    request: Optional[PlanRequest]
    index: int = 0
    bucket: int = 1                    # padded problem-axis extent served at
    traced: bool = False               # batch added a JIT cache entry (cold)
    solve_seconds: float = 0.0         # wall time of the whole batch solve
    convergence: Optional[ConvergenceTrace] = None
    # served by the daemon's greedy fallback path while the pool's circuit
    # breaker was open (a valid but not annealed plan) — callers that care
    # about plan quality must check this flag
    degraded: bool = False

    @property
    def solution(self) -> Solution:
        return self.plan.solution

    @property
    def makespan(self) -> float:
        return self.plan.makespan

    @property
    def cost(self) -> float:
        return self.plan.cost

    def validate(self) -> List[str]:
        return self.plan.validate()


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of the structural-feasibility precheck."""
    admitted: bool
    reason: str = ""
    # provable earliest completion (absolute clock): release-aware critical
    # path of per-task best-case durations, started no earlier than the
    # committed pool frees capacity for the request
    completion_lower_bound: float = 0.0


# ---------------------------------------------------------------------------
# Observable contract: session statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BucketStats:
    """Per-bucket serving telemetry (bucket = padded problem-axis extent)."""
    bucket: int
    plans: int = 0                     # batches served at this bucket
    traces: int = 0                    # batches that added a JIT cache entry
    cache_hits: int = 0                # batches served from the live cache
    warmup_seconds: float = math.nan   # latest cold (tracing) solve wall time
    steady_seconds: float = math.nan   # latest warm (cache-hit) solve wall time


@dataclasses.dataclass
class SessionStats:
    """The zero-retrace contract, observable: assert ``trace_count`` stays
    flat across a warmed bucket's arrivals instead of poking the solver's
    private JIT caches."""
    trace_count: int = 0
    cache_hits: int = 0
    plans: int = 0                     # plan() batches served
    replans: int = 0
    warmups: int = 0                   # buckets compiled ahead of traffic
    admitted: int = 0
    rejected: int = 0
    buckets: Dict[int, BucketStats] = dataclasses.field(default_factory=dict)

    def bucket(self, p: int) -> BucketStats:
        return self.buckets.setdefault(p, BucketStats(p))


# ---------------------------------------------------------------------------
# Request validation (typed errors carrying the offending request index)
# ---------------------------------------------------------------------------


def _check_ref(ref, i: int) -> Optional[Tuple[float, float]]:
    if ref is None:
        return None
    try:
        m, c = float(ref[0]), float(ref[1])
    except (TypeError, ValueError, IndexError):
        raise ValueError(
            f"requests[{i}]: reference point must be a (makespan, cost) "
            f"pair or None, got {ref!r}") from None
    if len(tuple(ref)) != 2 or not (math.isfinite(m) and math.isfinite(c)
                                    and m > 0 and c > 0):
        raise ValueError(
            f"requests[{i}]: reference point must be a finite positive "
            f"(makespan, cost) pair, got {ref!r}")
    return (m, c)


def check_refs(refs, n: int) -> Optional[list]:
    """Legacy-kwarg LENGTH validation for the ``plan_many`` wrapper: a
    ``None`` entry mid-list means "recompute this one" (documented, not an
    accident); a length mismatch raises a typed error instead of silently
    zip-truncating.  Per-entry validation is owned by
    ``_normalize_request`` (same indexed error messages)."""
    if refs is None:
        return None
    refs = list(refs)
    if len(refs) != n:
        raise ValueError(f"refs has {len(refs)} entries for {n} planning "
                         f"requests")
    return refs


def check_goals(goals, n: int) -> Optional[list]:
    if goals is None:
        return None
    goals = list(goals)
    if len(goals) != n:
        raise ValueError(f"goals has {len(goals)} entries for {n} planning "
                         f"requests")
    return goals


def _batch_shape(problems: Sequence[FlatProblem]) -> Tuple[int, int]:
    """The task-shape envelope (Jmax, Omax) a batch pads to — together
    with the problem-axis bucket, the static JIT signature it compiles."""
    jmax = max(p.num_tasks for p in problems)
    omax = max(max(len(t.options) for t in p.tasks) for p in problems)
    return jmax, omax


def _normalize_request(req, i: int) -> PlanRequest:
    if isinstance(req, DAG):
        req = PlanRequest(dag=req)
    if not isinstance(req, PlanRequest):
        raise ValueError(f"requests[{i}]: expected PlanRequest or DAG, "
                         f"got {type(req).__name__}")
    dags = req.dags
    if not dags or not all(isinstance(d, DAG) for d in dags):
        raise ValueError(f"requests[{i}]: dag must be a DAG or a non-empty "
                         f"sequence of DAGs")
    if req.sla not in SLA_CLASSES:
        raise ValueError(f"requests[{i}]: unknown SLA class {req.sla!r} "
                         f"(expected one of {SLA_CLASSES})")
    if req.sla == SLA_GUARANTEED and not math.isfinite(req.deadline):
        raise ValueError(f"requests[{i}]: guaranteed-class requests need a "
                         f"finite deadline")
    if req.goal is not None and not isinstance(req.goal, Goal):
        raise ValueError(f"requests[{i}]: goal must be a Goal or None, "
                         f"got {type(req.goal).__name__}")
    _check_ref(req.ref, i)
    return req


def check_demands(req: PlanRequest, i: int = 0) -> None:
    """Refuse a request whose task options hold a negative or non-finite
    demand. The scheduler (``core/sgs.py``) refuses such demands for the
    whole problem it places, so inside a batch one of them would fail
    every request beside it; a service checks each request on entry."""
    for d in req.dags:
        for t in d.tasks:
            for o in t.options:
                for x in o.demands:
                    if not 0.0 <= x < math.inf:
                        raise ValueError(
                            f"requests[{i}]: DAG {d.name!r} task "
                            f"{t.name!r} option {o.label!r}: demands must "
                            f"be finite and non-negative, got "
                            f"{tuple(o.demands)!r}")


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

_UNSET = object()


class PlannerSession:
    """Compile-once / serve-many planning front door (see module docstring).

    Construct through ``Agora.session(...)``; the session pins the solve
    signature (engine, ``VecConfig``, mesh, bucket schedule, cluster,
    default goal) at construction and every ``plan``/``replan`` call rides
    it.  ``capacity=`` on ``plan`` narrows the round's capacity vector
    (e.g. the streaming control plane's residual-pool snapshot) WITHOUT
    re-tracing — capacities are traced arguments, never static.
    """

    def __init__(self, agora, *, shared_capacity: bool = False,
                 bucket_p=None, mesh=_UNSET, goal: Optional[Goal] = None,
                 vec_cfg: Optional[VecConfig] = None, sink=None,
                 device=None):
        self.agora = agora
        self.cluster = agora.cluster
        self.goal = goal or agora.goal
        self.solver = agora.solver
        self.vec_cfg = vec_cfg or agora.vec_cfg
        self.anneal_cfg = agora.anneal_cfg
        self.mesh = agora.mesh if mesh is _UNSET else mesh
        # the Agora's device unless the caller names another one
        self.device = (agora.device if device is None
                       else resolve_device(device))
        self.bucket_p = bucket_p
        self.shared_capacity = bool(shared_capacity)
        mesh_axes = 0 if self.mesh is None else len(self.mesh.axis_names)
        self.spec = SolveSpec(solver=self.solver,
                              shared_capacity=self.shared_capacity,
                              mesh_axes=mesh_axes)
        self.engine = resolve_engine(self.spec)
        self.stats = SessionStats()
        # observability plane: the no-op default is falsy, so every
        # emission site below is `if self.sink:` — disabled costs one
        # truthiness check and solves are bit-for-bit identical
        self.sink = as_sink(sink)
        # warmed signatures: (bucket, Jmax, Omax) triples this session has
        # already traced — a batch landing inside one is served with zero
        # re-tracing BY construction; the serving daemon routes on this
        self.envelopes: Set[Tuple[int, int, int]] = set()
        # pool safety: a session may be driven from several threads (the
        # serving daemon's per-pool executors + its background warmup
        # thread).  One reentrant lock serializes solve + stats accounting
        # per session, so trace_count/cache_hits never tear and the
        # cache-size-delta trace detection stays race-free.  Distinct
        # sessions in a pool still solve concurrently.
        self._lock = threading.RLock()

    # -- pinned-solver plumbing ----------------------------------------

    def _chains_mesh(self):
        """Only a legacy 1-D chains mesh applies to single-problem solves
        (a 2-axis planner mesh shards the batched engines only)."""
        if self.mesh is not None and len(self.mesh.axis_names) == 1:
            return self.mesh
        return None

    def _planner_mesh(self):
        """Only a 2-axis (prob, chain) planner mesh shards the batched
        engines; a legacy chains mesh routes to the host loop instead."""
        if self.mesh is not None and len(self.mesh.axis_names) == 2:
            return self.mesh
        return None

    def _solve_single(self, problem: FlatProblem, ref, goal: Goal,
                      cluster=None) -> Solution:
        """The spec-faithful single-problem solver: what the sequential
        host engines loop over, and what ``plan_joint`` rides."""
        cluster = cluster or self.cluster
        if self.solver == "anneal":
            from repro_torch.core.annealer import anneal
            return anneal(problem, cluster, goal, self.anneal_cfg, ref)
        if self.solver == "ising":
            from repro_torch.core.ising import ising_anneal
            return ising_anneal(problem, cluster, goal, ref=ref,
                                device=self.device)
        from repro_torch.core.vectorized import vectorized_anneal
        return vectorized_anneal(problem, cluster, goal, self.vec_cfg, ref,
                                 mesh=self._chains_mesh(), device=self.device)

    def _cluster_for(self, capacity) -> "Cluster":  # noqa: F821
        """The round's cluster: the pinned one, or a same-typed cluster
        narrowed to ``capacity`` (a residual-pool snapshot).  Capacities
        are traced on device, so narrowing never re-traces."""
        if capacity is None:
            return self.cluster
        caps = np.maximum(np.asarray(capacity, float), 0.0)
        if caps.shape != (self.cluster.num_resources,):
            raise ValueError(f"capacity must have {self.cluster.num_resources} "
                             f"entries, got shape {caps.shape}")
        if np.allclose(caps, np.asarray(self.cluster.caps, float)):
            return self.cluster
        from repro_torch.cluster.catalog import Cluster
        return Cluster(self.cluster.types, tuple(float(c) for c in caps))

    def _single_cache_size(self) -> int:
        """JIT cache backing the single-problem path (replan/plan_joint)."""
        if self.solver != "vectorized":
            return 0
        from repro_torch.core.vectorized import _ENGINES
        return _ENGINES["isolated"].cache_size()

    # -- serving -------------------------------------------------------

    def plan(self, requests: Sequence[Union[PlanRequest, DAG]], *,
             capacity=None) -> List[PlanResult]:
        """Serve one batch: P typed requests -> P plans, one engine
        dispatch.

        Residual-capacity snapshots (``capacity=``) and per-tenant goals
        flow through this ONE typed path; within a warmed bucket and the
        warmup template's task-shape envelope the call re-traces nothing
        (``stats.trace_count`` stays flat — the observable contract).
        Time anchoring is the caller's: DAG ``release_time``s (and goal
        deadlines, which are solve-relative) define the batch's clock.
        """
        requests = [_normalize_request(r, i) for i, r in enumerate(requests)]
        if not requests:
            return []
        return self._serve(requests, capacity=capacity)

    def _serve(self, requests: List[PlanRequest], *,
               capacity=None, bucket_override=None,
               warming: bool = False) -> List[PlanResult]:
        from repro_torch.core.agora import Plan
        from repro_torch.core.annealer import reference_point

        # the batch's phases, for the solve event (only where it is emitted)
        phases = [] if self.sink else None
        with span(phases, "session.prep"):
            cluster = self._cluster_for(capacity)
            with span(phases, "session.flatten", "session.prep"):
                problems = [flatten(list(r.dags), cluster.num_resources)
                            for r in requests]
            with span(phases, "session.reference", "session.prep"):
                refs = [r.ref if r.ref is not None
                        else reference_point(p, cluster)
                        for r, p in zip(requests, problems)]
            goals = [r.goal or self.goal for r in requests]
            bucket_p = (self.bucket_p if bucket_override is None
                        else bucket_override)
            batch = SolveBatch(
                spec=self.spec, problems=problems, cluster=cluster,
                goal=self.goal, goals=goals, refs=refs, cfg=self.vec_cfg,
                bucket_p=bucket_p, mesh=self._planner_mesh(),
                solve_single=lambda p, r, g: self._solve_single(p, r, g,
                                                                cluster),
                device=self.device, spans=phases)

        t_wait = time.time_ns()
        with self._lock:
            n0 = self.engine.cache_size()
            t_solve = time.time_ns()
            t0 = time.monotonic()
            sols, joint_errors = self.engine.fn(batch)
            dt = time.monotonic() - t0
            t_end = time.time_ns()
            traced = self.engine.cache_size() > n0

            # a 2-axis planner mesh auto-buckets the problem axis up to its
            # first axis (see vectorized_anneal_many); mirror that so the
            # recorded bucket matches the signature actually compiled
            mesh = batch.mesh
            if mesh is not None:
                bucket_p = max(int(bucket_p or 1),
                               mesh.shape[mesh.axis_names[0]])
            bucket = bucket_size(len(problems), bucket_p)
            jmax, omax = _batch_shape(problems)
            self._account(bucket, traced, dt, warming=warming)
            self.envelopes.add((bucket, jmax, omax))

        convs = [ConvergenceTrace.from_telemetry(getattr(s, "telemetry",
                                                         None))
                 for s in sols]
        trace_ids = [r.trace for r in requests if r.trace is not None]
        if self.sink:
            phases += [["session.lock", t_wait, t_solve, None],
                       ["engine.solve", t_solve, t_end, None]]
            self._emit_dispatch(traced, dt, bucket=bucket, jmax=jmax,
                                omax=omax, warming=warming,
                                trace_ids=trace_ids, spans=phases)
            if not warming:
                data = {"kind": "plan", "n": len(requests),
                        "bucket": bucket, "traced": traced, "seconds": dt}
                if trace_ids:
                    data["trace_ids"] = trace_ids
                self.sink.emit(Event(
                    obs.PLAN_SOLVED, ts=time.monotonic(), data=data))
                if any(c is not None for c in convs):
                    # exactly ONE solve_profile per live engine dispatch:
                    # the convergence roll-up of every telemetry-bearing
                    # request in the batch
                    profiles = [dict(tenant=req.name, **c.summary())
                                for req, c in zip(requests, convs)
                                if c is not None]
                    pdata = {"n": len(requests), "bucket": bucket,
                             "seconds": dt, "profiles": profiles}
                    if trace_ids:
                        pdata["trace_ids"] = trace_ids
                    self.sink.emit(Event(
                        obs.SOLVE_PROFILE, ts=time.monotonic(), data=pdata))

        plans = [Plan(p, s, g, cluster, r, joint_errors=joint_errors)
                 for p, s, r, g in zip(problems, sols, refs, goals)]
        return [PlanResult(plan, req, index=i, bucket=bucket, traced=traced,
                           solve_seconds=dt, convergence=conv)
                for i, (plan, req, conv)
                in enumerate(zip(plans, requests, convs))]

    def _emit_dispatch(self, traced: bool, seconds: float, *, bucket: int,
                       jmax: Optional[int] = None,
                       omax: Optional[int] = None,
                       warming: bool = False,
                       trace_ids: Optional[List[str]] = None,
                       spans: Optional[list] = None) -> None:
        """Exactly one of ``bucket_traced`` / ``cache_hit`` per engine
        dispatch. ``spans`` are the batch's phases (``obs.trace.span``
        records)."""
        if not self.sink:
            return
        data = {"bucket": bucket, "seconds": seconds, "warming": warming}
        if jmax is not None:
            data["jmax"], data["omax"] = jmax, omax
        if trace_ids:
            data["trace_ids"] = list(trace_ids)
        if spans:
            data["spans"] = spans
        self.sink.emit(Event(obs.BUCKET_TRACED if traced else obs.CACHE_HIT,
                             ts=time.monotonic(), data=data))

    def _account(self, bucket: int, traced: bool, seconds: float, *,
                 warming: bool = False, replan: bool = False) -> None:
        st, bs = self.stats, self.stats.bucket(bucket)
        if warming:
            st.warmups += 1
        elif replan:
            st.replans += 1
        else:
            st.plans += 1
            bs.plans += 1
        if traced:
            st.trace_count += 1
            bs.traces += 1
            bs.warmup_seconds = seconds
        else:
            st.cache_hits += 1
            bs.cache_hits += 1
            if not warming:
                bs.steady_seconds = seconds

    # -- ahead-of-time compilation -------------------------------------

    def warmup(self, template: Union[PlanRequest, DAG], *,
               buckets: Optional[Sequence[int]] = None,
               max_p: Optional[int] = None) -> Dict[int, float]:
        """Trace/compile the pinned signature for each power-of-two bucket
        BEFORE traffic arrives; returns ``{bucket: wall_seconds}``.

        ``template`` fixes the task-shape envelope (Jmax, Omax): live
        batches whose padded task shape matches the template's are then
        served with zero re-tracing.  Default buckets: the session's
        minimum bucket; pass ``max_p`` to pre-pay every power of two up to
        it, or ``buckets`` explicitly."""
        template = _normalize_request(template, 0)
        if buckets is None:
            lo = bucket_size(1, self.bucket_p)
            hi = bucket_size(max(max_p or lo, lo), self.bucket_p)
            buckets, b = [], lo
            while b <= hi:
                buckets.append(b)
                b <<= 1
        out: Dict[int, float] = {}
        for b in sorted(set(int(b) for b in buckets)):
            # one template request padded out to bucket b: padded slots are
            # fully masked, so this compiles exactly the static signature
            # a live batch of <= b tenants at this task shape will hit
            res = self._serve([template], bucket_override=b, warming=True)
            out[b] = res[0].solve_seconds
        return out

    def warmup_async(self, template: Union[PlanRequest, DAG], *,
                     buckets: Optional[Sequence[int]] = None,
                     max_p: Optional[int] = None,
                     executor=None) -> "concurrent.futures.Future":
        """``warmup`` off the serving path: trace/compile in a background
        thread (or on ``executor``) and return a ``Future`` resolving to
        the same ``{bucket: wall_seconds}`` map.

        The session lock serializes the background trace against live
        ``plan`` calls, so a serving thread never observes a torn cache —
        it either rides the freshly warmed entry or waits its turn.  This
        is the hook the serving daemon's envelope auto-widening rides:
        when a batch exits the warmed ``(bucket, Jmax, Omax)`` envelope,
        the NEXT envelope is compiled here instead of on a tenant's
        critical path."""
        if executor is not None:
            return executor.submit(self.warmup, template, buckets=buckets,
                                   max_p=max_p)
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _run():
            try:
                fut.set_result(self.warmup(template, buckets=buckets,
                                           max_p=max_p))
            except BaseException as e:  # noqa: BLE001 — surfaced via Future
                fut.set_exception(e)

        threading.Thread(target=_run, name="planner-warmup",
                         daemon=True).start()
        return fut

    # -- envelope routing (what the serving daemon dispatches on) -------

    def bucket_for(self, n: int) -> int:
        """The power-of-two bucket a batch of ``n`` requests is served at
        (without a mesh override; see ``_serve`` for the mesh case)."""
        return bucket_size(n, self.bucket_p)

    def is_warm(self, n: int, jmax: int, omax: int) -> bool:
        """True when a batch of ``n`` requests padding to task shape
        ``(jmax, omax)`` lands inside an already-traced signature — i.e.
        serving it re-traces nothing, by construction."""
        return (self.bucket_for(n), jmax, omax) in self.envelopes

    # -- one-shot joint planning (the legacy ``Agora.plan`` semantics) --

    def plan_joint(self, dags: Sequence[DAG],
                   ref: Optional[Tuple[float, float]] = None,
                   goal: Optional[Goal] = None) -> PlanResult:
        """Co-schedule ``dags`` into ONE plan on a shared timeline via the
        pinned single-problem solver (the P=1 special case; what the
        legacy ``Agora.plan`` wrapper delegates to)."""
        from repro_torch.core.agora import Plan
        from repro_torch.core.annealer import reference_point

        goal = goal or self.goal
        problem = flatten(list(dags), self.cluster.num_resources)
        if ref is None:
            ref = reference_point(problem, self.cluster)
        else:
            ref = _check_ref(ref, 0)
        with self._lock:
            n0 = self._single_cache_size()
            t0 = time.monotonic()
            sol = self._solve_single(problem, ref, goal)
            dt = time.monotonic() - t0
            traced = self._single_cache_size() > n0
            self._account(1, traced, dt)
        if self.sink:
            self._emit_dispatch(traced, dt, bucket=1)
            self.sink.emit(Event(
                obs.PLAN_SOLVED, ts=time.monotonic(),
                data={"kind": "plan_joint", "n": len(tuple(dags)),
                      "bucket": 1, "traced": traced, "seconds": dt}))
        return PlanResult(Plan(problem, sol, goal, self.cluster, ref),
                          request=None, bucket=1, traced=traced,
                          solve_seconds=dt)

    # -- mid-flight re-planning ----------------------------------------

    def replan(self, plan, *, now: float, done: Sequence[int] = (),
               running: Sequence[Tuple[int, float]] = (),
               new_dags: Sequence[DAG] = (), cluster=None,
               duration_scale: Optional[Dict[int, float]] = None
               ) -> PlanResult:
        """Re-solve a plan's remainder (completed tasks dropped, running
        tasks pinned, stragglers re-scaled, optionally elastic cluster) on
        the session's pinned signature.  Bit-for-bit identical to the
        legacy ``Agora.replan`` path (differential-tested)."""
        from repro_torch.core.agora import Plan, remainder_problem
        from repro_torch.core.annealer import reference_point

        if isinstance(plan, PlanResult):
            plan = plan.plan
        cluster = cluster or self.cluster
        prob = remainder_problem(plan, now=now, done=done, running=running,
                                 new_dags=new_dags, cluster=cluster,
                                 duration_scale=duration_scale)
        ref = reference_point(prob, cluster)
        with self._lock:
            n0 = self._single_cache_size()
            t0 = time.monotonic()
            if self.solver == "anneal":
                from repro_torch.core.annealer import anneal
                sol = anneal(prob, cluster, self.goal, self.anneal_cfg, ref)
            else:
                # mirrors the legacy replan exactly: ising has no
                # incremental re-plan path, so it re-solves through the
                # vectorized engine
                from repro_torch.core.vectorized import vectorized_anneal
                sol = vectorized_anneal(prob, cluster, self.goal,
                                        self.vec_cfg, ref,
                                        mesh=self._chains_mesh(),
                                        device=self.device)
            dt = time.monotonic() - t0
            traced = self._single_cache_size() > n0
            self._account(1, traced, dt, replan=True)
        if self.sink:
            self._emit_dispatch(traced, dt, bucket=1)
            self.sink.emit(Event(
                obs.PLAN_SOLVED, ts=time.monotonic(),
                data={"kind": "replan", "n": 1, "bucket": 1,
                      "traced": traced, "seconds": dt}))
        return PlanResult(Plan(prob, sol, self.goal, cluster, ref),
                          request=None, bucket=1, traced=traced,
                          solve_seconds=dt)

    # -- admission control ---------------------------------------------

    def admit(self, request: Union[PlanRequest, DAG], *, now: float = 0.0,
              available_at: Optional[float] = None,
              capacity=None) -> AdmissionDecision:
        """Cheap structural-feasibility precheck — no solve, O(J) host work.

        Two provable rejections (anything else is admitted):

        * structural — some task has NO configuration fitting the full
          pool (``capacity`` defaults to the session cluster's caps): no
          schedule can ever place it;
        * deadline — the release-aware critical path of per-task BEST-case
          durations, started no earlier than ``available_at`` (the instant
          the committed load provably frees capacity for this request),
          already overshoots the request's absolute deadline: every policy
          misses, so best-effort missing it later only wastes the pool.

        The control plane records the decision instead of silently
        burning rounds on a guaranteed tenant nothing can save.
        """
        request = _normalize_request(request, 0)
        caps = np.asarray(self.cluster.caps if capacity is None else capacity,
                          float)
        problem = flatten(list(request.dags), self.cluster.num_resources)
        min_dur = np.empty(problem.num_tasks)
        for j, task in enumerate(problem.tasks):
            fits = [o.duration for o in task.options
                    if np.all(np.asarray(o.demands) <= caps + 1e-9)]
            if not fits:
                with self._lock:
                    self.stats.rejected += 1
                return self._emit_admission(request, AdmissionDecision(
                    False, f"task {j} ({task.name}) fits no configuration "
                           f"within capacity {caps.tolist()}",
                    completion_lower_bound=math.inf))
            min_dur[j] = min(fits)
        start = max(now, available_at if available_at is not None else now)
        cp = problem.as_dag().critical_path_lengths(min_dur)
        release = np.maximum(np.asarray(problem.release, float), start)
        lb = float((release + cp).max()) if problem.num_tasks else start
        if math.isfinite(request.deadline) and lb > request.deadline + 1e-9:
            with self._lock:
                self.stats.rejected += 1
            return self._emit_admission(request, AdmissionDecision(
                False, f"critical-path lower bound t={lb:.1f} overshoots "
                       f"deadline t={request.deadline:.1f}",
                completion_lower_bound=lb))
        with self._lock:
            self.stats.admitted += 1
        return self._emit_admission(
            request, AdmissionDecision(True, completion_lower_bound=lb))

    def _emit_admission(self, request: PlanRequest,
                        decision: AdmissionDecision) -> AdmissionDecision:
        """One ``admission_decision`` event per ``admit`` call — every exit
        (structural reject, deadline reject, admit) routes through here."""
        if self.sink:
            self.sink.emit(Event(
                obs.ADMISSION_DECISION, ts=time.monotonic(),
                tenant=request.name, sla=request.sla,
                trace_id=request.trace,
                parent=obs.SUBMIT if request.trace else None,
                data={"admitted": decision.admitted,
                      "reason": decision.reason,
                      "deadline": finite_or_none(request.deadline),
                      "lower_bound":
                          finite_or_none(decision.completion_lower_bound)}))
        return decision
