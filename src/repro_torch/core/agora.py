"""AGORA front-door: plan one or more DAGs against a heterogeneous cluster
(PyTorch port; ``device`` defaults to ``"cuda"``).

Mirrors the system architecture of Fig. 5: the Predictor has already turned
event logs into per-task option grids (``Task.options``); planning is served
through ``PlannerSession`` objects (``Agora.session(...)`` — the
compile-once / serve-many front door, see ``core/session.py`` and
docs/api.md).  ``Agora.plan`` / ``plan_many`` / ``replan`` remain as thin
compatibility wrappers over a default session; ``replan`` supports the
multi-DAG / elastic triggers of §5.5.1 (new submissions every 15 min or
queue pressure, node loss, straggler re-estimation).

This module also registers the sequential HOST engines with the
``SolveSpec -> engine`` registry (``core/vectorized.py``): host-side
solvers ("anneal", "ising") and the legacy 1-D chains-mesh mode have no
batched device path, so they serve isolated batches as a per-problem loop
and shared batches as one joint solve split back per tenant.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.catalog import Cluster
from repro_torch.core.annealer import AnnealConfig, reference_point
from repro_torch.core.dag import DAG, FlatProblem, concat_problems, flatten
from repro_torch.core.objectives import Goal, Solution
from repro_torch.core.sgs import (schedule_cost, validate_schedule,
                                  validate_schedule_many)
from repro_torch.core.vectorized import (SolveBatch, VecConfig,
                                         register_engine)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Plan:
    problem: FlatProblem
    solution: Solution
    goal: Goal
    cluster: Cluster
    reference: Tuple[float, float]
    # shared-capacity mode: event-exact joint validation of the batch this
    # plan was co-scheduled with (None for isolated / single plans)
    joint_errors: Optional[List[str]] = None

    @property
    def makespan(self) -> float:
        return self.solution.makespan

    @property
    def cost(self) -> float:
        return self.solution.cost

    def config_labels(self) -> List[str]:
        return [t.options[self.solution.option_idx[j]].label
                for j, t in enumerate(self.problem.tasks)]

    def validate(self) -> List[str]:
        return validate_schedule(self.problem, self.solution.option_idx,
                                 self.solution.start, self.solution.finish,
                                 self.cluster.caps)

    def per_dag_completion(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for di, name in enumerate(self.problem.dag_names):
            mask = self.problem.dag_of == di
            out[name] = float(self.solution.finish[mask].max()
                              - self.problem.release[mask].min())
        return out


# ---------------------------------------------------------------------------
# Sequential host engines (SolveSpec registry entries)
# ---------------------------------------------------------------------------


def _sequential_solve(batch: SolveBatch):
    """Shared body of the host engines: isolated batches loop the
    spec-faithful single-problem solver; shared batches run ONE joint
    co-scheduled solve and split it back into per-tenant solutions on the
    common timeline (with the event-exact joint validation attached)."""
    if not batch.spec.shared_capacity:
        return [batch.solve_single(p, r, g)
                for p, r, g in zip(batch.problems, batch.refs,
                                   batch.goals)], None
    joint = concat_problems(batch.problems)
    joint_sol = batch.solve_single(joint, reference_point(joint, batch.cluster),
                                   batch.goal)
    sols: List[Solution] = []
    per_tenant = []
    off = 0
    for prob, ref, g in zip(batch.problems, batch.refs, batch.goals):
        Jp = prob.num_tasks
        sl = slice(off, off + Jp)
        oi = joint_sol.option_idx[sl]
        s, f = joint_sol.start[sl], joint_sol.finish[sl]
        cost = schedule_cost(prob, oi, batch.cluster.prices_per_sec)
        mk = float(f.max())
        sols.append(Solution(oi, s, f, mk, cost,
                             g.energy(mk, cost, ref[0], ref[1]),
                             solver=joint_sol.solver + "-shared-split"))
        per_tenant.append((oi, s, f))
        off += Jp
    joint_errors = validate_schedule_many(
        list(batch.problems), [t[0] for t in per_tenant],
        [t[1] for t in per_tenant], [t[2] for t in per_tenant],
        batch.cluster.caps)
    return sols, joint_errors


# "host-anneal" also serves the legacy 1-D chains-mesh vectorized mode —
# the sequential shape is the same, only batch.solve_single differs
register_engine("host-anneal", _sequential_solve)
register_engine("ising", _sequential_solve)


# ---------------------------------------------------------------------------
# Mid-flight re-planning: the problem surgery shared by Agora.replan and
# PlannerSession.replan
# ---------------------------------------------------------------------------


def remainder_problem(plan: Plan, *, now: float,
                      done: Sequence[int] = (),
                      running: Sequence[Tuple[int, float]] = (),
                      new_dags: Sequence[DAG] = (),
                      cluster: Optional[Cluster] = None,
                      duration_scale: Optional[Dict[int, float]] = None
                      ) -> FlatProblem:
    """The remainder instance of a mid-flight re-plan: completed tasks
    dropped, running tasks pinned as zero-choice predecessors-done,
    durations re-scaled for observed stragglers, new submissions appended
    (released no earlier than ``now``)."""
    cluster = cluster or plan.cluster
    old = plan.problem
    keep = [j for j in range(old.num_tasks) if j not in set(done)]
    remap = {j: i for i, j in enumerate(keep)}
    tasks = []
    for j in keep:
        t = old.tasks[j]
        if duration_scale and j in duration_scale:
            s = duration_scale[j]
            t = dataclasses.replace(t, options=[
                dataclasses.replace(o, duration=o.duration * s,
                                    cost=o.cost * s) for o in t.options])
        tasks.append(t)
    edges = [(remap[a], remap[b]) for a, b in old.edges
             if a in remap and b in remap]
    release = np.maximum(old.release[keep], now)
    # pin running tasks: single option = remaining duration at current cfg
    run_map = dict(running)
    for j, rem in run_map.items():
        if j in remap:
            i = remap[j]
            opt = old.tasks[j].options[plan.solution.option_idx[j]]
            tasks[i] = dataclasses.replace(
                tasks[i], options=[dataclasses.replace(
                    opt, duration=max(rem, 1e-6))], default_option=0)
            release[i] = now
    # copy the DAG bookkeeping: appending new_dags below must never mutate
    # the input plan's problem in place
    prob = FlatProblem(tasks, edges, old.dag_of[keep],
                       list(old.dag_names), release, cluster.num_resources)
    for d in new_dags:
        extra = flatten([d], cluster.num_resources)
        base = prob.num_tasks
        prob.tasks.extend(extra.tasks)
        prob.edges.extend((a + base, b + base) for a, b in extra.edges)
        prob.dag_of = np.concatenate([prob.dag_of,
                                      extra.dag_of + len(prob.dag_names)])
        prob.dag_names.extend(extra.dag_names)
        prob.release = np.concatenate(
            [prob.release, np.maximum(extra.release, now)])
    return prob


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------


class Agora:
    def __init__(self, cluster: Cluster, goal: Goal = Goal.balanced(),
                 solver: str = "anneal",
                 anneal_cfg: Optional[AnnealConfig] = None,
                 vec_cfg: Optional[VecConfig] = None,
                 mesh=None, device=None):
        assert solver in ("anneal", "vectorized", "ising")
        self.device = resolve_device(device)
        self.cluster = cluster
        self.goal = goal
        self.solver = solver
        self.anneal_cfg = anneal_cfg or AnnealConfig()
        self.vec_cfg = vec_cfg or VecConfig()
        self.mesh = mesh
        # default sessions backing the legacy wrappers, keyed by
        # (shared_capacity, normalized bucket)
        self._sessions: Dict[Tuple, "PlannerSession"] = {}  # noqa: F821

    # -- the session front door ----------------------------------------

    def session(self, *, shared_capacity: bool = False, bucket_p=None,
                mesh="inherit", goal: Optional[Goal] = None,
                vec_cfg: Optional[VecConfig] = None,
                sink=None, device=None) -> "PlannerSession":  # noqa: F821
        """Open a compile-once / serve-many ``PlannerSession``.

        The session pins the static solve signature (engine, ``VecConfig``,
        mesh, bucket schedule) at construction: ``warmup()`` compiles each
        power-of-two bucket ahead of traffic, ``plan(requests)`` /
        ``replan(...)`` then serve with zero re-tracing inside a warmed
        bucket, and ``session.stats`` makes the contract observable.  See
        ``core/session.py`` and docs/api.md for the lifecycle.
        ``device=None`` serves on the Agora's device (``"cuda"`` unless
        the Agora was built for another one).
        """
        from repro_torch.core.session import _UNSET, PlannerSession
        return PlannerSession(
            self, shared_capacity=shared_capacity, bucket_p=bucket_p,
            mesh=_UNSET if isinstance(mesh, str) and mesh == "inherit"
            else mesh, goal=goal, vec_cfg=vec_cfg, sink=sink, device=device)

    def _default_session(self, shared_capacity: bool = False, bucket_p=None):
        key = (bool(shared_capacity),
               True if bucket_p is True
               else (int(bucket_p) if bucket_p else None))
        # sessions snapshot the Agora's knobs at construction; the legacy
        # wrappers read them per call, so a reconfigured Agora (new goal,
        # mesh, cfg, cluster) must rebuild its default session rather than
        # silently serve the stale pins
        pins = (self.cluster, self.goal, self.solver, self.anneal_cfg,
                self.vec_cfg, self.mesh, self.device)
        cached = self._sessions.get(key)
        if cached is None or any(a is not b for a, b in zip(cached[1], pins)):
            cached = (self.session(shared_capacity=shared_capacity,
                                   bucket_p=bucket_p), pins)
            self._sessions[key] = cached
        return cached[0]

    # -- legacy compatibility wrappers ----------------------------------

    def plan(self, dags: Sequence[DAG],
             ref: Optional[Tuple[float, float]] = None,
             goal: Optional[Goal] = None) -> Plan:
        """Co-schedule ``dags`` into ONE plan on a shared timeline.

        Compatibility wrapper over the default ``PlannerSession``
        (``session.plan_joint``); kept as the stable one-shot front door.
        For serve-many traffic (batches, streaming arrivals, warmed
        buckets) use ``Agora.session(...)`` — see docs/api.md.
        """
        return self._default_session().plan_joint(dags, ref=ref,
                                                  goal=goal).plan

    def plan_many(self, dags: Sequence[DAG],
                  refs: Optional[Sequence[Tuple[float, float]]] = None,
                  shared_capacity: bool = False,
                  goals: Optional[Sequence[Goal]] = None,
                  bucket_p=None) -> List[Plan]:
        """Plan P tenant DAGs in ONE batched device solve.

        .. deprecated::
            ``plan_many`` is a thin compatibility wrapper over a default
            ``PlannerSession`` and emits a ``DeprecationWarning``.  New
            code should open a session and serve typed requests::

                session = agora.session(shared_capacity=..., bucket_p=...)
                session.warmup(template_dag)        # compile ahead of traffic
                results = session.plan([PlanRequest(dag=d, goal=g), ...])

            The parallel ``refs``/``goals``/``bucket_p`` list kwargs map to
            ``PlanRequest`` fields and session pins — the full migration
            table lives in docs/api.md.  Plans returned here are bit-for-bit
            identical to the session path (differential-tested in
            tests/test_session.py).

        ``shared_capacity=False`` (default) isolates tenants (each draws
        from a private copy of the full cluster quota);
        ``shared_capacity=True`` couples the batch through one
        cluster-wide usage tensor and attaches ``joint_errors``.  A
        ``None`` entry inside ``refs`` means "recompute this tenant's
        reference point"; malformed entries and length mismatches raise
        ``ValueError`` naming the offending request index.
        """
        from repro_torch.core.session import (
            PlanRequest, PlannerDeprecationWarning, check_goals, check_refs)
        warnings.warn(
            "Agora.plan_many is a compatibility wrapper; use "
            "Agora.session(...).plan([PlanRequest(...), ...]) "
            "(see docs/api.md)", PlannerDeprecationWarning, stacklevel=2)
        dags = list(dags)
        if not dags:
            return []
        refs = check_refs(refs, len(dags))
        goals = check_goals(goals, len(dags))
        requests = [PlanRequest(dag=d,
                                goal=goals[i] if goals is not None else None,
                                ref=refs[i] if refs is not None else None)
                    for i, d in enumerate(dags)]
        sess = self._default_session(shared_capacity, bucket_p)
        return [r.plan for r in sess.plan(requests)]

    def replan(self, plan: Plan, *, now: float,
               done: Sequence[int] = (),
               running: Sequence[Tuple[int, float]] = (),
               new_dags: Sequence[DAG] = (),
               cluster: Optional[Cluster] = None,
               duration_scale: Optional[Dict[int, float]] = None) -> Plan:
        """Re-solve the remainder: completed tasks dropped, running tasks
        pinned as zero-duration predecessors-done, durations re-scaled for
        observed stragglers, optionally on a resized cluster (elastic).

        .. deprecated::
            Thin compatibility wrapper over ``PlannerSession.replan``
            (bit-for-bit identical, differential-tested); emits a
            ``DeprecationWarning``.  See docs/api.md.
        """
        from repro_torch.core.session import PlannerDeprecationWarning
        warnings.warn(
            "Agora.replan is a compatibility wrapper; use "
            "Agora.session(...).replan(...) (see docs/api.md)",
            PlannerDeprecationWarning, stacklevel=2)
        return self._default_session().replan(
            plan, now=now, done=done, running=running, new_dags=new_dags,
            cluster=cluster, duration_scale=duration_scale).plan


def combine_plans(plans: Sequence[Plan]) -> Plan:
    """Stitch per-tenant shared-capacity plans into ONE joint Plan on their
    common timeline (the form the flow executor dispatches against a single
    capacity pool). Solutions are concatenated verbatim — shared-capacity
    planning already placed them jointly, so no re-solve happens here."""
    plans = list(plans)
    assert plans, "need at least one plan"
    cluster = plans[0].cluster
    goal = plans[0].goal
    problem = concat_problems([p.problem for p in plans])
    oi = np.concatenate([p.solution.option_idx for p in plans])
    start = np.concatenate([p.solution.start for p in plans])
    finish = np.concatenate([p.solution.finish for p in plans])
    mk = float(finish.max() - problem.release.min()) if len(finish) else 0.0
    cost = float(sum(p.solution.cost for p in plans))
    ref_M = max(p.reference[0] for p in plans)
    ref_C = sum(p.reference[1] for p in plans)
    sol = Solution(oi, start, finish, mk, cost,
                   goal.energy(mk, cost, ref_M, ref_C),
                   solver=plans[0].solution.solver + "-joint")
    return Plan(problem, sol, goal, cluster, (ref_M, ref_C),
                joint_errors=plans[0].joint_errors)
