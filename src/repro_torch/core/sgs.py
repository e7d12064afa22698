"""Serial schedule-generation scheme (list scheduler) — the workhorse schedule
decoder. Event-exact (no time grid): each task starts at the earliest time
>= max(pred finishes, release) at which its resource demands fit under the
capacity profile for its whole duration.

Classical result: over all precedence-feasible priority orders, serial SGS
generates the set of active schedules, which contains an optimal schedule for
regular objectives (min makespan). The exact solver (exact.py) searches that
order space; the annealers perturb priorities.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dag import FlatProblem


def sgs_schedule(problem: FlatProblem,
                 option_idx: np.ndarray,
                 priority: Optional[np.ndarray] = None,
                 caps: Optional[np.ndarray] = None,
                 durations: Optional[np.ndarray] = None,
                 demands: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (start, finish) arrays. priority: higher = earlier (ties by
    index). durations/demands may be passed pre-resolved (J,), (J,M)."""
    J = problem.num_tasks
    M = problem.num_resources
    if durations is None or demands is None:
        dur_all, dem_all, _, _ = problem.option_arrays()
        durations = dur_all[np.arange(J), option_idx]
        demands = dem_all[np.arange(J), option_idx]
    if caps is None:
        caps = np.full(M, np.inf)
    if priority is None:
        priority = np.zeros(J)

    preds = [[] for _ in range(J)]
    for a, b in problem.edges:
        preds[b].append(a)
    succs = [[] for _ in range(J)]
    indeg = np.zeros(J, np.int64)
    for a, b in problem.edges:
        succs[a].append(b)
        indeg[b] += 1

    start = np.zeros(J)
    finish = np.zeros(J)
    done = np.zeros(J, bool)
    # running tasks as event list of (time, +/- demand)
    events: List[Tuple[float, np.ndarray]] = []   # (finish_time, demand)
    ready = [(-priority[i], i) for i in range(J) if indeg[i] == 0]
    heapq.heapify(ready)
    scheduled_any = []

    def earliest_fit(t0: float, d: float, r: np.ndarray) -> float:
        """Earliest start >= t0 where usage + r <= caps throughout [t, t+d)."""
        if not events or not np.any(r):
            return t0
        evs = sorted(events, key=lambda e: e[0])
        # candidate starts: t0 and each running-task finish time > t0
        candidates = [t0] + [ft for ft, _ in evs if ft > t0]
        active = [(s, f, dm) for (s, f, dm) in scheduled_any if f > t0]
        for t in candidates:
            ok = True
            # check usage at every breakpoint within [t, t+d)
            points = [t] + [s for (s, f, dm) in active if t < s < t + d]
            for pt in points:
                usage = np.zeros(len(caps))
                for (s, f, dm) in active:
                    if s <= pt < f:
                        usage += dm
                if np.any(usage + r > caps + 1e-9):
                    ok = False
                    break
            if ok:
                return t
        return candidates[-1] if candidates else t0

    n_done = 0
    while ready:
        _, i = heapq.heappop(ready)
        t_ready = max([problem.release[i]] + [finish[p] for p in preds[i]])
        d = float(durations[i])
        r = np.asarray(demands[i], float)
        t = earliest_fit(t_ready, d, r)
        start[i] = t
        finish[i] = t + d
        events.append((t + d, r))
        scheduled_any.append((t, t + d, r))
        done[i] = True
        n_done += 1
        for j in succs[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(ready, (-priority[j], j))
    assert n_done == J, "DAG has a cycle"
    return start, finish


def schedule_cost(problem: FlatProblem, option_idx: np.ndarray,
                  prices: np.ndarray,
                  durations: Optional[np.ndarray] = None,
                  demands: Optional[np.ndarray] = None) -> float:
    """Paper Eq. 6: sum_j sum_m r_jm * d_j * C_m (schedule-independent)."""
    J = problem.num_tasks
    if durations is None or demands is None:
        dur_all, dem_all, _, _ = problem.option_arrays()
        durations = dur_all[np.arange(J), option_idx]
        demands = dem_all[np.arange(J), option_idx]
    return float(np.sum(demands * durations[:, None] * prices[None, :]))


def validate_schedule(problem: FlatProblem, option_idx: np.ndarray,
                      start: np.ndarray, finish: np.ndarray,
                      caps: np.ndarray) -> List[str]:
    """Invariant checks used by tests and the flow executor."""
    errs: List[str] = []
    dur_all, dem_all, _, _ = problem.option_arrays()
    J = problem.num_tasks
    durations = dur_all[np.arange(J), option_idx]
    demands = dem_all[np.arange(J), option_idx]
    if not np.allclose(finish - start, durations, atol=1e-6):
        errs.append("finish != start + duration")
    for a, b in problem.edges:
        if start[b] < finish[a] - 1e-9:
            errs.append(f"precedence violated: {a}->{b}")
    if np.any(start < problem.release - 1e-9):
        errs.append("release time violated")
    points = np.unique(np.concatenate([start, finish]))
    for pt in points:
        active = (start <= pt + 1e-12) & (pt + 1e-12 < finish)
        usage = demands[active].sum(axis=0) if active.any() else np.zeros(len(caps))
        if np.any(usage > caps + 1e-6):
            errs.append(f"capacity violated at t={pt}")
            break
    return errs


def validate_schedule_many(problems: Sequence[FlatProblem],
                           option_idxs: Sequence[np.ndarray],
                           starts: Sequence[np.ndarray],
                           finishes: Sequence[np.ndarray],
                           caps: np.ndarray) -> List[str]:
    """Joint-schedule invariants for shared-capacity co-scheduling: each
    tenant's schedule must satisfy its own precedence/duration/release
    constraints, and the SUM of all tenants' demands must stay within the
    global capacity vector at every event time of the joint timeline."""
    errs: List[str] = []
    all_start: List[np.ndarray] = []
    all_finish: List[np.ndarray] = []
    all_dem: List[np.ndarray] = []
    for p, (prob, oi, s, f) in enumerate(
            zip(problems, option_idxs, starts, finishes)):
        # per-tenant structural checks against an uncapacitated cluster:
        # the capacity invariant is joint, not per-tenant
        free = np.full(len(caps), np.inf)
        errs.extend(f"problem {p}: {e}"
                    for e in validate_schedule(prob, oi, s, f, free))
        _, dem_all, _, _ = prob.option_arrays()
        all_dem.append(dem_all[np.arange(prob.num_tasks), oi])
        all_start.append(np.asarray(s, float))
        all_finish.append(np.asarray(f, float))
    start = np.concatenate(all_start)
    finish = np.concatenate(all_finish)
    demands = np.concatenate(all_dem)
    points = np.unique(np.concatenate([start, finish]))
    for pt in points:
        active = (start <= pt + 1e-12) & (pt + 1e-12 < finish)
        usage = demands[active].sum(axis=0) if active.any() \
            else np.zeros(len(caps))
        if np.any(usage > caps + 1e-6):
            over = np.flatnonzero(usage > caps + 1e-6)
            errs.append(f"joint capacity violated at t={pt} "
                        f"(resources {over.tolist()})")
            break
    return errs
