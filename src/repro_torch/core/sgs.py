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
from bisect import bisect_left, bisect_right, insort
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
    index). durations/demands may be passed pre-resolved (J,), (J,M).

    Demands must be non-negative: the placement below tests the capacity
    on every interval of a running usage profile, which for non-negative
    demands gives the same start as testing only the task's candidate
    start and the starts inside its window (the reference's rule)."""
    J = problem.num_tasks
    M = problem.num_resources
    if durations is None or demands is None:
        durations, demands = problem.chosen_options(option_idx)
    dem_arr = np.asarray(demands, float)
    if not (dem_arr >= 0).all():
        raise ValueError("sgs_schedule: demands must be non-negative")
    dur = np.asarray(durations, float).tolist()
    dem = dem_arr.tolist()
    lim = (np.full(M, np.inf) if caps is None
           else np.asarray(caps) + 1e-9).tolist()
    prio = [0.0] * J if priority is None else np.asarray(priority).tolist()
    release = np.asarray(problem.release, float).tolist()

    preds = [[] for _ in range(J)]
    succs = [[] for _ in range(J)]
    indeg = [0] * J
    for a, b in problem.edges:
        preds[b].append(a)
        succs[a].append(b)
        indeg[b] += 1

    start = [0.0] * J
    finish = [0.0] * J
    finishes: List[float] = []        # every placed task's finish, ascending
    # usage profile: usage[k] sums, in placement order, the demands of the
    # placed tasks covering [bps[k], bps[k + 1]); lists are replaced, never
    # changed in place, so a split may share its parent's
    bps = [-np.inf]
    usage = [[0.0] * len(lim)]
    ready = [(-prio[i], i) for i in range(J) if indeg[i] == 0]
    heapq.heapify(ready)

    n_done = 0
    while ready:
        _, i = heapq.heappop(ready)
        t0 = max([release[i]] + [finish[p] for p in preds[i]])
        d = dur[i]
        r = dem[i]
        busy = any(r)
        t = (_earliest_fit(bps, usage, finishes, t0, d, r, lim)
             if busy and finishes else t0)
        f = t + d
        start[i] = t
        finish[i] = f
        insort(finishes, f)
        if busy and f > t:
            _occupy(bps, usage, t, f, r)
        n_done += 1
        for j in succs[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(ready, (-prio[j], j))
    assert n_done == J, "DAG has a cycle"
    return np.asarray(start, float), np.asarray(finish, float)


def _earliest_fit(bps: List[float], usage: List[List[float]],
                  finishes: List[float], t0: float, d: float,
                  r: List[float], lim: List[float]) -> float:
    """Earliest start among t0 and the placed finishes after it (the
    candidates) at which usage + r <= lim on every profile interval that
    [t, t + d) overlaps (for d <= 0, the interval holding t); the last
    candidate where none fits.

    Walks the intervals forward once: a bad interval rules out every
    candidate before its end, so the candidate jumps to the first finish
    at or past that end."""
    n_bps, n_fin = len(bps), len(finishes)
    nxt = bisect_right(finishes, t0)
    t, end = t0, t0 + d
    k = bisect_right(bps, t0) - 1
    while True:
        for x, y, c in zip(usage[k], r, lim):
            if x + y > c:
                break
        else:
            k += 1
            if k == n_bps or bps[k] >= end:
                return t
            continue
        if k + 1 == n_bps:
            break
        nxt = bisect_left(finishes, bps[k + 1], nxt)
        if nxt == n_fin:
            break
        t = finishes[nxt]
        end = t + d
        k = bisect_right(bps, t, k + 1) - 1
    return max(t0, finishes[-1])


def _occupy(bps: List[float], usage: List[List[float]], s: float, f: float,
            r: List[float]) -> None:
    """Add demand r to the profile over [s, f), splitting at s and f."""
    i = bisect_left(bps, s)
    if i == len(bps) or bps[i] != s:
        bps.insert(i, s)
        usage.insert(i, usage[i - 1])
    j = bisect_left(bps, f, i)
    if j == len(bps) or bps[j] != f:
        bps.insert(j, f)
        usage.insert(j, usage[j - 1])
    for k in range(i, j):
        usage[k] = [u + x for u, x in zip(usage[k], r)]


def schedule_cost(problem: FlatProblem, option_idx: np.ndarray,
                  prices: np.ndarray,
                  durations: Optional[np.ndarray] = None,
                  demands: Optional[np.ndarray] = None) -> float:
    """Paper Eq. 6: sum_j sum_m r_jm * d_j * C_m (schedule-independent)."""
    if durations is None or demands is None:
        durations, demands = problem.chosen_options(option_idx)
    return float(np.sum(demands * durations[:, None] * prices[None, :]))


def validate_schedule(problem: FlatProblem, option_idx: np.ndarray,
                      start: np.ndarray, finish: np.ndarray,
                      caps: np.ndarray) -> List[str]:
    """Invariant checks used by tests and the flow executor."""
    if not _options_in_range(problem, option_idx):
        return ["option index out of range"]
    errs: List[str] = []
    durations, demands = problem.chosen_options(option_idx)
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


def _options_in_range(problem: FlatProblem, option_idx) -> bool:
    """Every index lies in [0, O), O the widest task's option count (an
    index past a narrower task's options takes its last)."""
    oi = np.asarray(option_idx)
    O = max(len(t.options) for t in problem.tasks)
    return bool(((oi >= 0) & (oi < O)).all())


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
    unresolved = False
    for p, (prob, oi, s, f) in enumerate(
            zip(problems, option_idxs, starts, finishes)):
        # per-tenant structural checks against an uncapacitated cluster:
        # the capacity invariant is joint, not per-tenant
        free = np.full(len(caps), np.inf)
        errs.extend(f"problem {p}: {e}"
                    for e in validate_schedule(prob, oi, s, f, free))
        if not _options_in_range(prob, oi):
            unresolved = True
            continue
        all_dem.append(prob.chosen_options(oi)[1])
        all_start.append(np.asarray(s, float))
        all_finish.append(np.asarray(f, float))
    if unresolved:
        return errs        # the joint usage needs every tenant's options
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
