"""Paper-faithful AGORA solver (Algorithm 1).

Simulated annealing proposes per-task resource configurations; an inner
schedule solver (exact B&B when tractable — the CP-SAT stand-in — else
best-of-priority-rules serial SGS) computes the optimal schedule for the
proposal; Metropolis acceptance on the blended energy (Eq. 1). Constant
starting temperature T0 = 1 (the objective is a sum of percentage
improvements, §4.3), geometric cooling, O(n) iteration schedule.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.cluster.catalog import Cluster
from repro_torch.core.dag import FlatProblem
from repro_torch.core.exact import solve_exact
from repro_torch.core.objectives import Goal, Solution
from repro_torch.core.sgs import schedule_cost, sgs_schedule


@dataclasses.dataclass
class AnnealConfig:
    t0: float = 1.0                 # §4.3: constant start temperature
    cooling: float = 0.995
    iters_per_task: int = 60        # O(n) iteration budget
    min_iters: int = 1500
    max_iters: int = 6000
    exact_task_limit: int = 10      # inner exact solver above this -> SGS
    exact_node_budget: int = 60_000
    exact_time_budget: float = 1.0
    patience: int = 500             # stop after this many non-improving iters
    seed: int = 0
    tie_break: float = 1e-6         # prefer shorter makespan among equal energy


def _inner_solve(problem: FlatProblem, option_idx: np.ndarray, caps: np.ndarray,
                 cfg: AnnealConfig) -> Tuple[np.ndarray, np.ndarray, bool]:
    J = problem.num_tasks
    dur_all, dem_all, _, _ = problem.option_arrays()
    durations = dur_all[np.arange(J), option_idx]
    demands = dem_all[np.arange(J), option_idx]
    if J <= cfg.exact_task_limit:
        return solve_exact(problem, option_idx, caps,
                           node_budget=cfg.exact_node_budget,
                           time_budget=cfg.exact_time_budget)
    # large instance: best of several priority rules (active schedules)
    dag = problem.as_dag()
    tails = dag.critical_path_lengths(durations)
    rules = [tails,                              # critical path
             durations,                          # longest processing time
             -durations,                         # shortest processing time
             dag.downstream_counts().astype(float),
             demands.sum(axis=1) * durations]    # hardest to pack (Tetris-like)
    best = None
    for pr in rules:
        s, f = sgs_schedule(problem, option_idx, priority=pr, caps=caps,
                            durations=durations, demands=demands)
        mk = float(f.max())
        if best is None or mk < best[2]:
            best = (s, f, mk)
    return best[0], best[1], False


def reference_point(problem: FlatProblem, cluster: Cluster) -> Tuple[float, float]:
    """Original (M, C) of Eq. 1: default configurations under the default
    (Airflow-like) scheduler."""
    from repro_torch.core.baselines import airflow_plan
    sol = airflow_plan(problem, cluster)
    return sol.makespan, sol.cost


def anneal(problem: FlatProblem, cluster: Cluster, goal: Goal,
           cfg: Optional[AnnealConfig] = None,
           ref: Optional[Tuple[float, float]] = None,
           inner: Optional[Callable] = None) -> Solution:
    """Algorithm 1. Returns the best Solution found."""
    cfg = cfg or AnnealConfig()
    rng = np.random.default_rng(cfg.seed)
    t_start = time.monotonic()
    J = problem.num_tasks
    caps = cluster.caps
    prices = cluster.prices_per_sec
    dur_all, dem_all, cost_all, n_opts = problem.option_arrays()
    if ref is None:
        ref = reference_point(problem, cluster)
    ref_M, ref_C = ref
    inner = inner or (lambda p, oi: _inner_solve(p, oi, caps, cfg))

    def evaluate(option_idx):
        s, f, opt = inner(problem, option_idx)
        mk = float(f.max())
        cost = schedule_cost(problem, option_idx, prices)
        e = goal.energy(mk, cost, ref_M, ref_C)
        if math.isfinite(e):
            e += cfg.tie_break * mk / max(ref_M, 1e-12)
        return s, f, mk, cost, e, opt

    # start from the better of (prior-run config, Predictor per-task choice)
    from repro_torch.core.predictor import ernest_select
    goal_name = "runtime" if goal.w >= 0.75 else ("cost" if goal.w <= 0.25
                                                  else "balanced")
    starts = [np.asarray([t.default_option for t in problem.tasks], np.int64),
              np.asarray([ernest_select(t.options, goal_name)
                          for t in problem.tasks], np.int64)]
    best = None
    for cand0 in starts:
        s, f, mk, cost, e, opt = evaluate(cand0)
        if best is None or e < best.energy:
            best = Solution(cand0.copy(), s, f, mk, cost, e,
                            solver="agora-anneal", optimal_schedule=opt)
            cur, cur_e = cand0.copy(), e

    iters = int(np.clip(cfg.iters_per_task * J, cfg.min_iters, cfg.max_iters))
    T = cfg.t0
    since_improve = 0
    for it in range(iters):
        # neighbor: re-draw the configuration of 1 (occasionally 2) tasks;
        # 60% of moves are local in the option grid (adjacent count/type),
        # the rest uniform redraws — standard SA move-kernel mixing.
        cand = cur.copy()
        for _ in range(1 if rng.random() < 0.8 else 2):
            j = int(rng.integers(J))
            if rng.random() < 0.6:
                step_sz = int(rng.integers(1, 3)) * (1 if rng.random() < 0.5 else -1)
                cand[j] = int(np.clip(cand[j] + step_sz, 0, n_opts[j] - 1))
            else:
                cand[j] = int(rng.integers(n_opts[j]))
        s, f, mk, cost, e, opt = evaluate(cand)
        dE = e - cur_e
        if dE < 0:
            accept = True                       # F <- 1
        else:
            accept = math.exp(-dE / max(T, 1e-9)) > rng.random()
        if accept:
            cur, cur_e = cand, e
            if e < best.energy:
                best = Solution(cand.copy(), s, f, mk, cost, e,
                                solver="agora-anneal", optimal_schedule=opt)
                since_improve = 0
            else:
                since_improve += 1
        else:
            since_improve += 1
        if since_improve >= cfg.patience:
            break
        T *= cfg.cooling

    best.solve_seconds = time.monotonic() - t_start
    return best
