"""Baseline schedulers from the paper's evaluation (§5.1):

  * Airflow default      — topological priority (downstream count), FIFO
                           tie-break, default configurations.
  * Ernest + CP          — per-task best config (separate), critical-path SGS.
  * Ernest + MILP        — per-task best config, exact (optimization-based)
                           schedule: our B&B stands in for the MILP solver.
  * Stratus              — cost-first per-task VM selection + runtime-class
                           binned packing (cost-aware container scheduling).
  * AGORA-separate       — AGORA's predictor and scheduler run sequentially
                           without co-optimization (Fig. 8 ablation).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.cluster.catalog import Cluster
from repro_torch.core.dag import FlatProblem
from repro_torch.core.exact import solve_exact
from repro_torch.core.objectives import Goal, Solution
from repro_torch.core.predictor import ernest_select
from repro_torch.core.sgs import schedule_cost, sgs_schedule


def _finish(problem, option_idx, start, finish, cluster, solver, t0,
            optimal=False) -> Solution:
    cost = schedule_cost(problem, option_idx, cluster.prices_per_sec)
    return Solution(option_idx, start, finish, float(finish.max()), cost,
                    solver=solver, solve_seconds=time.monotonic() - t0,
                    optimal_schedule=optimal)


def airflow_plan(problem: FlatProblem, cluster: Cluster) -> Solution:
    """Default Airflow: priority weight = number of downstream tasks,
    FIFO among equal priorities, default configs."""
    t0 = time.monotonic()
    option_idx = np.asarray([t.default_option for t in problem.tasks], np.int64)
    pr = problem.as_dag().downstream_counts().astype(float)
    start, finish = sgs_schedule(problem, option_idx, priority=pr,
                                 caps=cluster.caps)
    return _finish(problem, option_idx, start, finish, cluster, "airflow", t0)


def _ernest_configs(problem: FlatProblem, goal_name: str) -> np.ndarray:
    return np.asarray([ernest_select(t.options, goal_name) for t in problem.tasks],
                      np.int64)


def cp_ernest_plan(problem: FlatProblem, cluster: Cluster, goal_name: str) -> Solution:
    """Separate optimization: Ernest VM selection then critical-path SGS."""
    t0 = time.monotonic()
    option_idx = _ernest_configs(problem, goal_name)
    dur_all, dem_all, _, _ = problem.option_arrays()
    J = problem.num_tasks
    durations = dur_all[np.arange(J), option_idx]
    tails = problem.as_dag().critical_path_lengths(durations)
    start, finish = sgs_schedule(problem, option_idx, priority=tails,
                                 caps=cluster.caps)
    return _finish(problem, option_idx, start, finish, cluster, "cp+ernest", t0)


def milp_ernest_plan(problem: FlatProblem, cluster: Cluster, goal_name: str,
                     node_budget: int = 100_000) -> Solution:
    """Separate optimization with an optimization-based scheduler (TetriSched
    style): exact B&B minimizes makespan for the Ernest-chosen configs."""
    t0 = time.monotonic()
    option_idx = _ernest_configs(problem, goal_name)
    start, finish, opt = solve_exact(problem, option_idx, cluster.caps,
                                     node_budget=node_budget)
    return _finish(problem, option_idx, start, finish, cluster, "milp+ernest",
                   t0, optimal=opt)


def stratus_plan(problem: FlatProblem, cluster: Cluster) -> Solution:
    """Stratus: cost-aware but resource-greedy — it grabs whatever resources
    are available (the paper observes lowest runtime yet higher cost than
    AGORA) and packs tasks into runtime classes (power-of-two binning) so
    similarly-sized tasks share instances; not DAG-aware beyond dependency
    feasibility."""
    t0 = time.monotonic()
    option_idx = _ernest_configs(problem, "runtime")
    dur_all, dem_all, _, _ = problem.option_arrays()
    J = problem.num_tasks
    durations = dur_all[np.arange(J), option_idx]
    # runtime-class priority: tasks in the same 2^k duration bin group together
    bins = np.floor(np.log2(np.maximum(durations, 1e-6)))
    priority = -bins * 1000.0 - np.argsort(np.argsort(durations))
    start, finish = sgs_schedule(problem, option_idx, priority=priority,
                                 caps=cluster.caps)
    return _finish(problem, option_idx, start, finish, cluster, "stratus", t0)


def agora_separate_plan(problem: FlatProblem, cluster: Cluster, goal: Goal) -> Solution:
    """Fig. 8 ablation: AGORA Predictor and Scheduler applied sequentially.
    Configs chosen per-task for the goal (no schedule feedback), then the
    schedule annealed/solved for those fixed configs."""
    t0 = time.monotonic()
    goal_name = "runtime" if goal.w >= 0.75 else ("cost" if goal.w <= 0.25 else "balanced")
    option_idx = _ernest_configs(problem, goal_name)
    start, finish, opt = solve_exact(problem, option_idx, cluster.caps,
                                     node_budget=60_000, time_budget=2.0)
    return _finish(problem, option_idx, start, finish, cluster,
                   "agora-separate", t0, optimal=opt)


def predictor_only_plan(problem: FlatProblem, cluster: Cluster, goal: Goal) -> Solution:
    """Fig. 8: Predictor without Scheduler — per-task configs for the goal,
    default Airflow ordering."""
    t0 = time.monotonic()
    goal_name = "runtime" if goal.w >= 0.75 else ("cost" if goal.w <= 0.25 else "balanced")
    option_idx = _ernest_configs(problem, goal_name)
    pr = problem.as_dag().downstream_counts().astype(float)
    start, finish = sgs_schedule(problem, option_idx, priority=pr, caps=cluster.caps)
    return _finish(problem, option_idx, start, finish, cluster, "predictor-only", t0)


def scheduler_only_plan(problem: FlatProblem, cluster: Cluster) -> Solution:
    """Fig. 8: Scheduler without Predictor — default configs, optimized
    schedule."""
    t0 = time.monotonic()
    option_idx = np.asarray([t.default_option for t in problem.tasks], np.int64)
    start, finish, opt = solve_exact(problem, option_idx, cluster.caps,
                                     node_budget=60_000, time_budget=2.0)
    return _finish(problem, option_idx, start, finish, cluster,
                   "scheduler-only", t0, optimal=opt)


def brute_force_plan(problem: FlatProblem, cluster: Cluster, goal: Goal,
                     ref: Tuple[float, float]) -> Solution:
    """BF co-optimize (§3): exhaustive search over the full configuration
    cross-product, exact schedule for each. Exponential — motivation only."""
    t0 = time.monotonic()
    _, _, _, n_opts = problem.option_arrays()
    J = problem.num_tasks
    best: Optional[Solution] = None
    idx = np.zeros(J, np.int64)

    def rec(j):
        nonlocal best
        if j == J:
            start, finish, opt = solve_exact(problem, idx, cluster.caps,
                                             node_budget=20_000, time_budget=0.5)
            cost = schedule_cost(problem, idx, cluster.prices_per_sec)
            e = goal.energy(float(finish.max()), cost, *ref)
            if best is None or e < best.energy:
                best = Solution(idx.copy(), start, finish, float(finish.max()),
                                cost, e, solver="bf-cooptimize", optimal_schedule=opt)
            return
        for o in range(n_opts[j]):
            idx[j] = o
            rec(j + 1)

    rec(0)
    best.solve_seconds = time.monotonic() - t0
    return best
