"""Optimization goal (paper Eq. 1, 7, 8) plus SLA deadline classes.

energy = w * (M_opt - M)/M + (1 - w) * (C_opt - C)/C
with user budgets on makespan and cost (infinity when unset).

SLA extension (streaming control plane): a goal may carry a *soft deadline*
— a hinge penalty ``deadline_weight * max(0, M - deadline) / deadline`` is
added to the energy, so deadline-constrained (guaranteed-class) tenants bid
harder for capacity the further their makespan drifts past the deadline.
The default (``deadline=inf``, ``deadline_weight=0``) adds exactly 0.0 and
preserves the PR-2 energies bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Goal:
    w: float = 0.5                      # makespan weight (1=runtime, 0=cost)
    makespan_budget: float = math.inf   # Eq. 7
    cost_budget: float = math.inf       # Eq. 8
    deadline: float = math.inf          # SLA soft deadline on makespan (s)
    deadline_weight: float = 0.0        # hinge-penalty scale (0 = no SLA term)

    @classmethod
    def runtime(cls) -> "Goal":
        return cls(w=1.0)

    @classmethod
    def cost(cls) -> "Goal":
        return cls(w=0.0)

    @classmethod
    def balanced(cls) -> "Goal":
        return cls(w=0.5)

    @classmethod
    def with_deadline(cls, deadline: float, w: float = 0.5,
                      weight: float = 8.0) -> "Goal":
        """Deadline-class goal: the solver pays ``weight`` per unit of
        relative deadline overshoot on top of the blended Eq. 1 energy."""
        return cls(w=w, deadline=deadline, deadline_weight=weight)

    def deadline_penalty(self, makespan: float) -> float:
        """Hinge penalty of the SLA term; exactly 0.0 when no deadline."""
        if self.deadline_weight <= 0 or not math.isfinite(self.deadline):
            return 0.0
        return (self.deadline_weight * max(0.0, makespan - self.deadline)
                / max(self.deadline, 1e-12))

    def energy(self, makespan: float, cost: float,
               ref_makespan: float, ref_cost: float) -> float:
        e = (self.w * (makespan - ref_makespan) / max(ref_makespan, 1e-12)
             + (1.0 - self.w) * (cost - ref_cost) / max(ref_cost, 1e-12))
        e += self.deadline_penalty(makespan)
        if makespan > self.makespan_budget or cost > self.cost_budget:
            return math.inf
        return e


@dataclasses.dataclass
class Solution:
    """A concrete plan: configuration choice + start times for every task."""
    option_idx: "np.ndarray"     # (J,) chosen option per task
    start: "np.ndarray"          # (J,)
    finish: "np.ndarray"         # (J,)
    makespan: float
    cost: float
    energy: float = math.nan
    solver: str = ""
    solve_seconds: float = 0.0
    optimal_schedule: bool = False   # inner schedule proven optimal for configs


import numpy as np  # noqa: E402  (for annotations above)
