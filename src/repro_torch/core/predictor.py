"""Runtime predictors (paper §2.1 / §4.4), the numpy parts.

* ``USLCurve`` — the universal scalability law (paper Eq. 9) used for the
  Alibaba macro benchmark: X(N) = γN / (1 + α(N−1) + βN(N−1)).
* ``profile_options`` — the in-house Predictor: takes one prior run ("event
  log") per task and emits the TaskOption grid over (instance type × count),
  i.e. the configuration axis the annealer explores.
* ``ernest_select`` — the separate-optimization baseline's per-task pick.

The Ernest NNLS fit (``ErnestPredictor``) and the dry-run roofline
predictor (``RooflinePredictor``) are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.catalog import Cluster
from repro_torch.core.dag import TaskOption


# ---------------------------------------------------------------------------
# USL (paper Eq. 9)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class USLCurve:
    alpha: float    # contention
    beta: float     # coherency
    gamma: float    # concurrency
    work: float     # total work units: runtime(N) = work / X(N)

    def throughput(self, n):
        n = np.asarray(n, np.float64)
        return self.gamma * n / (1.0 + self.alpha * (n - 1) + self.beta * n * (n - 1))

    def runtime(self, n):
        return self.work / np.maximum(self.throughput(n), 1e-9)

    @classmethod
    def fit_gamma(cls, alpha: float, beta: float, n0: float, runtime0: float,
                  work: float = 1.0) -> "USLCurve":
        """Calibrate γ so that runtime(n0) == runtime0 (one prior run),
        the macro-benchmark recipe of §5.5.1."""
        x_over_gamma = n0 / (1.0 + alpha * (n0 - 1) + beta * n0 * (n0 - 1))
        gamma = work / (runtime0 * x_over_gamma)
        return cls(alpha, beta, gamma, work)


# ---------------------------------------------------------------------------
# Task profiles -> configuration options
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskProfile:
    """What AGORA learns from one Spark event log (+ adaptive refinement):
    per instance type, a scaling curve of runtime vs instance count."""
    name: str
    curves: Dict[str, USLCurve]           # instance-type name -> curve
    mem_per_instance: float = 0.0         # optional second-resource demand

    def runtime(self, itype: str, n: int) -> float:
        return float(self.curves[itype].runtime(n))


def profile_options(profile: TaskProfile, cluster: Cluster,
                    counts: Sequence[int] = (1, 2, 4, 6, 8, 10, 12, 16),
                    default: Optional[str] = None) -> List[TaskOption]:
    """The Predictor output: the option grid over (type, count)."""
    opts: List[TaskOption] = []
    M = cluster.num_resources
    for m, itype in enumerate(cluster.types):
        if itype.name not in profile.curves:
            continue
        for n in counts:
            if n > cluster.capacities[m]:
                continue
            d = profile.runtime(itype.name, n)
            demands = [0.0] * M
            demands[m] = float(n)
            cost = d * n * itype.price_per_sec
            opts.append(TaskOption(f"{n} x {itype.name}", d, tuple(demands), cost))
    assert opts, f"no options for {profile.name}"
    return opts


def ernest_select(options: Sequence[TaskOption], goal: str) -> int:
    """Separate-optimization baseline: per-task best option (paper §3/§5.1).
    Goals: 'runtime' | 'cost' | 'balanced'."""
    d = np.asarray([o.duration for o in options])
    c = np.asarray([o.cost for o in options])
    if goal == "runtime":
        key = d + 1e-9 * c
    elif goal == "cost":
        key = c + 1e-9 * d
    else:
        key = 0.5 * d / d.min() + 0.5 * c / max(c.min(), 1e-12)
    return int(np.argmin(key))
