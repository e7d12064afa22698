"""Runtime predictors (paper §2.1 / §4.4), PyTorch port of the JAX
package's ``core/predictor.py``.

* ``ErnestPredictor`` — Ernest's feature model  t(n) = θ0 + θ1·(1/n) +
  θ2·log(n) + θ3·n  fit with non-negative least squares, by projected
  gradient descent in torch on the device the caller names (``"cuda"``
  unless the caller asks for the CPU).
* ``USLCurve`` — the universal scalability law (paper Eq. 9) used for the
  Alibaba macro benchmark: X(N) = γN / (1 + α(N−1) + βN(N−1)).
* ``profile_options`` — the in-house Predictor: takes one prior run ("event
  log") per task and emits the TaskOption grid over (instance type × count),
  i.e. the configuration axis the annealer explores.
* ``ernest_select`` — the separate-optimization baseline's per-task pick.
* ``RooflinePredictor`` — runtime(chip count) from a compiled dry-run's
  three roofline terms, with the H100's constants in place of the TPU's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.catalog import Cluster
from repro_torch.core.dag import TaskOption
from repro_torch.device import FLOAT, resolve_device
from repro_torch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS


# ---------------------------------------------------------------------------
# Ernest (NNLS via projected gradient)
# ---------------------------------------------------------------------------


def _ernest_features(n: torch.Tensor) -> torch.Tensor:
    n = n.to(FLOAT)
    return torch.stack([torch.ones_like(n), 1.0 / n, torch.log(n), n], dim=-1)


def _nnls_pg(X: torch.Tensor, y: torch.Tensor, iters: int = 2000
             ) -> torch.Tensor:
    """min ||XΘ - y||^2 s.t. Θ >= 0, by projected gradient with 1/L step,
    L the spectral norm of XᵀX (an SVD, as ``jnp.linalg.norm(ord=2)``)."""
    XtX = X.T @ X
    Xty = X.T @ y
    L = torch.linalg.matrix_norm(XtX, ord=2) + 1e-6
    theta = torch.clamp(Xty / (torch.diagonal(XtX) + 1e-6), min=0.0)
    for _ in range(iters):
        grad = XtX @ theta - Xty
        theta = torch.clamp(theta - grad / L, min=0.0)
    return theta


@dataclasses.dataclass
class ErnestPredictor:
    theta: np.ndarray  # (4,) float32

    @classmethod
    def fit(cls, node_counts: Sequence[float], runtimes: Sequence[float], *,
            device=None) -> "ErnestPredictor":
        """Fit θ on ``device`` (``"cuda"`` unless the caller names another);
        θ comes back to the host."""
        device = resolve_device(device)
        X = _ernest_features(torch.tensor(np.asarray(node_counts, np.float32),
                                          device=device))
        y = torch.tensor(np.asarray(runtimes, np.float32), device=device)
        return cls(theta=_nnls_pg(X, y).cpu().numpy())

    def predict(self, n) -> np.ndarray:
        X = _ernest_features(torch.tensor(np.asarray(n, np.float32)))
        return X.numpy() @ self.theta


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


# ---------------------------------------------------------------------------
# Roofline predictor, with the H100's constants
# ---------------------------------------------------------------------------

# One NVIDIA H100 SXM's peaks (repro_torch/roofline.py, their one home):
# NVLink in place of the TPU's ICI.


@dataclasses.dataclass(frozen=True)
class RooflineRecord:
    flops: float
    bytes_hbm: float
    bytes_collective: float
    chips: int

    def runtime(self, chips: Optional[int] = None) -> float:
        """max of the three terms; rescaling chip count keeps collective bytes
        per chip constant (conservative weak-scaling assumption)."""
        c = chips or self.chips
        t_compute = self.flops / (c * PEAK_FLOPS)
        t_mem = self.bytes_hbm / (c * HBM_BW)
        t_coll = (self.bytes_collective / self.chips) / NVLINK_BW
        return max(t_compute, t_mem, t_coll)


class RooflinePredictor:
    """Predict training-step runtime per (arch, mesh) from dry-run records,
    the accelerator's counterpart of a task's event log."""

    def __init__(self):
        self._records: Dict[str, RooflineRecord] = {}

    def add(self, key: str, rec: RooflineRecord):
        self._records[key] = rec

    def predict(self, key: str, chips: Optional[int] = None) -> float:
        return self._records[key].runtime(chips)

    def options_for(self, key: str, steps: int, cluster: Cluster,
                    chip_counts: Sequence[int] = (4, 8, 16, 64, 256)) -> List[TaskOption]:
        rec = self._records[key]
        opts = []
        M = cluster.num_resources
        for m, itype in enumerate(cluster.types):
            chips = itype.vcpus
            if chips not in chip_counts:
                continue
            d = rec.runtime(chips) * steps
            demands = [0.0] * M
            demands[m] = 1.0
            opts.append(TaskOption(f"1 x {itype.name}", d, tuple(demands),
                                   d * itype.price_per_sec))
        return opts
