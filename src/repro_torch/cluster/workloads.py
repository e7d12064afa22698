"""The paper's evaluation workloads.

Four Spark jobs (§3): Index Analysis (pre-processing), Sentiment Analysis,
Airline Delay, Movie Recommendation — each with a scaling profile per m5
instance type calibrated to reproduce the qualitative behaviour of Fig. 2
(diminishing returns everywhere; Sentiment Analysis goes *negative-scaling*
on large m5.4xlarge counts). DAG1/DAG2 reproduce the Fig. 6 shapes, and the
Alibaba-like trace generator implements the §5.5.1 recipe (USL with random
α, β; γ fit to one prior run).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.catalog import Cluster, paper_cluster
from repro_torch.core.dag import DAG, Task, TaskOption
from repro_torch.core.predictor import TaskProfile, USLCurve, profile_options

# ---------------------------------------------------------------------------
# The four jobs of §3, per-type USL curves.
# work is in abstract units; runtime(n) = work / X(n). Larger instances get a
# per-node speed factor folded into gamma.
# ---------------------------------------------------------------------------

_TYPE_SPEED = {"m5.4xlarge": 1.0, "m5.8xlarge": 1.9, "m5.12xlarge": 2.7,
               "m5.16xlarge": 3.4}


def _curves(work: float, alpha: float, beta: float,
            beta_4x: Optional[float] = None) -> Dict[str, USLCurve]:
    out = {}
    for t, sp in _TYPE_SPEED.items():
        b = beta_4x if (beta_4x is not None and t == "m5.4xlarge") else beta
        out[t] = USLCurve(alpha=alpha, beta=b, gamma=sp, work=work)
    return out


JOB_PROFILES: Dict[str, TaskProfile] = {
    # heavy scan job, parallelizes well
    "index-analysis": TaskProfile("index-analysis",
                                  _curves(work=3000.0, alpha=0.02, beta=0.0005)),
    # NLP job with coherency penalty: negative scaling on many small nodes
    "sentiment-analysis": TaskProfile("sentiment-analysis",
                                      _curves(work=2400.0, alpha=0.08,
                                              beta=0.004, beta_4x=0.02)),
    "airline-delay": TaskProfile("airline-delay",
                                 _curves(work=1800.0, alpha=0.05, beta=0.001)),
    "movie-recommendation": TaskProfile("movie-recommendation",
                                        _curves(work=2100.0, alpha=0.10,
                                                beta=0.002)),
}

_DEFAULT_COUNTS = (1, 2, 4, 6, 8, 9, 10, 12, 16)


def make_task(job: str, cluster: Cluster, name: Optional[str] = None,
              counts: Sequence[int] = _DEFAULT_COUNTS,
              default_label: str = "16 x m5.4xlarge") -> Task:
    """Default option mirrors the paper's expert-tuned, performance-oriented
    Spark configurations (§5: 'carefully choose the Spark configurations for
    each job to achieve best performance')."""
    opts = profile_options(JOB_PROFILES[job], cluster, counts=counts)
    default = next((i for i, o in enumerate(opts) if o.label == default_label), 0)
    return Task(name or job, opts, default_option=default)


# ---------------------------------------------------------------------------
# Fig. 1 example DAG (motivation): preprocess -> 3 ML jobs
# ---------------------------------------------------------------------------


def motivation_dag(cluster: Optional[Cluster] = None) -> DAG:
    cluster = cluster or paper_cluster()
    jobs = ["index-analysis", "sentiment-analysis", "airline-delay",
            "movie-recommendation"]
    tasks = [make_task(j, cluster) for j in jobs]
    return DAG("motivation", tasks, edges=[(0, 1), (0, 2), (0, 3)])


# ---------------------------------------------------------------------------
# Fig. 6 evaluation DAGs
# ---------------------------------------------------------------------------


def dag1(cluster: Optional[Cluster] = None) -> DAG:
    """Pre-process, fan-out to ML jobs that build on each other, bottleneck
    join, then dependent analyses (low parallelism, single-task chokepoints)."""
    cluster = cluster or paper_cluster()
    jobs = ["index-analysis",            # 0: preprocess (top chokepoint)
            "sentiment-analysis",        # 1
            "airline-delay",             # 2
            "movie-recommendation",      # 3
            "index-analysis",            # 4: combine (2nd-to-last chokepoint)
            "airline-delay",             # 5
            "movie-recommendation"]      # 6
    tasks = [make_task(j, cluster, name=f"t{i}-{j}") for i, j in enumerate(jobs)]
    edges = [(0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4), (4, 5), (4, 6)]
    return DAG("DAG1", tasks, edges)


def dag2(cluster: Optional[Cluster] = None) -> DAG:
    """Parallel ML chains converging in one final analysis (high parallelism,
    single final bottleneck)."""
    cluster = cluster or paper_cluster()
    jobs = ["sentiment-analysis",        # 0
            "airline-delay",             # 1 (0->1)
            "movie-recommendation",      # 2 (1->2)
            "airline-delay",             # 3
            "movie-recommendation",      # 4 (3->4)
            "sentiment-analysis",        # 5
            "index-analysis"]            # 6: final combine
    tasks = [make_task(j, cluster, name=f"t{i}-{j}") for i, j in enumerate(jobs)]
    edges = [(0, 1), (1, 2), (3, 4), (2, 6), (4, 6), (5, 6)]
    return DAG("DAG2", tasks, edges)


# ---------------------------------------------------------------------------
# Alibaba-like trace (§5.5.1 recipe)
# ---------------------------------------------------------------------------


def synth_trace(num_dags: int, cluster: Cluster, seed: int = 0,
                tasks_lo: int = 6, tasks_hi: int = 14,
                width: int = 4,
                submit_rate: float = 1.0 / 120.0) -> List[DAG]:
    """Random layered DAGs (width<=4, depth 3-5, ~10 tasks — §5.4 generator),
    Poisson submissions, USL scaling with random alpha/beta per task and gamma
    fit to the trace-provided (cores, runtime) pair."""
    rng = np.random.default_rng(seed)
    M = cluster.num_resources
    dags: List[DAG] = []
    t_submit = 0.0
    core_opts = np.asarray([2, 4, 8, 16, 32, 64])
    for di in range(num_dags):
        J = int(rng.integers(tasks_lo, tasks_hi + 1))
        depth = int(rng.integers(3, 6))
        layers = np.array_split(np.arange(J), depth)
        layers = [l for l in layers if len(l)]
        tasks: List[Task] = []
        for j in range(J):
            # trace record: requested cores, runtime, memory
            n0 = float(rng.choice([4, 8, 16, 32]))
            t0 = float(rng.lognormal(mean=4.2, sigma=0.9))  # ~60s median
            mem0 = float(rng.uniform(0.5, 4.0))             # machine-% units
            alpha = float(rng.uniform(0.0, 0.2))
            beta = float(rng.uniform(0.0, 0.01))
            curve = USLCurve.fit_gamma(alpha, beta, n0, t0, work=1.0)
            opts = []
            for n in core_opts:
                d = float(curve.runtime(n))
                demands = [0.0] * M
                demands[0] = float(n)
                if M > 1:
                    demands[1] = mem0
                cost = d * n * cluster.types[0].price_per_sec
                opts.append(TaskOption(f"{n} cores", d, tuple(demands), cost))
            default = int(np.argmin(np.abs(core_opts - n0)))
            tasks.append(Task(f"d{di}-t{j}", opts, default_option=default))
        edges = []
        for li in range(1, len(layers)):
            for j in layers[li]:
                k = int(rng.integers(1, min(width, len(layers[li - 1])) + 1))
                preds = rng.choice(layers[li - 1], size=k, replace=False)
                edges.extend((int(p), int(j)) for p in preds)
        t_submit += float(rng.exponential(1.0 / submit_rate))
        dags.append(DAG(f"dag{di}", tasks, edges, release_time=t_submit))
    return dags
