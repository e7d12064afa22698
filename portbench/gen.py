"""Traffic generators and cluster recipes, frozen into the benchmark.

Frozen copies, so that a change to the program cannot change the yardstick:

* ``synth_trace_arrays``: the recipe of
  ``src/repro_torch/cluster/workloads.py:synth_trace`` (§5.5.1, Alibaba),
  its distributions drawn in bulk;
* ``JOB_PROFILES``, ``profile_options``, ``motivation``, ``dag1``, ``dag2``:
  ``src/repro_torch/cluster/workloads.py`` (the four Spark jobs of §3 and
  the Fig. 1 and Fig. 6 DAGs) and
  ``src/repro_torch/core/predictor.py:USLCurve`` / ``profile_options``;
* ``cluster_arrays``: ``src/repro_torch/cluster/catalog.py:alibaba_cluster``
  and ``paper_cluster``.

Everything here is plain NumPy and emits plain arrays. One DAG is a dict:

  ``dur`` (J, O) seconds, ``dem`` (J, O, M) demands, ``cost`` (J, O),
  ``n_opts`` (J,), ``default`` (J,) the default option, ``edges`` (E, 2)
  (pred, succ) pairs, ``labels`` (O,) option labels of each task (a list
  of lists), ``name``.

The same arrays build the program's ``DAG`` objects and the reference's
inputs. Every DAG is released at 0: a request is planned on its own
timeline from its dispatch, and arrivals are the traffic mix's business.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Clusters: (names, capacities, prices per hour)
# ---------------------------------------------------------------------------

# paper Table 1 (AWS m5 prices of 2022-01-27): name, vcpus, memory GB, $/h
AWS_M5 = (("m5.4xlarge", 16, 64, 0.768), ("m5.8xlarge", 32, 128, 1.536),
          ("m5.12xlarge", 48, 192, 2.304), ("m5.16xlarge", 64, 256, 3.072))


def cluster_arrays(spec: Dict) -> Dict:
    """The capacity vector of a configuration's cluster: ``names``,
    ``vcpus``, ``memory_gb``, ``caps`` (float64) and ``price_per_hour``."""
    kind = spec["kind"]
    if kind == "alibaba":
        machines, cores = spec["machines"], spec["cores_per_machine"]
        total_cores = int(machines * cores * spec["cpu_frac"])
        total_mem = int(machines * 100 * spec["mem_frac"])
        rows = (("cores", 1, 0, spec["core_price_per_hour"], total_cores),
                ("mem-pct", 0, 1, 0.0, total_mem))
    elif kind == "aws_m5":
        rows = tuple((n, v, m, p, spec["max_per_type"])
                     for n, v, m, p in AWS_M5)
    else:
        raise ValueError(f"unknown cluster kind {kind!r}")
    return dict(names=[r[0] for r in rows], vcpus=[r[1] for r in rows],
                memory_gb=[r[2] for r in rows],
                price_per_hour=np.asarray([r[3] for r in rows], np.float64),
                caps=np.asarray([r[4] for r in rows], np.float64))


def prices_per_sec(cluster: Dict) -> np.ndarray:
    return cluster["price_per_hour"] / 3600.0


# ---------------------------------------------------------------------------
# USL (paper Eq. 9)
# ---------------------------------------------------------------------------


def usl_runtime(alpha: float, beta: float, gamma: float, work: float, n):
    n = np.asarray(n, np.float64)
    x = gamma * n / (1.0 + alpha * (n - 1) + beta * n * (n - 1))
    return work / np.maximum(x, 1e-9)


def usl_fit_gamma(alpha: float, beta: float, n0: float, runtime0: float,
                  work: float = 1.0) -> float:
    """gamma such that runtime(n0) == runtime0 (one prior run)."""
    x_over_gamma = n0 / (1.0 + alpha * (n0 - 1) + beta * n0 * (n0 - 1))
    return work / (runtime0 * x_over_gamma)


# ---------------------------------------------------------------------------
# Alibaba-like trace (§5.5.1 recipe)
# ---------------------------------------------------------------------------

_CORE_OPTS = np.asarray([2, 4, 8, 16, 32, 64])
# the core counts of a trace task's one recorded run
_REF_CORES = np.asarray([4, 8, 16, 32])


def synth_trace_arrays(num_dags: int, cluster: Dict, seed: int,
                       tasks_lo: int = 6, tasks_hi: int = 14,
                       width: int = 4) -> List[Dict]:
    """Random layered DAGs (``tasks_lo`` to ``tasks_hi`` tasks split evenly
    over 3-5 layers, each task after the first layer fed by 1 to ``width``
    distinct tasks of the layer before), six core options a task, USL
    scaling with random alpha, beta and gamma fit to the trace's (cores,
    runtime) pair. The original's distributions, drawn in bulk: tens of
    thousands of DAGs take a second or two, and no DAG equals the
    original's DAG of the same seed."""
    rng = np.random.default_rng(seed)
    M = len(cluster["caps"])
    price = float(prices_per_sec(cluster)[0])
    labels = [f"{n} cores" for n in _CORE_OPTS]
    O = len(_CORE_OPTS)
    n_tasks = rng.integers(tasks_lo, tasks_hi + 1, num_dags)
    depth = rng.integers(3, 6, num_dags)
    T = int(n_tasks.sum())
    first = np.concatenate([[0], np.cumsum(n_tasks)[:-1]])
    dag = np.repeat(np.arange(num_dags), n_tasks)
    j = np.arange(T) - first[dag]
    # np.array_split's layers: the first J % depth of them one task longer
    q, r = (n_tasks // depth)[dag], (n_tasks % depth)[dag]
    layer = np.where(j < r * (q + 1), j // (q + 1),
                     r + (j - r * (q + 1)) // np.maximum(q, 1))
    prev = layer - 1
    prev_start = prev * q + np.minimum(prev, r)
    prev_len = q + (prev < r)

    n0 = _REF_CORES[rng.integers(0, len(_REF_CORES), T)].astype(np.float64)
    t0 = rng.lognormal(mean=4.2, sigma=0.9, size=T)
    mem0 = rng.uniform(0.5, 4.0, T)
    alpha = rng.uniform(0.0, 0.2, T)
    beta = rng.uniform(0.0, 0.01, T)
    gamma = usl_fit_gamma(alpha, beta, n0, t0, work=1.0)
    dur = usl_runtime(alpha[:, None], beta[:, None], gamma[:, None], 1.0,
                      _CORE_OPTS[None, :])
    dem = np.zeros((T, O, M))
    dem[:, :, 0] = _CORE_OPTS
    if M > 1:
        dem[:, :, 1] = mem0[:, None]
    default = np.argmin(np.abs(_CORE_OPTS[None, :] - n0[:, None]), axis=1)
    cost = dur * _CORE_OPTS[None, :] * price

    # each later task's predecessors: the first k of a random order of the
    # layer before
    wide = int(prev_len.max())
    fed = layer > 0
    k = rng.integers(1, np.minimum(width, prev_len) + 1)
    keys = np.where(np.arange(wide)[None, :] < prev_len[:, None],
                    rng.random((T, wide)), np.inf)
    order = np.argsort(keys, axis=1)
    take = fed[:, None] & (np.arange(wide)[None, :] < k[:, None])
    row, col = np.nonzero(take)
    e_pred = prev_start[row] + order[row, col]
    e_succ = j[row]
    e_first = np.searchsorted(dag[row], np.arange(num_dags + 1))

    out = []
    for di in range(num_dags):
        a, b = first[di], first[di] + n_tasks[di]
        e0, e1 = e_first[di], e_first[di + 1]
        out.append(dict(name=f"dag{di}", dur=dur[a:b], dem=dem[a:b],
                        cost=cost[a:b], n_opts=np.full(b - a, O, np.int64),
                        default=default[a:b].astype(np.int64),
                        edges=np.stack([e_pred[e0:e1], e_succ[e0:e1]],
                                       axis=1).astype(np.int64),
                        labels=[labels] * int(b - a)))
    return out


# ---------------------------------------------------------------------------
# The four Spark jobs of §3 and the paper's DAGs
# ---------------------------------------------------------------------------

_TYPE_SPEED = {"m5.4xlarge": 1.0, "m5.8xlarge": 1.9, "m5.12xlarge": 2.7,
               "m5.16xlarge": 3.4}


def _curves(work, alpha, beta, beta_4x=None):
    return {t: (alpha, beta_4x if (beta_4x is not None
                                   and t == "m5.4xlarge") else beta, sp, work)
            for t, sp in _TYPE_SPEED.items()}


# job -> instance type -> (alpha, beta, gamma, work)
JOB_PROFILES = {
    "index-analysis": _curves(work=3000.0, alpha=0.02, beta=0.0005),
    "sentiment-analysis": _curves(work=2400.0, alpha=0.08, beta=0.004,
                                  beta_4x=0.02),
    "airline-delay": _curves(work=1800.0, alpha=0.05, beta=0.001),
    "movie-recommendation": _curves(work=2100.0, alpha=0.10, beta=0.002),
}

_DEFAULT_COUNTS = (1, 2, 4, 6, 8, 9, 10, 12, 16)
_DEFAULT_LABEL = "16 x m5.4xlarge"


def profile_options(job: str, cluster: Dict,
                    counts: Sequence[int] = _DEFAULT_COUNTS):
    """(labels, durations, demands (O, M), costs) over (type x count)."""
    names, caps = cluster["names"], cluster["caps"]
    pph = cluster["price_per_hour"]
    M = len(names)
    labels, dur, dem, cost = [], [], [], []
    for m, itype in enumerate(names):
        curve = JOB_PROFILES[job].get(itype)
        if curve is None:
            continue
        for n in counts:
            if n > caps[m]:
                continue
            d = float(usl_runtime(*curve, n))
            row = [0.0] * M
            row[m] = float(n)
            labels.append(f"{n} x {itype}")
            dur.append(d)
            dem.append(row)
            cost.append(d * n * (pph[m] / 3600.0))
    return labels, np.asarray(dur), np.asarray(dem), np.asarray(cost)


def _paper_dag(name: str, jobs: Sequence[str], edges, cluster: Dict) -> Dict:
    per_job = {j: profile_options(j, cluster) for j in set(jobs)}
    O = max(len(per_job[j][0]) for j in jobs)
    M = len(cluster["names"])
    J = len(jobs)
    dur, dem, cost = np.zeros((J, O)), np.zeros((J, O, M)), np.zeros((J, O))
    n_opts = np.zeros(J, np.int64)
    default = np.zeros(J, np.int64)
    labels = []
    for t, job in enumerate(jobs):
        lab, d, r, c = per_job[job]
        n = len(lab)
        # option slots past a task's own repeat its last (the program's
        # padding convention); n_opts bounds the valid ones
        dur[t] = np.concatenate([d, np.repeat(d[-1:], O - n)])
        dem[t] = np.concatenate([r, np.repeat(r[-1:], O - n, axis=0)])
        cost[t] = np.concatenate([c, np.repeat(c[-1:], O - n)])
        n_opts[t] = n
        default[t] = lab.index(_DEFAULT_LABEL) if _DEFAULT_LABEL in lab else 0
        labels.append(lab)
    return dict(name=name, dur=dur, dem=dem, cost=cost, n_opts=n_opts,
                default=default, edges=np.asarray(edges, np.int64),
                labels=labels)


def motivation(cluster: Dict) -> Dict:
    """Fig. 1: pre-process, then three ML jobs."""
    return _paper_dag("motivation", ["index-analysis", "sentiment-analysis",
                                     "airline-delay", "movie-recommendation"],
                      [(0, 1), (0, 2), (0, 3)], cluster)


def dag1(cluster: Dict) -> Dict:
    """Fig. 6 DAG1: fan-out, a join, then dependent analyses."""
    jobs = ["index-analysis", "sentiment-analysis", "airline-delay",
            "movie-recommendation", "index-analysis", "airline-delay",
            "movie-recommendation"]
    edges = [(0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4), (4, 5), (4, 6)]
    return _paper_dag("DAG1", jobs, edges, cluster)


def dag2(cluster: Dict) -> Dict:
    """Fig. 6 DAG2: parallel chains converging in one final analysis."""
    jobs = ["sentiment-analysis", "airline-delay", "movie-recommendation",
            "airline-delay", "movie-recommendation", "sentiment-analysis",
            "index-analysis"]
    edges = [(0, 1), (1, 2), (3, 4), (2, 6), (4, 6), (5, 6)]
    return _paper_dag("DAG2", jobs, edges, cluster)


PAPER_DAGS = {"motivation": motivation, "dag1": dag1, "dag2": dag2}


def paper_dag_arrays(num_dags: int, cluster: Dict, seed: int,
                     mix: Dict[str, float]) -> List[Dict]:
    """``num_dags`` draws from the paper's DAGs, weighted by ``mix``."""
    kinds = sorted(mix)
    p = np.asarray([mix[k] for k in kinds], np.float64)
    templates = [PAPER_DAGS[k](cluster) for k in kinds]
    picks = np.random.default_rng(seed).choice(len(kinds), size=num_dags,
                                               p=p / p.sum())
    return [templates[i] for i in picks]


def dag_arrays(family: Dict, num_dags: int, cluster: Dict,
               seed: int) -> List[Dict]:
    """A configuration's DAG family: the same ``num_dags`` DAGs for every
    seed (drawn from the family's ``pool_seed``), in an order drawn from
    ``seed``, so that seeds change which DAGs meet in a batch and not the
    work."""
    kind, pool_seed = family["kind"], family["pool_seed"]
    if kind == "synth_trace":
        pool = synth_trace_arrays(num_dags, cluster, pool_seed,
                                  family["tasks_lo"], family["tasks_hi"],
                                  family["width"])
    elif kind == "paper_dags":
        pool = paper_dag_arrays(num_dags, cluster, pool_seed, family["mix"])
    else:
        raise ValueError(f"unknown DAG family {kind!r}")
    return [pool[i] for i in np.random.default_rng(seed).permutation(
        num_dags)]
