"""The plain reference: checks every plan the program returns and computes
the default Airflow plan the gain is taken against.

Plain NumPy over the arrays of ``gen.py``. It imports nothing of the
program and takes nothing the program made: the program's outputs (each
task's option, start and finish, the reported makespan and cost) are what
it judges, and it recomputes everything else from the benchmark's arrays.

The guarantees a plan is held to (the configuration files state them):

* each task runs one of its options, for that option's duration;
* no task starts before its release (0) or before a predecessor finishes;
* at every instant the demands of the running tasks fit under the
  cluster's capacities, jointly over every plan of a shared batch;
* the reported makespan and cost are those of the schedule;
* each result answers its own request.

``plan_err`` folds the first four into one number: the largest relative
departure over every task, edge, instant and reported number. A sound
plan computed in float64 reads at rounding (about 1e-16 of the times
involved); one computed in float32 reads about 1e-7 (see ``control.py``).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

# capacity slack of the serial SGS (the same as the program's list
# scheduler): demands are whole numbers of cores or instances
_CAP_TOL = 1e-9


# ---------------------------------------------------------------------------
# Serial SGS on an event-exact usage profile
# ---------------------------------------------------------------------------


def downstream_counts(J: int, edges: np.ndarray) -> np.ndarray:
    """Airflow's priority weight: the number of transitive descendants."""
    succ = [[] for _ in range(J)]
    indeg = np.zeros(J, np.int64)
    for a, b in edges:
        succ[a].append(int(b))
        indeg[b] += 1
    order, ready = [], [j for j in range(J) if indeg[j] == 0]
    while ready:
        j = ready.pop(0)
        order.append(j)
        for k in succ[j]:
            indeg[k] -= 1
            if indeg[k] == 0:
                ready.append(k)
    if len(order) != J:
        raise ValueError("cycle in DAG")
    desc = [set() for _ in range(J)]
    for j in reversed(order):
        for k in succ[j]:
            desc[j].add(k)
            desc[j] |= desc[k]
    return np.asarray([len(d) for d in desc], np.float64)


def serial_sgs(dur: np.ndarray, dem: np.ndarray, edges: np.ndarray,
               priority: np.ndarray, caps: np.ndarray,
               dtype=np.float64):
    """(start, finish) of the serial schedule-generation scheme: among the
    ready tasks the highest priority goes first (ties by index) and starts
    at the earliest instant, no earlier than its predecessors' finishes,
    at which its demands fit under ``caps`` for its whole duration.
    ``dur`` (J,), ``dem`` (J, M). Times are held in ``dtype``."""
    J, M = dem.shape
    dur = np.asarray(dur, dtype)
    preds = [[] for _ in range(J)]
    succ = [[] for _ in range(J)]
    indeg = np.zeros(J, np.int64)
    for a, b in edges:
        preds[b].append(int(a))
        succ[a].append(int(b))
        indeg[b] += 1
    start = np.zeros(J, dtype)
    finish = np.zeros(J, dtype)
    # usage profile: usage[k] holds on [times[k], times[k + 1])
    times = np.zeros(1, dtype)
    usage = np.zeros((1, M))
    ready = [(-float(priority[j]), j) for j in range(J) if indeg[j] == 0]
    heapq.heapify(ready)
    n = 0
    while ready:
        _, j = heapq.heappop(ready)
        t0 = max([dtype(0)] + [finish[p] for p in preds[j]])
        d, r = dur[j], dem[j]
        t = t0
        if np.any(r):
            ok = np.all(usage + r[None, :] <= caps[None, :] + _CAP_TOL,
                        axis=1)
            bad = np.concatenate([[0], np.cumsum(~ok)])
            cand = np.concatenate([[t0], times[times > t0]]).astype(dtype)
            lo = np.searchsorted(times, cand, "right") - 1
            hi = np.searchsorted(times, (cand + d).astype(dtype), "left")
            fits = bad[hi] - bad[lo] == 0
            t = cand[int(np.argmax(fits))]
        f = dtype(t + d)
        start[j], finish[j] = t, f
        if np.any(r) and f > t:
            for x in (t, f):
                k = np.searchsorted(times, x, "right") - 1
                if times[k] != x:
                    times = np.insert(times, k + 1, x)
                    usage = np.insert(usage, k + 1, usage[k], axis=0)
            a = np.searchsorted(times, t, "left")
            b = np.searchsorted(times, f, "left")
            usage[a:b] += r
        n += 1
        for k in succ[j]:
            indeg[k] -= 1
            if indeg[k] == 0:
                heapq.heappush(ready, (-float(priority[k]), k))
    if n != J:
        raise ValueError("cycle in DAG")
    return start, finish


def airflow_group(dags: Sequence[Dict], caps: np.ndarray, dtype=np.float64):
    """The default Airflow plan of DAGs that share one cluster (one DAG for
    an isolated pool, a batch for a shared one): default options,
    downstream-count priority, FIFO among equals in the order given.
    Returns one dict (option_idx, start, finish) per DAG."""
    durs, dems, edges, prios, sizes = [], [], [], [], []
    off = 0
    for g in dags:
        J = len(g["default"])
        idx = np.arange(J)
        durs.append(g["dur"][idx, g["default"]])
        dems.append(g["dem"][idx, g["default"]])
        edges.append(np.asarray(g["edges"], np.int64).reshape(-1, 2) + off)
        prios.append(downstream_counts(J, g["edges"]))
        sizes.append(J)
        off += J
    start, finish = serial_sgs(np.concatenate(durs), np.concatenate(dems),
                               np.concatenate(edges), np.concatenate(prios),
                               caps, dtype)
    out, off = [], 0
    for g, J in zip(dags, sizes):
        out.append(dict(option_idx=np.asarray(g["default"], np.int64),
                        start=start[off:off + J], finish=finish[off:off + J]))
        off += J
    return out


# ---------------------------------------------------------------------------
# Plan checks
# ---------------------------------------------------------------------------


def plan_cost(g: Dict, option_idx: np.ndarray, prices: np.ndarray) -> float:
    """Paper Eq. 6: sum over tasks and resources of demand x duration x
    price."""
    idx = np.arange(len(option_idx))
    d = g["dur"][idx, option_idx]
    r = g["dem"][idx, option_idx]
    return float(np.sum(r * d[:, None] * prices[None, :]))


def _rel(a, b) -> float:
    return float(abs(a - b) / max(abs(b), 1e-300))


def check_group(dags: Sequence[Dict], plans: Sequence[Dict],
                caps: np.ndarray, prices: np.ndarray) -> Dict:
    """Check the plans of DAGs that share one cluster. Returns
    ``err`` (the largest relative departure, ``inf`` where a plan cannot
    be read against its DAG), ``mismatched`` (plans that do not fit their
    DAG's shape or options) and ``why`` (what the worst reading was)."""
    err, why, mismatched = 0.0, "", 0

    def note(e, what):
        nonlocal err, why
        if e > err:
            err, why = e, what

    spans = []
    for i, (g, p) in enumerate(zip(dags, plans)):
        J = len(g["default"])
        oi = np.asarray(p["option_idx"])
        s = np.asarray(p["start"], np.float64)
        f = np.asarray(p["finish"], np.float64)
        if (oi.shape != (J,) or s.shape != (J,) or f.shape != (J,)
                or np.any(oi < 0) or np.any(oi >= g["n_opts"])):
            mismatched += 1
            note(np.inf, f"plan {i}: shape or option out of range")
            continue
        idx = np.arange(J)
        d = g["dur"][idx, oi]
        note(float(np.max(np.abs((f - s) - d) / d)), f"plan {i}: duration")
        note(float(np.max(np.maximum(0.0, -s) / d)), f"plan {i}: release")
        for a, b in np.asarray(g["edges"]).reshape(-1, 2):
            note(max(0.0, f[a] - s[b]) / d[a], f"plan {i}: edge {a}->{b}")
        note(_rel(p["makespan"], float(f.max())), f"plan {i}: makespan")
        note(_rel(p["cost"], plan_cost(g, oi, prices)), f"plan {i}: cost")
        spans.append((s, f, g["dem"][idx, oi]))
    if spans:
        s = np.concatenate([x[0] for x in spans])
        f = np.concatenate([x[1] for x in spans])
        r = np.concatenate([x[2] for x in spans])
        # usage at every start instant, over the tasks running there
        live = (s[None, :] <= s[:, None]) & (s[:, None] < f[None, :])
        use = live.astype(np.float64) @ r
        over = np.max(np.maximum(0.0, use - caps[None, :])
                      / np.maximum(caps[None, :], 1e-300))
        note(float(over), "capacity")
    return dict(err=err, mismatched=mismatched, why=why)


def energy(w: float, makespan: float, cost: float, ref_makespan: float,
           ref_cost: float) -> float:
    """Paper Eq. 1 against a reference point (lower is better)."""
    return (w * (makespan - ref_makespan) / ref_makespan
            + (1.0 - w) * (cost - ref_cost) / ref_cost)


def gains(dags: Sequence[Dict], plans: Sequence[Dict], caps: np.ndarray,
          prices: np.ndarray, w: float, defaults=None) -> List[float]:
    """Minus the Eq. 1 energy of each plan against the default Airflow plan
    of the same DAGs on the same cluster (``defaults``, computed here when
    not given), both makespan and cost recomputed here from the plans'
    options and starts."""
    defaults = defaults or airflow_group(dags, caps)
    out = []
    for g, p, d in zip(dags, plans, defaults):
        oi = np.asarray(p["option_idx"], np.int64)
        idx = np.arange(len(oi))
        mk = float(np.max(np.asarray(p["start"], np.float64)
                          + g["dur"][idx, oi]))
        out.append(-energy(w, mk, plan_cost(g, oi, prices),
                           float(d["finish"].max()),
                           plan_cost(g, d["option_idx"], prices)))
    return out


def judge(dags: Sequence[Dict], plans: Sequence[Optional[Dict]],
          groups: Sequence[Sequence[int]], caps: np.ndarray,
          prices: np.ndarray, w: float,
          keys: Optional[Sequence] = None) -> Dict:
    """Check every plan, group by group (a group shares the cluster), and
    take each answered DAG's gain. ``plans[i]`` is None where request i
    got no plan. ``keys[i]`` names DAG i's arrays where DAGs repeat, so a
    group of the same DAGs computes its default plan once. Returns
    ``plan_err``, ``mismatched``, ``missing``, ``why`` and ``gains``."""
    out = dict(plan_err=0.0, mismatched=0, missing=0, why="", gains=[])
    covered = set()
    cache: Dict = {}
    for grp in groups:
        grp = [i for i in grp if plans[i] is not None]
        covered.update(grp)
        if not grp:
            continue
        res = check_group([dags[i] for i in grp], [plans[i] for i in grp],
                          caps, prices)
        out["mismatched"] += res["mismatched"]
        if res["err"] > out["plan_err"]:
            out["plan_err"], out["why"] = res["err"], res["why"]
        if res["mismatched"] == 0:
            key = None if keys is None else tuple(keys[i] for i in grp)
            group = [dags[i] for i in grp]
            if key is None or key not in cache:
                cache[key] = airflow_group(group, caps)
            out["gains"].extend(gains(group, [plans[i] for i in grp], caps,
                                      prices, w, cache[key]))
    out["missing"] = sum(1 for i, p in enumerate(plans)
                         if p is None or i not in covered)
    return out
