"""DAG workload representation (paper §4.2 inputs).

A ``Task`` carries a list of candidate ``TaskOption``s — the per-task
configuration axis c that AGORA co-optimizes: each option fixes an instance
type, an instance count (and, for Spark-like jobs, app parameters folded into
the profile), yielding a (duration, demand-vector, cost) triple.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskOption:
    """One resource configuration c for a task."""
    label: str                     # e.g. "9 x m5.4xlarge"
    duration: float                # predicted runtime (s)
    demands: Tuple[float, ...]     # per cluster resource m
    cost: float                    # duration * sum_m demands_m * price_m

    def as_tuple(self):
        return (self.duration, self.demands, self.cost)


@dataclasses.dataclass
class Task:
    name: str
    options: List[TaskOption]
    default_option: int = 0        # the user/prior-run configuration

    def option(self, o: int) -> TaskOption:
        """Option ``o``; an index past the last option takes the last (the
        padding rule of ``FlatProblem.option_arrays``)."""
        return self.options[min(o, len(self.options) - 1)]


@dataclasses.dataclass
class DAG:
    name: str
    tasks: List[Task]
    edges: List[Tuple[int, int]]   # (pred, succ) indices into tasks
    release_time: float = 0.0      # submission time (multi-DAG / trace mode)

    def __post_init__(self):
        n = len(self.tasks)
        for a, b in self.edges:
            assert 0 <= a < n and 0 <= b < n and a != b, (a, b, n)

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def preds(self) -> List[List[int]]:
        p: List[List[int]] = [[] for _ in self.tasks]
        for a, b in self.edges:
            p[b].append(a)
        return p

    def succs(self) -> List[List[int]]:
        s: List[List[int]] = [[] for _ in self.tasks]
        for a, b in self.edges:
            s[a].append(b)
        return s

    def topo_order(self) -> List[int]:
        preds = self.preds()
        indeg = [len(p) for p in preds]
        succs = self.succs()
        ready = [i for i, d in enumerate(indeg) if d == 0]
        out: List[int] = []
        while ready:
            i = ready.pop(0)
            out.append(i)
            for j in succs[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        assert len(out) == len(self.tasks), "cycle in DAG"
        return out

    def critical_path_lengths(self, durations: Sequence[float]) -> np.ndarray:
        """Longest path from each task to a sink, inclusive of own duration."""
        order = self.topo_order()
        succs = self.succs()
        cp = np.zeros(len(self.tasks))
        for i in reversed(order):
            tail = max((cp[j] for j in succs[i]), default=0.0)
            cp[i] = durations[i] + tail
        return cp

    def downstream_counts(self) -> np.ndarray:
        """Airflow priority weight: number of (transitive) descendants."""
        order = self.topo_order()
        succs = self.succs()
        desc = [set() for _ in self.tasks]
        for i in reversed(order):
            for j in succs[i]:
                desc[i].add(j)
                desc[i] |= desc[j]
        return np.asarray([len(d) for d in desc])


@dataclasses.dataclass
class FlatProblem:
    """One or more DAGs flattened into a single RCPSP instance."""
    tasks: List[Task]
    edges: List[Tuple[int, int]]
    dag_of: np.ndarray              # task -> source dag index
    dag_names: List[str]
    release: np.ndarray             # per-task release time (from DAG submission)
    num_resources: int

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def as_dag(self) -> DAG:
        return DAG("flat", self.tasks, list(self.edges))

    def option_arrays(self):
        """Pad per-task options to rectangular arrays.

        Returns (durations (J,O), demands (J,O,M), costs (J,O), n_opts (J,)).
        Padded slots repeat the last real option (``Task.option``)."""
        O = max(len(t.options) for t in self.tasks)
        rows = [[t.option(o) for o in range(O)] for t in self.tasks]
        dur = np.array([[x.duration for x in r] for r in rows], float)
        dem = np.array([[x.demands for x in r] for r in rows], float)
        cost = np.array([[x.cost for x in r] for r in rows], float)
        n = np.array([len(t.options) for t in self.tasks], np.int64)
        return dur, dem, cost, n

    def chosen_options(self, option_idx) -> Tuple[np.ndarray, np.ndarray]:
        """(durations (J,), demands (J, M)) of each task's chosen option,
        read from the tasks alone (``Task.option``)."""
        opts = [t.option(o)
                for t, o in zip(self.tasks, np.asarray(option_idx).tolist())]
        dur = np.array([o.duration for o in opts], float)
        dem = np.array([o.demands for o in opts], float)
        return dur, dem.reshape(len(opts), self.num_resources)


@dataclasses.dataclass
class PackedProblems:
    """A list of FlatProblems pad-and-stacked into rectangular arrays.

    This is the host-side half of batched multi-tenant planning: P ragged
    problems become one (P, Jmax, ...) tensor family plus masks, so the
    device solver can advance all of them in lockstep under a single vmap.
    Masked task slots are inert: zero duration, zero demand, zero cost,
    one dummy option, no edges — they can never displace a real task.
    """
    problems: List[FlatProblem]
    durations: np.ndarray     # (P, Jmax, Omax) f64; 0 in masked slots
    demands: np.ndarray       # (P, Jmax, Omax, M)
    costs: np.ndarray         # (P, Jmax, Omax)
    n_opts: np.ndarray        # (P, Jmax) int64; 1 in masked slots
    num_tasks: np.ndarray     # (P,) int64 — real task count per problem
    task_mask: np.ndarray     # (P, Jmax) bool — True for real tasks
    pred_mask: np.ndarray     # (P, Jmax, Jmax) bool; [p, j, i] = i precedes j
    release: np.ndarray       # (P, Jmax) f64; 0 in masked slots
    default_option: np.ndarray  # (P, Jmax) int64; 0 in masked slots
    num_resources: int

    @property
    def num_problems(self) -> int:
        """Count of REAL problems (bucket-padded slots excluded)."""
        return len(self.problems)

    @property
    def padded_problems(self) -> int:
        """Leading array dimension: real problems + bucket padding slots."""
        return self.task_mask.shape[0]

    @property
    def max_tasks(self) -> int:
        return self.task_mask.shape[1]

    def unpack(self, arr: np.ndarray) -> List[np.ndarray]:
        """Slice a (P, Jmax, ...) array back into per-problem (J_p, ...)."""
        arr = np.asarray(arr)
        assert arr.shape[:2] == self.task_mask.shape, arr.shape
        return [arr[p, :int(self.num_tasks[p])]
                for p in range(self.num_problems)]

    def edges_of(self, p: int) -> List[Tuple[int, int]]:
        return list(self.problems[p].edges)

    def shared_layout(self) -> "SharedCapacityLayout":
        """Flatten the batch into one block-diagonal joint instance whose
        slots all draw from a single cluster-wide usage tensor (cached)."""
        if getattr(self, "_shared_layout", None) is None:
            self._shared_layout = build_shared_layout(self)
        return self._shared_layout


@dataclasses.dataclass
class SharedCapacityLayout:
    """Block-diagonal flattening of a ``PackedProblems`` batch.

    Shared-capacity co-scheduling couples the P tenants through one
    cluster-wide usage tensor: every padded slot (p, j) becomes flattened
    slot p * Jmax + j, the per-problem predecessor masks become one
    block-diagonal (P*Jmax, P*Jmax) mask, and every slot's resource demands
    land in the SAME (T, M) usage accumulation during decoding. The
    isolated-tenant mode is the degenerate case of this layout in which
    tenants demand disjoint resource subsets — then the usage tensor is
    block-diagonal too and the joint decode factorizes back into P
    independent ones.
    """
    packed: PackedProblems
    slot_problem: np.ndarray    # (P*Jmax,) int64 — owning problem per slot
    slot_mask: np.ndarray       # (P*Jmax,) bool — True for real tasks
    durations: np.ndarray       # (P*Jmax, Omax)
    demands: np.ndarray         # (P*Jmax, Omax, M)
    costs: np.ndarray           # (P*Jmax, Omax)
    n_opts: np.ndarray          # (P*Jmax,) int64
    pred_mask: np.ndarray       # (P*Jmax, P*Jmax) bool, block-diagonal
    release: np.ndarray         # (P*Jmax,)
    default_option: np.ndarray  # (P*Jmax,) int64
    num_resources: int

    @property
    def num_slots(self) -> int:
        return self.slot_problem.shape[0]

    def joint_problem(self) -> FlatProblem:
        """Concatenate the real tasks of all tenants into one FlatProblem
        (the instance the event-exact host re-evaluation schedules)."""
        return concat_problems(self.packed.problems)


def build_shared_layout(packed: PackedProblems) -> SharedCapacityLayout:
    P, Jmax = packed.task_mask.shape
    n = P * Jmax
    slot_problem = np.repeat(np.arange(P, dtype=np.int64), Jmax)
    pred = np.zeros((n, n), bool)
    for p in range(P):
        s = p * Jmax
        pred[s:s + Jmax, s:s + Jmax] = packed.pred_mask[p]
    return SharedCapacityLayout(
        packed=packed,
        slot_problem=slot_problem,
        slot_mask=packed.task_mask.reshape(n),
        durations=packed.durations.reshape(n, -1),
        demands=packed.demands.reshape(n, packed.durations.shape[2],
                                       packed.num_resources),
        costs=packed.costs.reshape(n, -1),
        n_opts=packed.n_opts.reshape(n),
        pred_mask=pred,
        release=packed.release.reshape(n),
        default_option=packed.default_option.reshape(n),
        num_resources=packed.num_resources,
    )


def concat_problems(problems: Sequence[FlatProblem]) -> FlatProblem:
    """Stack P FlatProblems into one joint instance on a shared timeline:
    task indices offset per problem, DAG bookkeeping concatenated."""
    problems = list(problems)
    assert problems, "need at least one problem"
    M = problems[0].num_resources
    assert all(pr.num_resources == M for pr in problems)
    tasks: List[Task] = []
    edges: List[Tuple[int, int]] = []
    dag_of: List[np.ndarray] = []
    dag_names: List[str] = []
    release: List[np.ndarray] = []
    for pr in problems:
        base = len(tasks)
        dag_base = len(dag_names)
        tasks.extend(pr.tasks)
        edges.extend((a + base, b + base) for a, b in pr.edges)
        dag_of.append(np.asarray(pr.dag_of) + dag_base)
        dag_names.extend(pr.dag_names)
        release.append(np.asarray(pr.release, float))
    return FlatProblem(tasks, edges, np.concatenate(dag_of), dag_names,
                       np.concatenate(release), M)


def bucket_size(n: int, bucket_p) -> int:
    """Streaming-admission bucket for the problem axis.

    ``bucket_p`` falsy -> exact fit ``n``.  ``True`` -> next power of two
    >= n.  An int -> next power of two >= max(n, bucket_p), i.e. a minimum
    bucket so early small batches pre-pay the common steady-state shape.
    Bucketing pins the padded problem-axis extent across arrivals, so a new
    tenant landing inside the current bucket re-plans under the SAME JIT
    cache entry instead of forcing a fresh trace."""
    if not bucket_p:
        return n
    floor = 1 if bucket_p is True else int(bucket_p)
    target = max(n, floor, 1)
    size = 1
    while size < target:
        size <<= 1
    return size


def pack_problems(problems: Sequence[FlatProblem],
                  num_resources: Optional[int] = None,
                  shared_capacity: bool = False,
                  bucket_p=None) -> PackedProblems:
    """Pad-and-stack P independent problems for one batched device solve.

    With ``shared_capacity=True`` the block-diagonal joint layout (every
    slot's demands mapped into one cluster-wide usage tensor; see
    ``SharedCapacityLayout``) is precomputed and cached on the result.

    With ``bucket_p`` set (``True`` or an int minimum bucket) the problem
    axis is padded to a power-of-two bucket (see ``bucket_size``).  Padded
    problem slots are FULLY masked — zero tasks, zero durations/demands/
    costs, one dummy option, no edges — so a bucketed solve is bit-for-bit
    identical to the unbucketed one for every real problem."""
    problems = list(problems)
    assert problems, "need at least one problem"
    if num_resources is None:
        num_resources = problems[0].num_resources
    assert all(pr.num_resources == num_resources for pr in problems), (
        "all problems must share one cluster resource vector")
    P = bucket_size(len(problems), bucket_p)
    Jmax = max(pr.num_tasks for pr in problems)
    Omax = max(max(len(t.options) for t in pr.tasks) for pr in problems)
    M = num_resources

    dur = np.zeros((P, Jmax, Omax))
    dem = np.zeros((P, Jmax, Omax, M))
    cost = np.zeros((P, Jmax, Omax))
    n_opts = np.ones((P, Jmax), np.int64)      # masked slots: 1 dummy option
    n_real = np.zeros(P, np.int64)
    mask = np.zeros((P, Jmax), bool)
    pred = np.zeros((P, Jmax, Jmax), bool)
    release = np.zeros((P, Jmax))
    default = np.zeros((P, Jmax), np.int64)

    for p, pr in enumerate(problems):
        J = pr.num_tasks
        d, r, c, n = pr.option_arrays()          # (J, O_p[, M]) padded per-task
        O = d.shape[1]
        dur[p, :J, :O] = d
        # option slots beyond O_p repeat the last real option (same convention
        # as FlatProblem.option_arrays) so any in-range index decodes validly
        dur[p, :J, O:] = d[:, -1:]
        dem[p, :J, :O] = r
        dem[p, :J, O:] = r[:, -1:]
        cost[p, :J, :O] = c
        cost[p, :J, O:] = c[:, -1:]
        n_opts[p, :J] = n
        n_real[p] = J
        mask[p, :J] = True
        for a, b in pr.edges:
            pred[p, b, a] = True
        release[p, :J] = pr.release
        default[p, :J] = [t.default_option for t in pr.tasks]

    packed = PackedProblems(problems, dur, dem, cost, n_opts, n_real, mask,
                            pred, release, default, num_resources)
    if shared_capacity:
        packed.shared_layout()
    return packed


def flatten(dags: Sequence[DAG], num_resources: int) -> FlatProblem:
    tasks: List[Task] = []
    edges: List[Tuple[int, int]] = []
    dag_of: List[int] = []
    release: List[float] = []
    for di, d in enumerate(dags):
        base = len(tasks)
        tasks.extend(d.tasks)
        edges.extend((a + base, b + base) for a, b in d.edges)
        dag_of.extend([di] * d.num_tasks)
        release.extend([d.release_time] * d.num_tasks)
    return FlatProblem(tasks, edges, np.asarray(dag_of), [d.name for d in dags],
                       np.asarray(release), num_resources)
