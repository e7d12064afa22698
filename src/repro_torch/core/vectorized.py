"""Massively parallel simulated annealing in PyTorch (port of the JAX
package's ``core/vectorized.py``).

* a fixed-trip-count serial-SGS **decoder** on a quantized time grid
  (``kernels.ops.sgs_decode``: the hand-written CUDA kernel on the card,
  its plain PyTorch version on the CPU);
* B independent (configuration, priority) annealing chains advanced in
  lockstep, for P problems at once: the reference's two ``vmap`` levels
  are the (P, B, J) batch written out, and one decode launch per sweep
  covers all P x B chains (the kernel's group axis is the problem);
* shared-capacity co-scheduling: every chain decodes all P tenants into
  one cluster-wide usage tensor.

There is no ``jit``: the sweep loop is a Python loop of tensor ops that
never syncs with the host, and compile-once becomes signature accounting
— each engine's ``cache_size()`` counts the distinct (P_pad, Jmax, Omax,
M, cfg, devices) signatures it has run, so ``PlannerSession.stats`` keeps
its meaning and warm traffic adds nothing.

Every random number of a solve comes from one ``DrawTape`` computed before
the sweep loop, keyed per problem (see ``draw_tape``). The tests replay
the reference's ``jax.random`` draws through the same seam.

A (prob, chain) device mesh (``launch/mesh.py``) shards a solve: one
process drives every shard, stepping them sweep by sweep, and the replica
exchange gathers each chain shard's incumbents (``_exchange``), exactly as
the reference's ``shard_map`` collectives do.

The final incumbent is re-evaluated event-exactly on the host (sgs.py), so
grid quantization never corrupts reported numbers.
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cluster.catalog import Cluster
from repro_torch.core.dag import (FlatProblem, PackedProblems,
                                  SharedCapacityLayout, pack_problems)
from repro_torch.core.objectives import Goal, Solution
from repro_torch.core.sgs import (schedule_cost, sgs_schedule,
                                  validate_schedule_many)
from repro_torch.device import FLOAT, INDEX, INT, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import span

_SQRT_HALF = float(np.float32(math.sqrt(0.5)))

@dataclasses.dataclass(frozen=True)
class VecConfig:
    chains: int = 256
    iters: int = 600
    grid: int = 256                # time bins
    t0: float = 1.0
    cooling: float = 0.995
    migrate_every: int = 50        # replica-exchange period
    seed: int = 0
    horizon_slack: float = 1.6     # grid horizon = slack * reference makespan
    prio_sigma: float = 0.35
    # shared-capacity accept dynamics: False (default) keeps the selfish
    # per-tenant Metropolis accept (and with it the bit-for-bit disjoint-
    # capacity invariant); True accepts on the SUMMED per-tenant energy
    # delta — joint welfare — one verdict per chain applied to all tenants.
    joint_accept: bool = False
    # grid-SGS decode backend (kernels/ops.py): None = by device (the CUDA
    # kernel for CUDA tensors, the plain version for CPU tensors); False
    # forces the plain version; True forces the kernel (CUDA only).
    use_kernel: Optional[bool] = None
    # in-solve convergence telemetry: the sweep loop additionally keeps a
    # strided trace (per-(sample, problem) incumbent energy, acceptance
    # rate, cumulative replica exchanges); the trajectory and its draws are
    # untouched. ON is a distinct signature, like every VecConfig field.
    # One sample every ``telemetry_every`` sweeps (plus the final sweep).
    telemetry: bool = False
    telemetry_every: int = 10


# ---------------------------------------------------------------------------
# SolveSpec -> engine registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """The static solve signature a ``PlannerSession`` pins at construction:
    the solver kind, whether tenants couple through one cluster-wide usage
    tensor, and the mesh arity. ``resolve_engine(spec)`` picks the engine."""
    solver: str = "vectorized"       # "vectorized" | "anneal" | "ising"
    shared_capacity: bool = False
    mesh_axes: int = 0               # 0 = no mesh, 1 = legacy chains, 2 = planner

    def __post_init__(self):
        if self.solver not in ("vectorized", "anneal", "ising"):
            raise ValueError(f"unknown solver {self.solver!r} "
                             f"(expected vectorized | anneal | ising)")
        if self.mesh_axes not in (0, 1, 2):
            raise ValueError(f"mesh_axes must be 0, 1 or 2, "
                             f"got {self.mesh_axes}")

    @property
    def engine_key(self) -> str:
        """Which registered engine serves this spec. Host-side solvers have
        no batched device path, and a legacy 1-D chains mesh only shards
        the single-problem solve — both route through the sequential host
        engine."""
        if self.solver == "ising":
            return "ising"
        if self.solver == "anneal" or self.mesh_axes == 1:
            return "host-anneal"
        return "shared" if self.shared_capacity else "isolated"


@dataclasses.dataclass
class SolveBatch:
    """One engine invocation: P per-tenant problems plus the session-pinned
    knobs. ``solve_single`` is the spec-faithful single-problem solver the
    sequential host engines loop over."""
    spec: SolveSpec
    problems: List[FlatProblem]
    cluster: Cluster
    goal: Goal                                   # session default / joint goal
    goals: List[Goal]                            # per-tenant objectives
    refs: List[Tuple[float, float]]
    cfg: VecConfig
    bucket_p: object = None
    mesh: object = None
    solve_single: Optional[Callable] = None      # (problem, ref, goal) -> Solution
    device: Optional[torch.device] = None
    # the solve's phases, appended as ``obs.trace.span`` records by the
    # engines that time them (None: not recorded)
    spans: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class Engine:
    """A registered solve engine. ``fn(batch) -> (solutions, joint_errors)``;
    ``cache_size`` counts the distinct solve signatures the engine has run
    (0 for host engines), so a session can account first runs vs repeats."""
    key: str
    fn: Callable[["SolveBatch"], Tuple[List[Solution], Optional[List[str]]]]
    cache_size: Callable[[], int]


_ENGINES: Dict[str, Engine] = {}


def register_engine(key: str, fn, cache_size=lambda: 0) -> None:
    _ENGINES[key] = Engine(key, fn, cache_size)


def resolve_engine(spec: SolveSpec) -> Engine:
    try:
        return _ENGINES[spec.engine_key]
    except KeyError:
        raise KeyError(f"no engine registered for {spec} "
                       f"(key {spec.engine_key!r}; registered: "
                       f"{sorted(_ENGINES)})") from None


# signatures each device engine has run: the port's counterpart of the
# reference's live JIT cache entries
_SIGNATURES: Dict[str, set] = {"isolated": set(), "shared": set()}


def _note_signature(engine: str, packed: PackedProblems, cfg: VecConfig,
                    grid: np.ndarray) -> None:
    """``grid`` is the solve's device grid (see ``_device_grid``): the mesh
    rides in the signature, as in the reference's static JIT arguments."""
    _SIGNATURES[engine].add((packed.padded_problems, packed.max_tasks,
                             packed.durations.shape[2], packed.num_resources,
                             cfg, grid.shape,
                             tuple(str(d) for d in grid.flat)))


def _device_grid(mesh, device) -> np.ndarray:
    """The (prob, chain) grid of devices a solve runs on: the mesh's, a 1-D
    chains mesh as one row, or ``[[device]]`` without a mesh. The same
    device may fill several entries (one card, or the CPU, can run a
    (2, 1) or (1, 2) mesh); that changes no result."""
    if mesh is None:
        return np.array([[resolve_device(device)]], dtype=object)
    grid = np.asarray(mesh.devices, dtype=object)
    if len(mesh.axis_names) == 1:
        grid = grid.reshape(1, -1)
    if grid.ndim != 2:
        raise ValueError(f"a mesh of axes {mesh.axis_names} is neither a "
                         f"(prob, chain) planner mesh nor a chains mesh")
    return grid


def _split(n: int, parts: int, what: str):
    """``parts`` equal slices of range(n)."""
    if n % parts:
        raise ValueError(f"{n} {what} do not split over {parts} mesh "
                         f"entries")
    k = n // parts
    return [slice(i * k, (i + 1) * k) for i in range(parts)]


def _t(x, dtype, device) -> torch.Tensor:
    """A host array as a new tensor of ``dtype`` on ``device`` (a copy:
    the source may be a read-only view of another framework's buffer)."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Problem -> device tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceProblem:
    dur_bins: torch.Tensor      # (J, O) int32
    demands: torch.Tensor       # (J, O, M) f32
    costs: torch.Tensor         # (J, O) f32
    n_opts: torch.Tensor        # (J,) int32
    pred_mask: torch.Tensor     # (J, J) bool; [j, p] = p is predecessor of j
    release_bins: torch.Tensor  # (J,) int32
    caps: torch.Tensor          # (M,) f32
    dt: float
    T: int

    @classmethod
    def build(cls, problem: FlatProblem, cluster: Cluster, ref_makespan: float,
              cfg: VecConfig, device=None) -> "DeviceProblem":
        device = resolve_device(device)
        dur, dem, cost, n_opts = problem.option_arrays()
        J = problem.num_tasks
        horizon = max(ref_makespan * cfg.horizon_slack, dur.max() * 2.0)
        dt = horizon / cfg.grid
        dur_bins = np.maximum(np.ceil(dur / dt).astype(np.int32), 1)
        pred = np.zeros((J, J), bool)
        for a, b in problem.edges:
            pred[b, a] = True
        return cls(
            dur_bins=_t(dur_bins, INT, device),
            demands=_t(dem, FLOAT, device),
            costs=_t(cost, FLOAT, device),
            n_opts=_t(n_opts, INT, device),
            pred_mask=_t(pred, torch.bool, device),
            release_bins=_t(np.ceil(problem.release / dt), INT, device),
            caps=_t(cluster.caps, FLOAT, device),
            dt=dt, T=cfg.grid)


@dataclasses.dataclass
class BatchedDeviceProblem:
    """Device tensors for P ragged problems pad-and-stacked to (P, Jmax, ...).

    Masked slots carry zero duration / zero demand / zero cost and no edges,
    so they decode to start=0 no-ops that cannot displace a real task; the
    grid resolution ``dt`` is a (P,) vector because each tenant's horizon is
    scaled to its own reference makespan."""
    dur_bins: torch.Tensor      # (P, J, O) int32; 0 in masked slots
    demands: torch.Tensor       # (P, J, O, M) f32
    costs: torch.Tensor         # (P, J, O) f32
    n_opts: torch.Tensor        # (P, J) int32; 1 in masked slots
    n_real: torch.Tensor        # (P,) int32
    task_mask: torch.Tensor     # (P, J) bool
    pred_mask: torch.Tensor     # (P, J, J) bool
    release_bins: torch.Tensor  # (P, J) int32
    caps: torch.Tensor          # (M,) f32 — one shared cluster
    dt: torch.Tensor            # (P,) f32
    T: int

    @classmethod
    def build(cls, packed: PackedProblems, cluster: Cluster,
              ref_makespans: np.ndarray, cfg: VecConfig,
              device=None) -> "BatchedDeviceProblem":
        device = resolve_device(device)
        dur = packed.durations                              # (P, J, O)
        real_opt = packed.task_mask[:, :, None]             # (P, J, 1)
        horizon = np.maximum(np.asarray(ref_makespans) * cfg.horizon_slack,
                             dur.max(axis=(1, 2)) * 2.0)    # (P,)
        dt = horizon / cfg.grid
        bins = np.ceil(dur / dt[:, None, None]).astype(np.int32)
        dur_bins = np.where(real_opt, np.maximum(bins, 1), 0)
        release_bins = np.ceil(packed.release / dt[:, None]).astype(np.int32)
        return cls(
            dur_bins=_t(dur_bins, INT, device),
            demands=_t(packed.demands, FLOAT, device),
            costs=_t(packed.costs, FLOAT, device),
            n_opts=_t(packed.n_opts, INT, device),
            n_real=_t(packed.num_tasks, INT, device),
            task_mask=_t(packed.task_mask, torch.bool, device),
            pred_mask=_t(packed.pred_mask, torch.bool, device),
            release_bins=_t(release_bins, INT, device),
            caps=_t(cluster.caps, FLOAT, device),
            dt=_t(dt, FLOAT, device), T=cfg.grid)

    def select(self, rows: slice, device) -> "BatchedDeviceProblem":
        """The problems ``rows`` on ``device``: one problem shard's arrays."""
        fields = {f.name: getattr(self, f.name) for f in
                  dataclasses.fields(self) if f.name != "T"}
        return BatchedDeviceProblem(
            **{k: (v if k == "caps" else v[rows]).to(device)
               for k, v in fields.items()}, T=self.T)


_LEAF_DTYPES = dict(dur_bins=INT, demands=FLOAT, costs=FLOAT, n_opts=INT,
                    n_real=INT, task_mask=torch.bool, pred_mask=torch.bool,
                    release_bins=INT, caps=FLOAT, dt=FLOAT)


def device_problem_from_numpy(leaves: Mapping[str, np.ndarray], *, T: int,
                              device=None):
    """The JAX package's problem arrays, as numpy, -> the port's problem.

    ``leaves`` are the fields of a reference ``BatchedDeviceProblem`` (it
    has ``n_real``; -> the port's ``BatchedDeviceProblem``) or of a
    ``DeviceProblem``, such as a ``SharedDeviceProblem``'s joint instance
    (-> the port's ``DeviceProblem``, with ``dt`` as a float32 value)."""
    device = resolve_device(device)
    if "n_real" in leaves:
        fields = {k: _t(leaves[k], _LEAF_DTYPES[k], device)
                  for k in _LEAF_DTYPES}
        return BatchedDeviceProblem(**fields, T=T)
    fields = {k: _t(leaves[k], _LEAF_DTYPES[k], device)
              for k in _LEAF_DTYPES if k not in ("n_real", "task_mask", "dt")}
    return DeviceProblem(**fields, dt=float(np.float32(leaves["dt"])), T=T)


# ---------------------------------------------------------------------------
# The draw seam
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DrawTape:
    """Every random number of one solve, drawn before the sweep loop.

    Init draws are (P, B, J); per-sweep draws are (iters, P, B) — the five
    draws of a sweep: the slot whose option mutates (``j_opt``), its new
    option (``new_o`` < n_opts of that slot), the slot whose priority
    jitters (``j_pr``), the jitter's draw and the Metropolis
    uniform. Both engines read the same tape, which is what lets shared
    mode over disjoint capacities equal isolated mode."""
    rand_opt: torch.Tensor      # (P, B, J) int32 in [0, 1e6), before % n_opts
    prio0: torch.Tensor         # (P, B, J) f32 N(0, 1), before * prio_sigma
    j_opt: torch.Tensor         # (iters, P, B) int64
    new_o: torch.Tensor         # (iters, P, B) int32
    j_pr: torch.Tensor          # (iters, P, B) int64
    jitter: torch.Tensor        # (iters, P, B) f32 N(0, 1/2): erf_inv(U(-1, 1)),
                                # a standard normal before its factor sqrt(2)
    u: torch.Tensor             # (iters, P, B) f32 U[0, 1)

    _DTYPES = dict(rand_opt=INT, prio0=FLOAT, j_opt=INDEX, new_o=INT,
                   j_pr=INDEX, jitter=FLOAT, u=FLOAT)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device=None) -> "DrawTape":
        device = resolve_device(device)
        return cls(**{k: _t(arrays[k], dt, device)
                      for k, dt in cls._DTYPES.items()})

    def select(self, rows: slice, chains: slice, device) -> "DrawTape":
        """The draws of problems ``rows`` x chains ``chains`` on
        ``device``: one shard's part of an unsharded tape."""
        return DrawTape(**{
            k: (getattr(self, k)[rows, chains] if k in ("rand_opt", "prio0")
                else getattr(self, k)[:, rows, chains]).to(device)
            for k in self._DTYPES})

    def check(self, P: int, B: int, J: int, iters: int) -> None:
        want = dict(rand_opt=(P, B, J), prio0=(P, B, J))
        want.update({k: (iters, P, B)
                     for k in ("j_opt", "new_o", "j_pr", "jitter", "u")})
        for k, shape in want.items():
            got = tuple(getattr(self, k).shape)
            if got != shape:
                raise ValueError(f"draw tape {k} has shape {got}, this solve "
                                 f"needs {shape}")


def _problem_generator(seed: int, p: int, device,
                       stream: Optional[int] = None) -> torch.Generator:
    g = torch.Generator(device=device)
    key = [seed, p] if stream is None else [seed, p, stream]
    g.manual_seed(int(np.random.SeedSequence(key)
                      .generate_state(1, np.uint64)[0]))
    return g


def draw_tape(packed: PackedProblems, cfg: VecConfig, device, *,
              rows: slice = slice(None), chains: Optional[int] = None,
              stream: Optional[int] = None) -> DrawTape:
    """The production tape: problem p's draws come from its own generator
    on the device, seeded from (cfg.seed, p) — never from a bulk (P, ...)
    draw — so problem p's stream does not depend on how many problems
    share the batch. That keying is what makes a bucket-padded batch
    reproduce an unbucketed one bit-for-bit (the counterpart of the
    reference's per-problem ``fold_in(k, p)``), and a problem-sharded
    solve reproduce an unsharded one. A chain shard draws ``chains``
    chains of the problems ``rows`` from streams keyed (cfg.seed, p,
    ``stream``): each chain shard its own, as the reference folds the
    chain axis index into each problem's key."""
    P_pad, J = packed.task_mask.shape
    B, n = (cfg.chains if chains is None else chains), cfg.iters
    parts: Dict[str, list] = {k: [] for k in DrawTape._DTYPES}
    for p in range(P_pad)[rows]:
        g = _problem_generator(cfg.seed, p, device, stream)
        kw = dict(generator=g, device=device)
        n_mut = max(int(packed.num_tasks[p]), 1)
        n_opts = _t(packed.n_opts[p], INT, device)
        parts["rand_opt"].append(torch.randint(0, 1_000_000, (B, J),
                                               dtype=INT, **kw))
        parts["prio0"].append(torch.randn((B, J), dtype=FLOAT, **kw))
        j_opt = torch.randint(0, n_mut, (n, B), dtype=INDEX, **kw)
        bound = n_opts[j_opt]
        pick = torch.rand((n, B), dtype=FLOAT, **kw)
        parts["j_opt"].append(j_opt)
        parts["new_o"].append(torch.minimum((pick * bound).to(INT), bound - 1))
        parts["j_pr"].append(torch.randint(0, n_mut, (n, B), dtype=INDEX,
                                           **kw))
        parts["jitter"].append(torch.randn((n, B), dtype=FLOAT, **kw)
                               * _SQRT_HALF)
        parts["u"].append(torch.rand((n, B), dtype=FLOAT, **kw))
    return DrawTape(**{k: torch.stack(v, dim=0 if k in ("rand_opt", "prio0")
                                      else 1)
                       for k, v in parts.items()})


# ---------------------------------------------------------------------------
# Grid SGS decoder and chain energies
# ---------------------------------------------------------------------------


def decode_schedule_batch(dp: DeviceProblem, option_idx, priority, *,
                          use_kernel: Optional[bool] = None):
    """Batched grid-SGS decode of one problem: option_idx (B, J) int32,
    priority (B, J) f32 -> (start (B, J), finish (B, J), placed_ok (B, J)
    bool). The per-task option gathers are hoisted here, outside the
    placement loop; the capacity-window test only considers resources the
    task actually demands, so one tenant's overload can never block an
    unrelated tenant in a shared usage tensor."""
    J = dp.dur_bins.shape[0]
    jrow = torch.arange(J, device=option_idx.device)[None, :]
    oi = option_idx.to(INDEX)
    return kops.sgs_decode(dp.dur_bins[jrow, oi], dp.demands[jrow, oi],
                           priority, dp.release_bins, dp.pred_mask, dp.caps,
                           T=dp.T, use_kernel=use_kernel)


def decode_schedule_full(dp: DeviceProblem, option_idx, priority, *,
                         use_kernel: Optional[bool] = None):
    """Single-candidate grid-SGS decode (the B=1 case of
    ``decode_schedule_batch``): option_idx (J,) int32, priority (J,) f32
    -> (start (J,), finish (J,), placed_ok (J,) bool)."""
    start, finish, ok = decode_schedule_batch(
        dp, option_idx[None, :], priority[None, :], use_kernel=use_kernel)
    return start[0], finish[0], ok[0]


def decode_schedule(dp: DeviceProblem, option_idx, priority, *,
                    use_kernel: Optional[bool] = None):
    """option_idx (J,) int32, priority (J,) f32 -> (start (J,), makespan,
    cost, infeasible_count), each a tensor on the problem's device."""
    start, finish, placed_ok = decode_schedule_full(
        dp, option_idx, priority, use_kernel=use_kernel)
    J = dp.costs.shape[0]
    cost = dp.costs[torch.arange(J, device=dp.costs.device),
                    option_idx.to(INDEX)].sum()
    makespan = finish.max().to(FLOAT) * dp.dt
    infeas = (~placed_ok).sum().to(INT)
    return start, makespan, cost, infeas


def decode_schedule_many(bdp: BatchedDeviceProblem, option_idx, priority, *,
                         use_kernel: Optional[bool] = None):
    """The reference's vmap of ``decode_schedule_batch`` over P problems,
    written out: option_idx/priority (P, B, J) -> (start, finish, ok), each
    (P, B, J), from ONE decode whose group axis is the problem."""
    P_n, B, J = option_idx.shape
    dev = option_idx.device
    pidx = torch.arange(P_n, device=dev)[:, None, None]
    jidx = torch.arange(J, device=dev)[None, None, :]
    oi = option_idx.to(INDEX)
    M = bdp.caps.shape[0]
    out = kops.sgs_decode(bdp.dur_bins[pidx, jidx, oi].reshape(P_n * B, J),
                          bdp.demands[pidx, jidx, oi].reshape(P_n * B, J, M),
                          priority.reshape(P_n * B, J), bdp.release_bins,
                          bdp.pred_mask, bdp.caps, T=bdp.T,
                          use_kernel=use_kernel)
    return tuple(x.reshape(P_n, B, J) for x in out)


def _deadline_term(mk, dl, dl_w):
    """Hinge SLA penalty (Goal.deadline_penalty, device side). ``dl_w=0``
    (no deadline class) contributes an exact 0.0, preserving non-SLA
    energies bit-for-bit."""
    pen = dl_w * torch.clamp(mk - dl, min=0.0) / torch.clamp(dl, min=1e-6)
    return torch.where(dl_w > 0, pen, 0.0)


def _energy(goal_w, ref_M, ref_C, dl, dl_w, mk, cost, infeas):
    """Per-(problem, chain) energy from (P,) weights and (P, B) makespan,
    cost and infeasible-placement counts; the reference's arithmetic in
    the reference's order."""
    gw, rM, rC = goal_w[:, None], ref_M[:, None], ref_C[:, None]
    e = gw * (mk - rM) / rM + (1.0 - gw) * (cost - rC) / rC
    e = e + _deadline_term(mk, dl[:, None], dl_w[:, None])
    return e + 100.0 * infeas.to(FLOAT)


def chain_energy(bdp: BatchedDeviceProblem, goal_w, ref_M, ref_C, dl, dl_w,
                 option_idx, priority, *, use_kernel=None):
    """Chain energies of P independent problems: option_idx/priority
    (P, B, J) -> per-chain (energy, makespan, cost), each (P, B), from ONE
    batched decode. ``goal_w``/``ref_M``/``ref_C``/``dl``/``dl_w`` are
    per-problem (P,) f32."""
    _, finish, ok = decode_schedule_many(bdp, option_idx, priority,
                                         use_kernel=use_kernel)
    P_n, _, J = option_idx.shape
    dev = option_idx.device
    cost = bdp.costs[torch.arange(P_n, device=dev)[:, None, None],
                     torch.arange(J, device=dev)[None, None, :],
                     option_idx.to(INDEX)].sum(dim=2)                # (P, B)
    mk = finish.amax(dim=2).to(FLOAT) * bdp.dt[:, None]
    infeas = (~ok).sum(dim=2)
    return _energy(goal_w, ref_M, ref_C, dl, dl_w, mk, cost, infeas), mk, cost


# ---------------------------------------------------------------------------
# Batched SA
# ---------------------------------------------------------------------------


def _migrate_chains(opt, prio, e, best_opt, best_prio, best_e):
    """Replica exchange per problem over (P, B, ...) chain states: the best
    chain (argmin of per-chain incumbents) replaces the worst live chain,
    first index on ties on both sides."""
    p = torch.arange(e.shape[0], device=e.device)
    src = best_e.argmin(dim=1)
    dst = e.argmax(dim=1)
    opt, prio, e = opt.clone(), prio.clone(), e.clone()
    opt[p, dst] = best_opt[p, src]
    prio[p, dst] = best_prio[p, src]
    e[p, dst] = best_e[p, src]
    return opt, prio, e


def _exchange(row) -> None:
    """Replica exchange across the chain shards of one problem block: the
    collective form of ``_migrate_chains``. Each shard's incumbent (its
    local argmin) and worst energy are gathered on the first shard's
    device; the global best is the first shard's on ties, and one owner of
    the global worst, the first shard holding it, takes it at its local
    argmax. Shard order is chain order, so this equals ``_migrate_chains``
    over the chains laid end to end, bit for bit."""
    if len(row) == 1:
        st = row[0]
        st.opt, st.prio, st.e = _migrate_chains(st.opt, st.prio, st.e,
                                                st.best_opt, st.best_prio,
                                                st.best_e)
        return
    home = row[0].e.device
    inc_e, inc_opt, inc_prio, worst = [], [], [], []
    for st in row:
        p = torch.arange(st.e.shape[0], device=st.e.device)
        src = st.best_e.argmin(dim=1)
        inc_e.append(st.best_e[p, src].to(home))
        inc_opt.append(st.best_opt[p, src].to(home))
        inc_prio.append(st.best_prio[p, src].to(home))
        worst.append(st.e.amax(dim=1).to(home))
    inc_e = torch.stack(inc_e)                                   # (S, P)
    p = torch.arange(inc_e.shape[1], device=home)
    g = inc_e.argmin(dim=0)
    b_e = inc_e[g, p]
    b_opt = torch.stack(inc_opt)[g, p]
    b_prio = torch.stack(inc_prio)[g, p]
    owner = torch.stack(worst).argmax(dim=0)
    for c, st in enumerate(row):
        dev = st.e.device
        mine = (owner == c).to(dev)
        p = torch.arange(st.e.shape[0], device=dev)
        dst = st.e.argmax(dim=1)
        st.opt, st.prio, st.e = st.opt.clone(), st.prio.clone(), st.e.clone()
        st.opt[p, dst] = torch.where(mine[:, None], b_opt.to(dev),
                                     st.opt[p, dst])
        st.prio[p, dst] = torch.where(mine[:, None], b_prio.to(dev),
                                      st.prio[p, dst])
        st.e[p, dst] = torch.where(mine, b_e.to(dev), st.e[p, dst])


def _telemetry_steps(iters: int, every: int) -> np.ndarray:
    """Sweep indices the telemetry trace samples: every ``every``-th sweep
    plus the final one (the converged incumbent is always visible)."""
    every = max(int(every), 1)
    steps = np.arange(every - 1, iters, every)
    if len(steps) == 0 or steps[-1] != iters - 1:
        steps = np.append(steps, iters - 1)
    return steps.astype(np.int32)


def _jitter_scale(prio_sigma: float) -> float:
    """The reference jitters with ``normal * prio_sigma`` where ``normal =
    sqrt(2) * erf_inv(u)``. XLA folds the two constants into one float32
    factor, so its update is ``prio + float32(erf_inv(u) * factor)``: the
    tape holds ``erf_inv(u)`` and the port multiplies by the same factor."""
    return float(np.float32(np.float32(math.sqrt(2.0))
                            * np.float32(prio_sigma)))


class _Shard:
    """The (P, B, J) chain states of one shard of a solve: a block of
    problems x a block of chains, on one device, with the energy function
    and the draws of its block."""

    def __init__(self, energy_fn, opt0, prio0, tape: DrawTape, *,
                 shared: bool):
        self.energy_fn, self.tape = energy_fn, tape
        e0 = energy_fn(opt0, prio0)[0]
        self.opt, self.prio, self.e = opt0, prio0, e0
        self.best_opt, self.best_prio, self.best_e = opt0, prio0, e0
        self.jbest = (opt0, prio0, e0.sum(dim=0)) if shared else None
        P_n, B, _ = opt0.shape
        self.pidx = torch.arange(P_n, device=opt0.device)[:, None]
        self.bidx = torch.arange(B, device=opt0.device)[None, :]

    def sweep(self, it: int, sigma: float, t_eff: float, cfg: VecConfig):
        """One SA sweep (before the replica exchange); returns the accept
        mask (P, B)."""
        tape, pidx, bidx = self.tape, self.pidx, self.bidx
        opt, prio, e = self.opt, self.prio, self.e
        # propose: mutate one task's option; jitter one task's priority
        j_opt, j_pr = tape.j_opt[it], tape.j_pr[it]
        p_opt = opt.clone()
        p_opt[pidx, bidx, j_opt] = tape.new_o[it]
        p_prio = prio.clone()
        p_prio[pidx, bidx, j_pr] = (prio[pidx, bidx, j_pr]
                                    + tape.jitter[it] * sigma)
        p_e = self.energy_fn(p_opt, p_prio)[0]

        if self.jbest is not None:
            # joint-best update on the PROPOSAL (a coherent state whose
            # energies were just computed together), before per-tenant
            # accepts mix proposals into per-tenant states
            jbest = self.jbest
            prop_sum = p_e.sum(dim=0)                                # (B,)
            jb = prop_sum < jbest[2]
            self.jbest = (torch.where(jb[None, :, None], p_opt, jbest[0]),
                          torch.where(jb[None, :, None], p_prio, jbest[1]),
                          torch.where(jb, prop_sum, jbest[2]))

        dE = p_e - e
        if self.jbest is not None and cfg.joint_accept:
            # joint welfare: one verdict per chain on the summed delta,
            # drawn from tenant 0's uniform stream, applied to all tenants
            dE_sum = dE.sum(dim=0)
            acc = (dE_sum < 0) | (torch.exp(-dE_sum / t_eff) > tape.u[it, 0])
            accept = acc[None, :].expand_as(dE)
        else:
            accept = (dE < 0) | (torch.exp(-dE / t_eff) > tape.u[it])
        self.opt = torch.where(accept[:, :, None], p_opt, opt)
        self.prio = torch.where(accept[:, :, None], p_prio, prio)
        self.e = torch.where(accept, p_e, e)

        better = self.e < self.best_e
        self.best_opt = torch.where(better[:, :, None], self.opt,
                                    self.best_opt)
        self.best_prio = torch.where(better[:, :, None], self.prio,
                                     self.best_prio)
        self.best_e = torch.where(better, self.e, self.best_e)
        return accept


def _sa_loop(shards, cfg: VecConfig, *, shared: bool):
    """Run cfg.iters SA sweeps over a grid of shards: rows of problem
    blocks, each row's entries blocks of the same problems' chains. Every
    shard is stepped sweep by sweep, so each device's queue stays full;
    every ``migrate_every`` sweeps each row exchanges replicas across its
    chain shards (``_exchange``).

    Each problem keeps its own chains, proposals and accept decisions, read
    from its rows of the tape. ``shared`` adds the coupled engine's coherent
    joint-best tracking and, with ``cfg.joint_accept``, one Metropolis
    verdict per chain on the summed energy delta. Nothing inside the loop
    syncs with the host: the temperature and the migration schedule are
    host numbers fixed by the config. Returns the state, each chain-indexed
    tensor laid end to end over the shards on the first shard's device."""
    rows = [[_Shard(*sh, shared=shared) for sh in row] for row in shards]
    home = rows[0][0].e.device
    temp = np.float32(cfg.t0)
    sigma = _jitter_scale(cfg.prio_sigma)
    trace = []
    for it in range(cfg.iters):
        t_eff = float(max(temp, np.float32(1e-9)))
        do_mig = it % cfg.migrate_every == cfg.migrate_every - 1
        sample = []
        for row in rows:
            accepts = [st.sweep(it, sigma, t_eff, cfg) for st in row]
            if do_mig:
                _exchange(row)
            if cfg.telemetry:
                sample.append((_cat([st.best_e for st in row], 1,
                                    home).amin(dim=1),
                               _cat(accepts, 1, home).to(FLOAT).mean(dim=1)))
        if cfg.telemetry:
            trace.append((_cat([b for b, _ in sample], 0, home),
                          _cat([a for _, a in sample], 0, home), int(do_mig)))
        temp = np.float32(temp * np.float32(cfg.cooling))

    def gather(key):
        return _cat([_cat([getattr(st, key) for st in row], 1, home)
                     for row in rows], 0, home)

    state = {k: gather(k) for k in ("opt", "prio", "e", "best_opt",
                                    "best_prio", "best_e")}
    if shared:
        state.update(
            jbest_opt=_cat([st.jbest[0] for st in rows[0]], 1, home),
            jbest_prio=_cat([st.jbest[1] for st in rows[0]], 1, home),
            jbest_sum=_cat([st.jbest[2] for st in rows[0]], 0, home))
    if cfg.telemetry:
        idx = _telemetry_steps(cfg.iters, cfg.telemetry_every)
        mig = np.cumsum([m for _, _, m in trace])[idx]
        P_n = state["e"].shape[0]
        state.update(
            tel_best_e=torch.stack([b for b, _, _ in trace], dim=1)[:, idx],
            tel_accept=torch.stack([a for _, a, _ in trace], dim=1)[:, idx],
            tel_mig=np.broadcast_to(mig[None, :], (P_n, len(idx))))
    return state


def _cat(xs, dim: int, device) -> torch.Tensor:
    """Shards' tensors laid end to end along ``dim`` on ``device`` (one
    shard's tensor as it is)."""
    if len(xs) == 1:
        return xs[0].to(device)
    return torch.cat([x.to(device) for x in xs], dim=dim)


def _sa_scan(bdp: BatchedDeviceProblem, goal_w, ref_M, ref_C, dl, dl_w,
             cfg: VecConfig, opt0, prio0, tape: DrawTape):
    """Isolated SA over P independent problems x B chains; each problem's
    mutation targets are bounded by its real-task count through the tape
    (fully masked bucket-padding problems mutate their inert slot 0)."""
    energy_fn = partial(chain_energy, bdp, goal_w, ref_M, ref_C, dl, dl_w,
                        use_kernel=cfg.use_kernel)
    return _sa_loop([[(energy_fn, opt0, prio0, tape)]], cfg, shared=False)


_MASKED_PRIO = -1e9   # below any real priority, above the -inf sentinel


def _init_chains(packed: PackedProblems, cfg: VecConfig, tape: DrawTape,
                 device, rows: slice = slice(None), chain0: int = 0):
    """Initial chain states (P, B, J) for both batched engines: even chains
    start from the default configuration, odd ones from random options;
    priorities are jittered, masked slots pinned to ``_MASKED_PRIO``. A
    shard takes the problems ``rows`` and the tape's chains, numbered from
    ``chain0`` (the parity is the chain's number in the whole solve)."""
    P_n, B, J = tape.rand_opt.shape
    n_opts = _t(packed.n_opts[rows], INT, device)
    defaults = _t(packed.default_option[rows], INT, device)     # (P, J)
    opt0 = defaults[:, None, :].expand(P_n, B, J)
    rand_opt = tape.rand_opt % n_opts[:, None, :]
    even = ((torch.arange(B, device=device) + chain0) % 2 == 0)[None, :, None]
    opt0 = torch.where(even, opt0, rand_opt)
    prio0 = tape.prio0 * cfg.prio_sigma
    prio0 = torch.where(
        _t(packed.task_mask[rows], torch.bool, device)[:, None, :],
        prio0, _MASKED_PRIO)
    return opt0, prio0


def _shard_inputs(packed: PackedProblems, cfg: VecConfig, device,
                  tape: Optional[DrawTape], rows: slice, chains: slice,
                  stream: Optional[int]):
    """(tape, opt0, prio0) of the shard of problems ``rows`` x chains
    ``chains`` on ``device``: its part of a given tape, or its production
    draws (``stream`` keys a chain shard's own streams; None where the
    chains are not split)."""
    if tape is not None:
        t = tape.select(rows, chains, device)
    else:
        t = draw_tape(packed, cfg, device, rows=rows,
                      chains=chains.stop - chains.start, stream=stream)
    return (t, *_init_chains(packed, cfg, t, device, rows, chains.start))


def _goal_arrays(goals: Sequence[Goal], padded: int, device):
    """Per-tenant objective weights as (padded,) f32 tensors. Deadlines are
    (deadline, weight) pairs with weight 0 when the goal carries no finite
    deadline; the hinge term then contributes an exact 0.0."""
    w, dl, dlw = [], [], []
    for g in goals:
        w.append(g.w)
        sla = math.isfinite(g.deadline) and g.deadline_weight > 0
        dl.append(g.deadline if sla else 0.0)
        dlw.append(g.deadline_weight if sla else 0.0)
    pad = padded - len(goals)
    w += [0.5] * pad
    dl += [0.0] * pad
    dlw += [0.0] * pad
    return (_t(w, FLOAT, device), _t(dl, FLOAT, device),
            _t(dlw, FLOAT, device))


def _pad_refs(ref_M: np.ndarray, ref_C: np.ndarray, padded: int):
    """Bucket-padding problems get dummy (1, 1) reference points: their
    energy is the constant -1 for every chain, so they shift nothing."""
    pad = padded - len(ref_M)
    return (np.concatenate([ref_M, np.ones(pad)]),
            np.concatenate([ref_C, np.ones(pad)]))


def _attach_telemetry(sols: List[Solution], state, cfg: VecConfig) -> None:
    """Hand each Solution its problem's row of the strided convergence
    trace (bucket-padding rows are dropped with the padding problems)."""
    if not cfg.telemetry or "tel_best_e" not in state:
        return
    steps = _telemetry_steps(cfg.iters, cfg.telemetry_every)
    best = state["tel_best_e"].cpu().numpy()
    acc = state["tel_accept"].cpu().numpy()
    mig = np.asarray(state["tel_mig"])
    for p, sol in enumerate(sols):
        sol.telemetry = dict(steps=steps.copy(), best_e=best[p],
                             accept=acc[p], migrations=mig[p],
                             iters=cfg.iters, chains=cfg.chains)


def _solve_inputs(problems, cluster, goal, refs, goals):
    problems = list(problems)
    if refs is None:
        from repro_torch.core.annealer import reference_point
        refs = [reference_point(p, cluster) for p in problems]
    refs = list(refs)
    if len(refs) != len(problems):
        raise ValueError(f"{len(refs)} refs for {len(problems)} problems")
    goals = list(goals) if goals is not None else [goal] * len(problems)
    if len(goals) != len(problems):
        raise ValueError(f"{len(goals)} goals for {len(problems)} problems")
    ref_M = np.asarray([r[0] for r in refs])
    ref_C = np.asarray([r[1] for r in refs])
    return problems, goals, ref_M, ref_C


def _check_tape(packed: PackedProblems, cfg: VecConfig, tape) -> None:
    if tape is not None:
        tape.check(packed.padded_problems, cfg.chains, packed.max_tasks,
                   cfg.iters)


def vectorized_anneal_many(problems: Sequence[FlatProblem], cluster: Cluster,
                           goal: Goal, cfg: Optional[VecConfig] = None,
                           refs: Optional[Sequence[Tuple[float, float]]] = None,
                           goals: Optional[Sequence[Goal]] = None,
                           bucket_p=None, mesh=None, *, device=None,
                           tape: Optional[DrawTape] = None,
                           spans: Optional[list] = None) -> List[Solution]:
    """Anneal P independent problems in one batched device solve.

    Returns one ``Solution`` per problem, each re-evaluated event-exactly on
    the host. ``refs`` are per-problem (makespan, cost) reference points
    (computed with the default scheduler when omitted); ``goals`` gives each
    tenant its own objective; ``bucket_p`` pads the problem axis to a
    power-of-two bucket. ``tape`` replaces the production draws (the tests
    replay the reference's through it). ``spans`` (a list) receives the
    solve's phases: ``engine.pack``, ``engine.build``, ``engine.sa_loop``,
    ``engine.readback`` and ``engine.reeval``, under ``engine.solve``.

    ``mesh`` (a (prob, chain) planner mesh, ``launch.mesh.
    make_planner_mesh``; a 1-D chains mesh counts as one row) shards the
    solve over its devices, which replace ``device``: problems over the
    first axis, chains over the second. The problem axis is bucketed up to
    the mesh. A chain axis of 1 gives the unsharded solve's plans bit for
    bit; with more, each chain shard draws from its own streams, and a
    given ``tape`` is split by shard, which again gives the unsharded
    solve's plans.
    """
    cfg = cfg or VecConfig()
    grid = _device_grid(mesh, device)
    home = grid[0, 0]
    t_start = time.monotonic()
    with span(spans, "engine.pack", "engine.solve"):
        problems, goals, ref_M, ref_C = _solve_inputs(problems, cluster, goal,
                                                      refs, goals)
        if mesh is not None:
            # power-of-two device counts divide the power-of-two bucket,
            # and padded problems are inert, so meshing never changes the
            # plans
            bucket_p = max(int(bucket_p or 1), grid.shape[0])
        packed = pack_problems(problems, cluster.num_resources,
                               bucket_p=bucket_p)
    with span(spans, "engine.build", "engine.solve"):
        P_pad = packed.padded_problems
        _check_tape(packed, cfg, tape)
        ref_Mp, ref_Cp = _pad_refs(ref_M, ref_C, P_pad)
        weights = (*_goal_arrays(goals, P_pad, home), _t(ref_Mp, FLOAT, home),
                   _t(ref_Cp, FLOAT, home))
        bdp = BatchedDeviceProblem.build(packed, cluster, ref_Mp, cfg, home)
        chain_blocks = _split(cfg.chains, grid.shape[1], "chains")
        shards = []
        for i, rows in enumerate(_split(P_pad, grid.shape[0], "problems")):
            row = []
            for c, chains in enumerate(chain_blocks):
                dev = grid[i, c]
                goal_w, dl, dl_w, rM, rC = (x[rows].to(dev) for x in weights)
                energy_fn = partial(chain_energy, bdp.select(rows, dev),
                                    goal_w, rM, rC, dl, dl_w,
                                    use_kernel=cfg.use_kernel)
                t, opt0, prio0 = _shard_inputs(
                    packed, cfg, dev, tape, rows, chains,
                    c if len(chain_blocks) > 1 else None)
                row.append((energy_fn, opt0, prio0, t))
            shards.append(row)
        _note_signature("isolated", packed, cfg, grid)
    with span(spans, "engine.sa_loop", "engine.solve"):
        state = _sa_loop(shards, cfg, shared=False)

    with span(spans, "engine.readback", "engine.solve"):
        best_idx = state["best_e"].argmin(dim=1).cpu().numpy()     # (P,)
        best_opt = state["best_opt"].cpu().numpy()                  # (P, B, J)
        best_prio = state["best_prio"].cpu().numpy()
    elapsed = time.monotonic() - t_start

    sols = []
    with span(spans, "engine.reeval", "engine.solve"):
        for p, prob in enumerate(problems):
            Jp = prob.num_tasks
            oi = best_opt[p, best_idx[p], :Jp].astype(np.int64)
            pr = best_prio[p, best_idx[p], :Jp].astype(np.float64)
            # event-exact re-evaluation on the host (removes grid
            # quantization)
            dur, dem = prob.chosen_options(oi)
            start, finish = sgs_schedule(prob, oi, priority=pr,
                                         caps=cluster.caps, durations=dur,
                                         demands=dem)
            cost = schedule_cost(prob, oi, cluster.prices_per_sec, dur, dem)
            mk = float(finish.max())
            sol = Solution(oi, start, finish, mk, cost,
                           goals[p].energy(mk, cost, ref_M[p], ref_C[p]),
                           solver="agora-vectorized-many")
            sol.solve_seconds = elapsed   # batch wall time: one solve, all P
            sols.append(sol)
    _attach_telemetry(sols, state, cfg)
    return sols


# ---------------------------------------------------------------------------
# Shared-capacity co-scheduling: P tenants coupled through ONE usage tensor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SharedDeviceProblem:
    """Device tensors for shared-capacity co-scheduling: the P padded
    problems flattened block-diagonally (core/dag.SharedCapacityLayout)
    into ONE joint DeviceProblem of P*Jmax slots whose decode accumulates
    every tenant's demands into the same (T, M) usage. A single grid
    resolution ``dt`` (from the joint reference makespan) spans all
    tenants, because a shared usage tensor needs one shared time base."""
    dp: DeviceProblem       # flattened joint instance, J' = P * Jmax slots
    P: int
    J: int                  # Jmax (padded per-problem slot count)
    n_real: torch.Tensor    # (P,) int32 — real task count per problem

    @classmethod
    def build(cls, layout: SharedCapacityLayout, cluster: Cluster,
              joint_ref_makespan: float, cfg: VecConfig,
              device=None) -> "SharedDeviceProblem":
        device = resolve_device(device)
        dur = layout.durations                                # (N, O) f64
        horizon = max(joint_ref_makespan * cfg.horizon_slack, dur.max() * 2.0)
        dt = horizon / cfg.grid
        bins = np.ceil(dur / dt).astype(np.int32)
        dur_bins = np.where(layout.slot_mask[:, None],
                            np.maximum(bins, 1), 0)
        dp = DeviceProblem(
            dur_bins=_t(dur_bins, INT, device),
            demands=_t(layout.demands, FLOAT, device),
            costs=_t(layout.costs, FLOAT, device),
            n_opts=_t(layout.n_opts, INT, device),
            pred_mask=_t(layout.pred_mask, torch.bool, device),
            release_bins=_t(np.ceil(layout.release / dt), INT, device),
            caps=_t(cluster.caps, FLOAT, device),
            # f32-rounded so the makespan scaling matches the isolated path
            # (which stores per-problem dt as f32) bit-for-bit
            dt=float(np.float32(dt)), T=cfg.grid)
        packed = layout.packed
        return cls(dp, packed.num_problems, packed.max_tasks,
                   _t(packed.num_tasks, INT, device))

    def to(self, device) -> "SharedDeviceProblem":
        """The same problem on ``device`` (itself where it lies there)."""
        dp = self.dp
        return SharedDeviceProblem(
            DeviceProblem(**{f.name: (getattr(dp, f.name).to(device)
                                      if f.name not in ("dt", "T")
                                      else getattr(dp, f.name))
                             for f in dataclasses.fields(dp)}),
            self.P, self.J, self.n_real.to(device))


def shared_chain_energy(sdp: SharedDeviceProblem, goal_w, ref_M, ref_C,
                        dl, dl_w, option_idx, priority, *, use_kernel=None):
    """option_idx/priority (P, B, J) -> per-tenant (energy, makespan,
    cost), each (P, B), every chain priced by ONE joint decode of all
    P*Jmax slots against the shared usage tensor: a tenant's feasible
    windows shrink by exactly the capacity its competitors' current
    configurations consume."""
    P_n, B, J = option_idx.shape
    flat_o = option_idx.transpose(0, 1).reshape(B, P_n * J)
    flat_p = priority.transpose(0, 1).reshape(B, P_n * J)
    _, finish, ok = decode_schedule_batch(sdp.dp, flat_o, flat_p,
                                          use_kernel=use_kernel)
    mk = finish.reshape(B, P_n, J).amax(dim=2).T.to(FLOAT) * sdp.dp.dt
    Jtot = sdp.dp.costs.shape[0]
    cost = sdp.dp.costs[torch.arange(Jtot, device=flat_o.device)[None, :],
                        flat_o.to(INDEX)].reshape(B, P_n, J).sum(dim=2).T
    infeas = (~ok.reshape(B, P_n, J)).sum(dim=2).T
    return _energy(goal_w, ref_M, ref_C, dl, dl_w, mk, cost, infeas), mk, cost


def _sa_scan_shared(sdp: SharedDeviceProblem, goal_w, ref_M, ref_C,
                    dl, dl_w, cfg: VecConfig, opt0, prio0, tape: DrawTape):
    """Coupled-batch SA: the P tenants keep their own chains, moves and
    accept decisions (the same tape rows as the isolated engine, so the
    disjoint-capacity case reproduces isolated trajectories bit-for-bit),
    but chain b's energies come from decoding ALL P problems' chain-b
    states jointly. Also tracks, per chain, the best COHERENT joint
    snapshot (minimum summed tenant energy of a proposal that was actually
    evaluated together)."""
    energy_fn = partial(shared_chain_energy, sdp, goal_w, ref_M, ref_C,
                        dl, dl_w, use_kernel=cfg.use_kernel)
    return _sa_loop([[(energy_fn, opt0, prio0, tape)]], cfg, shared=True)


def vectorized_anneal_shared(problems: Sequence[FlatProblem], cluster: Cluster,
                             goal: Goal, cfg: Optional[VecConfig] = None,
                             refs: Optional[Sequence[Tuple[float, float]]] = None,
                             goals: Optional[Sequence[Goal]] = None,
                             bucket_p=None, mesh=None, *, device=None,
                             tape: Optional[DrawTape] = None,
                             spans: Optional[list] = None
                             ) -> Tuple[List[Solution], List[str]]:
    """Anneal P tenant problems against ONE shared cluster capacity.

    Every chain decodes all P problems into a single cluster-wide usage
    tensor, so the solver prices cross-tenant contention during the search.
    The picked assembly is re-evaluated event-exactly on the host with ONE
    joint serial-SGS pass under the global caps. Returns ``(solutions,
    joint_errors)``; ``joint_errors`` is the event-exact joint validation.
    ``spans`` receives the solve's phases, as ``vectorized_anneal_many``'s.

    ``mesh`` (the planner mesh) shards the CHAIN axis over its second axis
    and runs on the devices of its first row: the coupled decode is joint
    over the problems, so the first axis is replicated, as in the
    reference. A chain axis of 1 gives the unsharded solve's plans bit for
    bit; with more, each chain shard draws from its own streams, or from
    its part of a given ``tape``.
    """
    cfg = cfg or VecConfig()
    grid = _device_grid(mesh, device)
    home = grid[0, 0]
    t_start = time.monotonic()
    from repro_torch.core.annealer import reference_point
    with span(spans, "engine.pack", "engine.solve"):
        problems, goals, ref_M, ref_C = _solve_inputs(problems, cluster, goal,
                                                      refs, goals)
        packed = pack_problems(problems, cluster.num_resources,
                               shared_capacity=True, bucket_p=bucket_p)
        _check_tape(packed, cfg, tape)
        layout = packed.shared_layout()
        joint = layout.joint_problem()
    with span(spans, "engine.build", "engine.solve"):
        joint_ref = reference_point(joint, cluster)
        sdp = SharedDeviceProblem.build(layout, cluster, joint_ref[0], cfg,
                                        home)
        P_pad = packed.padded_problems
        ref_Mp, ref_Cp = _pad_refs(ref_M, ref_C, P_pad)
        goal_w, dl, dl_w = _goal_arrays(goals, P_pad, home)
        ref_Mt, ref_Ct = _t(ref_Mp, FLOAT, home), _t(ref_Cp, FLOAT, home)
        chain_blocks = _split(cfg.chains, grid.shape[1], "chains")
        row = []
        for c, chains in enumerate(chain_blocks):
            dev = grid[0, c]
            energy_fn = partial(shared_chain_energy, sdp.to(dev),
                                *(x.to(dev) for x in (goal_w, ref_Mt, ref_Ct,
                                                      dl, dl_w)),
                                use_kernel=cfg.use_kernel)
            t, opt0, prio0 = _shard_inputs(
                packed, cfg, dev, tape, slice(None), chains,
                c if len(chain_blocks) > 1 else None)
            row.append((energy_fn, opt0, prio0, t))
        _note_signature("shared", packed, cfg, grid[:1])
    with span(spans, "engine.sa_loop", "engine.solve"):
        state = _sa_loop([row], cfg, shared=True)

    # two candidate assemblies, both spanning the full padded batch:
    # (a) selfish — each tenant's best chain; (b) coherent — the best full
    # joint snapshot any chain proposed. A fresh coupled evaluation of both
    # decides; the strict "<" keeps (a) on ties, which is what keeps the
    # disjoint case equal to isolated mode.
    with span(spans, "engine.readback", "engine.solve"):
        pp = torch.arange(P_pad, device=home)
        best_idx = state["best_e"].argmin(dim=1)                    # (P',)
        opt_self = state["best_opt"][pp, best_idx]                  # (P', J)
        prio_self = state["best_prio"][pp, best_idx]
        b_star = state["jbest_sum"].argmin()
        opt_coh = state["jbest_opt"][:, b_star]
        prio_coh = state["jbest_prio"][:, b_star]
        e2, _, _ = shared_chain_energy(
            sdp, goal_w, ref_Mt, ref_Ct, dl, dl_w,
            torch.stack([opt_self, opt_coh], dim=1),            # (P', 2, J)
            torch.stack([prio_self, prio_coh], dim=1),
            use_kernel=cfg.use_kernel)
        sums = e2.sum(dim=0).cpu().numpy()                          # (2,)
        pick_opt, pick_prio = ((opt_coh, prio_coh) if sums[1] < sums[0]
                               else (opt_self, prio_self))
        opt_pick, prio_pick = pick_opt.cpu().numpy(), pick_prio.cpu().numpy()

    with span(spans, "engine.reeval", "engine.solve"):
        # re-evaluate the winning assembly event-exactly with ONE host SGS
        # pass under the global capacity
        oi_joint = np.concatenate(
            [opt_pick[p, :pr.num_tasks]
             for p, pr in enumerate(problems)]).astype(np.int64)
        pr_joint = np.concatenate(
            [prio_pick[p, :pr.num_tasks]
             for p, pr in enumerate(problems)]).astype(np.float64)
        dur, dem = joint.chosen_options(oi_joint)
        start, finish = sgs_schedule(joint, oi_joint, priority=pr_joint,
                                     caps=cluster.caps, durations=dur,
                                     demands=dem)
        elapsed = time.monotonic() - t_start

        sols: List[Solution] = []
        ois, starts, finishes = [], [], []
        off = 0
        for p, prob in enumerate(problems):
            Jp = prob.num_tasks
            oi = oi_joint[off:off + Jp]
            s, f = start[off:off + Jp], finish[off:off + Jp]
            cost = schedule_cost(prob, oi, cluster.prices_per_sec,
                                 dur[off:off + Jp], dem[off:off + Jp])
            mk = float(f.max())
            sol = Solution(oi, s, f, mk, cost,
                           goals[p].energy(mk, cost, ref_M[p], ref_C[p]),
                           solver="agora-vectorized-shared")
            sol.solve_seconds = elapsed   # batch wall time: one coupled solve
            sols.append(sol)
            ois.append(oi), starts.append(s), finishes.append(f)
            off += Jp
        joint_errors = validate_schedule_many(problems, ois, starts, finishes,
                                              cluster.caps)
    _attach_telemetry(sols, state, cfg)
    return sols, joint_errors


def vectorized_anneal(problem: FlatProblem, cluster: Cluster, goal: Goal,
                      cfg: Optional[VecConfig] = None,
                      ref: Optional[Tuple[float, float]] = None,
                      mesh=None, *, device=None) -> Solution:
    """Single-problem solve: the P=1 case of ``vectorized_anneal_many``.
    A 1-D chains mesh (``launch.mesh.make_solver_mesh``) shards the chains
    over all its devices, with the exact replica exchange between them;
    each shard draws from its own streams (the reference gives every shard
    one key)."""
    refs = None if ref is None else [ref]
    sol = vectorized_anneal_many([problem], cluster, goal, cfg, refs,
                                 mesh=mesh, device=device)[0]
    sol.solver = "agora-vectorized"
    return sol


# ---------------------------------------------------------------------------
# Engine registration (device paths; the sequential host engine registers
# in core/agora.py, the other side of this boundary)
# ---------------------------------------------------------------------------


def _isolated_engine(batch: SolveBatch):
    sols = vectorized_anneal_many(batch.problems, batch.cluster, batch.goal,
                                  batch.cfg, batch.refs, goals=batch.goals,
                                  bucket_p=batch.bucket_p, mesh=batch.mesh,
                                  device=batch.device, spans=batch.spans)
    return sols, None


def _shared_engine(batch: SolveBatch):
    return vectorized_anneal_shared(batch.problems, batch.cluster, batch.goal,
                                    batch.cfg, batch.refs, goals=batch.goals,
                                    bucket_p=batch.bucket_p, mesh=batch.mesh,
                                    device=batch.device, spans=batch.spans)


register_engine("isolated", _isolated_engine,
                cache_size=lambda: len(_SIGNATURES["isolated"]))
register_engine("shared", _shared_engine,
                cache_size=lambda: len(_SIGNATURES["shared"]))
