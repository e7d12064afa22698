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
M, cfg, device) signatures it has run, so ``PlannerSession.stats`` keeps
its meaning and warm traffic adds nothing.

Every random number of a solve comes from one ``DrawTape`` computed before
the sweep loop, keyed per problem (see ``draw_tape``). The tests replay
the reference's ``jax.random`` draws through the same seam.

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

_SQRT_HALF = float(np.float32(math.sqrt(0.5)))

NOT_PORTED = "is not ported to PyTorch yet (see ROADMAP.md, Queue 1)"


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
                    device: torch.device) -> None:
    _SIGNATURES[engine].add((packed.padded_problems, packed.max_tasks,
                             packed.durations.shape[2], packed.num_resources,
                             cfg, str(device)))


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"mesh-sharded solving {NOT_PORTED}")


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

    def check(self, P: int, B: int, J: int, iters: int) -> None:
        want = dict(rand_opt=(P, B, J), prio0=(P, B, J))
        want.update({k: (iters, P, B)
                     for k in ("j_opt", "new_o", "j_pr", "jitter", "u")})
        for k, shape in want.items():
            got = tuple(getattr(self, k).shape)
            if got != shape:
                raise ValueError(f"draw tape {k} has shape {got}, this solve "
                                 f"needs {shape}")


def _problem_generator(seed: int, p: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, p])
                      .generate_state(1, np.uint64)[0]))
    return g


def draw_tape(packed: PackedProblems, cfg: VecConfig, device) -> DrawTape:
    """The production tape: problem p's draws come from its own generator
    on the device, seeded from (cfg.seed, p) — never from a bulk (P, ...)
    draw — so problem p's stream does not depend on how many problems
    share the batch. That keying is what makes a bucket-padded batch
    reproduce an unbucketed one bit-for-bit (the counterpart of the
    reference's per-problem ``fold_in(k, p)``)."""
    P_pad, J = packed.task_mask.shape
    B, n = cfg.chains, cfg.iters
    parts: Dict[str, list] = {k: [] for k in DrawTape._DTYPES}
    for p in range(P_pad):
        g = _problem_generator(cfg.seed, p, device)
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


def _sa_loop(energy_fn, cfg: VecConfig, opt0, prio0, tape: DrawTape, *,
             shared: bool):
    """Run cfg.iters SA sweeps over (P, B, J) chain states.

    Each problem keeps its own chains, proposals and accept decisions, read
    from its rows of the tape. ``shared`` adds the coupled engine's coherent
    joint-best tracking and, with ``cfg.joint_accept``, one Metropolis
    verdict per chain on the summed energy delta. Nothing inside the loop
    syncs with the host: the temperature and the migration schedule are
    host numbers fixed by the config."""
    P_n, B, _ = opt0.shape
    dev = opt0.device
    pidx = torch.arange(P_n, device=dev)[:, None]
    bidx = torch.arange(B, device=dev)[None, :]
    e0 = energy_fn(opt0, prio0)[0]
    opt, prio, e = opt0, prio0, e0
    best_opt, best_prio, best_e = opt0, prio0, e0
    jbest = (opt0, prio0, e0.sum(dim=0)) if shared else None
    temp = np.float32(cfg.t0)
    sigma = _jitter_scale(cfg.prio_sigma)
    trace = []
    for it in range(cfg.iters):
        # propose: mutate one task's option; jitter one task's priority
        j_opt, j_pr = tape.j_opt[it], tape.j_pr[it]
        p_opt = opt.clone()
        p_opt[pidx, bidx, j_opt] = tape.new_o[it]
        p_prio = prio.clone()
        p_prio[pidx, bidx, j_pr] = (prio[pidx, bidx, j_pr]
                                    + tape.jitter[it] * sigma)
        p_e = energy_fn(p_opt, p_prio)[0]

        if shared:
            # joint-best update on the PROPOSAL (a coherent state whose
            # energies were just computed together), before per-tenant
            # accepts mix proposals into per-tenant states
            prop_sum = p_e.sum(dim=0)                                # (B,)
            jb = prop_sum < jbest[2]
            jbest = (torch.where(jb[None, :, None], p_opt, jbest[0]),
                     torch.where(jb[None, :, None], p_prio, jbest[1]),
                     torch.where(jb, prop_sum, jbest[2]))

        dE = p_e - e
        t_eff = float(max(temp, np.float32(1e-9)))
        if shared and cfg.joint_accept:
            # joint welfare: one verdict per chain on the summed delta,
            # drawn from tenant 0's uniform stream, applied to all tenants
            dE_sum = dE.sum(dim=0)
            acc = (dE_sum < 0) | (torch.exp(-dE_sum / t_eff) > tape.u[it, 0])
            accept = acc[None, :].expand(P_n, B)
        else:
            accept = (dE < 0) | (torch.exp(-dE / t_eff) > tape.u[it])
        opt = torch.where(accept[:, :, None], p_opt, opt)
        prio = torch.where(accept[:, :, None], p_prio, prio)
        e = torch.where(accept, p_e, e)

        better = e < best_e
        best_opt = torch.where(better[:, :, None], opt, best_opt)
        best_prio = torch.where(better[:, :, None], prio, best_prio)
        best_e = torch.where(better, e, best_e)

        do_mig = it % cfg.migrate_every == cfg.migrate_every - 1
        if do_mig:
            opt, prio, e = _migrate_chains(opt, prio, e, best_opt,
                                           best_prio, best_e)
        if cfg.telemetry:
            trace.append((best_e.amin(dim=1),
                          accept.to(FLOAT).mean(dim=1), int(do_mig)))
        temp = np.float32(temp * np.float32(cfg.cooling))

    state = dict(opt=opt, prio=prio, e=e, best_opt=best_opt,
                 best_prio=best_prio, best_e=best_e)
    if shared:
        state.update(jbest_opt=jbest[0], jbest_prio=jbest[1],
                     jbest_sum=jbest[2])
    if cfg.telemetry:
        idx = _telemetry_steps(cfg.iters, cfg.telemetry_every)
        mig = np.cumsum([m for _, _, m in trace])[idx]
        state.update(
            tel_best_e=torch.stack([b for b, _, _ in trace], dim=1)[:, idx],
            tel_accept=torch.stack([a for _, a, _ in trace], dim=1)[:, idx],
            tel_mig=np.broadcast_to(mig[None, :], (P_n, len(idx))))
    return state


def _sa_scan(bdp: BatchedDeviceProblem, goal_w, ref_M, ref_C, dl, dl_w,
             cfg: VecConfig, opt0, prio0, tape: DrawTape):
    """Isolated SA over P independent problems x B chains; each problem's
    mutation targets are bounded by its real-task count through the tape
    (fully masked bucket-padding problems mutate their inert slot 0)."""
    energy_fn = partial(chain_energy, bdp, goal_w, ref_M, ref_C, dl, dl_w,
                        use_kernel=cfg.use_kernel)
    return _sa_loop(energy_fn, cfg, opt0, prio0, tape, shared=False)


_MASKED_PRIO = -1e9   # below any real priority, above the -inf sentinel


def _init_chains(packed: PackedProblems, cfg: VecConfig, tape: DrawTape,
                 device):
    """Initial chain states (P, B, J) for both batched engines: even chains
    start from the default configuration, odd ones from random options;
    priorities are jittered, masked slots pinned to ``_MASKED_PRIO``."""
    P_n, J = packed.task_mask.shape
    B = cfg.chains
    n_opts = _t(packed.n_opts, INT, device)
    defaults = _t(packed.default_option, INT, device)           # (P, J)
    opt0 = defaults[:, None, :].expand(P_n, B, J)
    rand_opt = tape.rand_opt % n_opts[:, None, :]
    even = (torch.arange(B, device=device) % 2 == 0)[None, :, None]
    opt0 = torch.where(even, opt0, rand_opt)
    prio0 = tape.prio0 * cfg.prio_sigma
    prio0 = torch.where(_t(packed.task_mask, torch.bool, device)[:, None, :],
                        prio0, _MASKED_PRIO)
    return opt0, prio0


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


def _tape_for(packed: PackedProblems, cfg: VecConfig, tape, device):
    if tape is None:
        return draw_tape(packed, cfg, device)
    tape.check(packed.padded_problems, cfg.chains, packed.max_tasks,
               cfg.iters)
    return tape


def vectorized_anneal_many(problems: Sequence[FlatProblem], cluster: Cluster,
                           goal: Goal, cfg: Optional[VecConfig] = None,
                           refs: Optional[Sequence[Tuple[float, float]]] = None,
                           goals: Optional[Sequence[Goal]] = None,
                           bucket_p=None, mesh=None, *, device=None,
                           tape: Optional[DrawTape] = None) -> List[Solution]:
    """Anneal P independent problems in one batched device solve.

    Returns one ``Solution`` per problem, each re-evaluated event-exactly on
    the host. ``refs`` are per-problem (makespan, cost) reference points
    (computed with the default scheduler when omitted); ``goals`` gives each
    tenant its own objective; ``bucket_p`` pads the problem axis to a
    power-of-two bucket. ``tape`` replaces the production draws (the tests
    replay the reference's through it); ``mesh`` is not ported yet.
    """
    _no_mesh(mesh)
    device = resolve_device(device)
    cfg = cfg or VecConfig()
    t_start = time.monotonic()
    problems, goals, ref_M, ref_C = _solve_inputs(problems, cluster, goal,
                                                  refs, goals)
    packed = pack_problems(problems, cluster.num_resources, bucket_p=bucket_p)
    P_pad = packed.padded_problems
    ref_Mp, ref_Cp = _pad_refs(ref_M, ref_C, P_pad)
    goal_w, dl, dl_w = _goal_arrays(goals, P_pad, device)
    bdp = BatchedDeviceProblem.build(packed, cluster, ref_Mp, cfg, device)
    tape = _tape_for(packed, cfg, tape, device)
    opt0, prio0 = _init_chains(packed, cfg, tape, device)
    _note_signature("isolated", packed, cfg, device)
    state = _sa_scan(bdp, goal_w, _t(ref_Mp, FLOAT, device),
                     _t(ref_Cp, FLOAT, device), dl, dl_w, cfg, opt0, prio0,
                     tape)

    best_idx = state["best_e"].argmin(dim=1).cpu().numpy()         # (P,)
    best_opt = state["best_opt"].cpu().numpy()                      # (P, B, J)
    best_prio = state["best_prio"].cpu().numpy()
    elapsed = time.monotonic() - t_start

    sols = []
    for p, prob in enumerate(problems):
        Jp = prob.num_tasks
        oi = best_opt[p, best_idx[p], :Jp].astype(np.int64)
        pr = best_prio[p, best_idx[p], :Jp].astype(np.float64)
        # event-exact re-evaluation on the host (removes grid quantization)
        start, finish = sgs_schedule(prob, oi, priority=pr, caps=cluster.caps)
        cost = schedule_cost(prob, oi, cluster.prices_per_sec)
        mk = float(finish.max())
        sol = Solution(oi, start, finish, mk, cost,
                       goals[p].energy(mk, cost, ref_M[p], ref_C[p]),
                       solver="agora-vectorized-many")
        sol.solve_seconds = elapsed   # batch wall time: one solve for all P
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
    return _sa_loop(energy_fn, cfg, opt0, prio0, tape, shared=True)


def vectorized_anneal_shared(problems: Sequence[FlatProblem], cluster: Cluster,
                             goal: Goal, cfg: Optional[VecConfig] = None,
                             refs: Optional[Sequence[Tuple[float, float]]] = None,
                             goals: Optional[Sequence[Goal]] = None,
                             bucket_p=None, mesh=None, *, device=None,
                             tape: Optional[DrawTape] = None
                             ) -> Tuple[List[Solution], List[str]]:
    """Anneal P tenant problems against ONE shared cluster capacity.

    Every chain decodes all P problems into a single cluster-wide usage
    tensor, so the solver prices cross-tenant contention during the search.
    The picked assembly is re-evaluated event-exactly on the host with ONE
    joint serial-SGS pass under the global caps. Returns ``(solutions,
    joint_errors)``; ``joint_errors`` is the event-exact joint validation.
    """
    _no_mesh(mesh)
    device = resolve_device(device)
    cfg = cfg or VecConfig()
    t_start = time.monotonic()
    from repro_torch.core.annealer import reference_point
    problems, goals, ref_M, ref_C = _solve_inputs(problems, cluster, goal,
                                                  refs, goals)
    packed = pack_problems(problems, cluster.num_resources,
                           shared_capacity=True, bucket_p=bucket_p)
    layout = packed.shared_layout()
    joint = layout.joint_problem()
    joint_ref = reference_point(joint, cluster)
    sdp = SharedDeviceProblem.build(layout, cluster, joint_ref[0], cfg, device)
    P_pad = packed.padded_problems
    ref_Mp, ref_Cp = _pad_refs(ref_M, ref_C, P_pad)
    goal_w, dl, dl_w = _goal_arrays(goals, P_pad, device)
    ref_Mt, ref_Ct = _t(ref_Mp, FLOAT, device), _t(ref_Cp, FLOAT, device)
    tape = _tape_for(packed, cfg, tape, device)
    opt0, prio0 = _init_chains(packed, cfg, tape, device)
    _note_signature("shared", packed, cfg, device)
    state = _sa_scan_shared(sdp, goal_w, ref_Mt, ref_Ct, dl, dl_w, cfg,
                            opt0, prio0, tape)

    # two candidate assemblies, both spanning the full padded batch:
    # (a) selfish — each tenant's best chain; (b) coherent — the best full
    # joint snapshot any chain proposed. A fresh coupled evaluation of both
    # decides; the strict "<" keeps (a) on ties, which is what keeps the
    # disjoint case equal to isolated mode.
    pp = torch.arange(P_pad, device=device)
    best_idx = state["best_e"].argmin(dim=1)                        # (P',)
    opt_self = state["best_opt"][pp, best_idx]                      # (P', J)
    prio_self = state["best_prio"][pp, best_idx]
    b_star = state["jbest_sum"].argmin()
    opt_coh = state["jbest_opt"][:, b_star]
    prio_coh = state["jbest_prio"][:, b_star]
    e2, _, _ = shared_chain_energy(
        sdp, goal_w, ref_Mt, ref_Ct, dl, dl_w,
        torch.stack([opt_self, opt_coh], dim=1),                    # (P', 2, J)
        torch.stack([prio_self, prio_coh], dim=1),
        use_kernel=cfg.use_kernel)
    sums = e2.sum(dim=0).cpu().numpy()                              # (2,)
    pick_opt, pick_prio = ((opt_coh, prio_coh) if sums[1] < sums[0]
                           else (opt_self, prio_self))
    opt_pick, prio_pick = pick_opt.cpu().numpy(), pick_prio.cpu().numpy()

    # re-evaluate the winning assembly event-exactly with ONE host SGS pass
    # under the global capacity
    oi_joint = np.concatenate(
        [opt_pick[p, :pr.num_tasks]
         for p, pr in enumerate(problems)]).astype(np.int64)
    pr_joint = np.concatenate(
        [prio_pick[p, :pr.num_tasks]
         for p, pr in enumerate(problems)]).astype(np.float64)
    start, finish = sgs_schedule(joint, oi_joint, priority=pr_joint,
                                 caps=cluster.caps)
    elapsed = time.monotonic() - t_start

    sols: List[Solution] = []
    ois, starts, finishes = [], [], []
    off = 0
    for p, prob in enumerate(problems):
        Jp = prob.num_tasks
        oi = oi_joint[off:off + Jp]
        s, f = start[off:off + Jp], finish[off:off + Jp]
        cost = schedule_cost(prob, oi, cluster.prices_per_sec)
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
    """Single-problem solve: the P=1 case of ``vectorized_anneal_many``."""
    _no_mesh(mesh)
    refs = None if ref is None else [ref]
    sol = vectorized_anneal_many([problem], cluster, goal, cfg, refs,
                                 device=device)[0]
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
                                  device=batch.device)
    return sols, None


def _shared_engine(batch: SolveBatch):
    return vectorized_anneal_shared(batch.problems, batch.cluster, batch.goal,
                                    batch.cfg, batch.refs, goals=batch.goals,
                                    bucket_p=batch.bucket_p, mesh=batch.mesh,
                                    device=batch.device)


register_engine("isolated", _isolated_engine,
                cache_size=lambda: len(_SIGNATURES["isolated"]))
register_engine("shared", _shared_engine,
                cache_size=lambda: len(_SIGNATURES["shared"]))
