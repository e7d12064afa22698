"""Direct penalized-energy annealer ("Ising-form" solver), PyTorch port of
the JAX package's ``core/ising.py``.

The state is the raw (configuration, start-time) assignment of B chains;
precedence and capacity constraints enter as penalty terms; the batched
energy is ``kernels.ops.schedule_objective``, whose capacity term is the
``sched_violation`` CUDA kernel on the card (its plain PyTorch version on
the CPU). No serial schedule construction anywhere in the hot loop: every
move of every chain is evaluated in parallel.

Every random number of a solve comes from one ``IsingTape`` drawn before
the loop (no draw depends on the state); the tests replay the reference's
``jax.random`` draws through it. The loop is a Python loop of tensor ops
that never syncs with the host; the temperature stays a float32 tensor,
cooled by a float32 factor each step, as in the reference.

The best chain is repaired to an exactly-feasible schedule on the host
(start-time order becomes an SGS priority), so reported numbers are always
feasible-exact.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.cluster.catalog import Cluster
from repro_torch.core.dag import FlatProblem
from repro_torch.core.objectives import Goal, Solution
from repro_torch.core.sgs import schedule_cost, sgs_schedule
from repro_torch.device import FLOAT, INDEX, INT, resolve_device
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class IsingConfig:
    chains: int = 512
    iters: int = 1500
    grid: int = 256
    t0: float = 1.0
    cooling: float = 0.997
    seed: int = 0
    horizon_slack: float = 1.6
    lam_cap: float = 50.0
    lam_prec: float = 50.0
    # sched_violation backend (kernels/ops.py): None = by device (the CUDA
    # kernel for CUDA tensors, the plain version for CPU tensors); False
    # forces the plain version; True forces the kernel (CUDA only)
    use_kernel: Optional[bool] = None


@dataclasses.dataclass
class IsingTape:
    """Every random number of one solve, each in its final range.

    Init draws are (B, J); per-step draws are (iters, B): the task each
    chain moves (``j``), the move's kind (an option re-draw below 0.35, a
    snap to the predecessors' finish below 0.75, else a uniform start), the
    new option, the uniform start and the Metropolis uniform."""
    rnd: torch.Tensor      # (B, J) int32 random initial options < n_opts
    noise: torch.Tensor    # (B, J) f32 U[0, 1), before * 3.0
    j: torch.Tensor        # (iters, B) int64 in [0, J)
    kind: torch.Tensor     # (iters, B) f32 U[0, 1)
    new_o: torch.Tensor    # (iters, B) int32 < n_opts of task j
    rand_t: torch.Tensor   # (iters, B) f32 U[0, grid - 1)
    u: torch.Tensor        # (iters, B) f32 U[0, 1)

    _DTYPES = dict(rnd=INT, noise=FLOAT, j=INDEX, kind=FLOAT, new_o=INT,
                   rand_t=FLOAT, u=FLOAT)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device=None) -> "IsingTape":
        device = resolve_device(device)
        return cls(**{k: torch.tensor(np.asarray(arrays[k]), dtype=dt,
                                      device=device)
                      for k, dt in cls._DTYPES.items()})

    def check(self, B: int, J: int, iters: int) -> None:
        want = dict(rnd=(B, J), noise=(B, J))
        want.update({k: (iters, B)
                     for k in ("j", "kind", "new_o", "rand_t", "u")})
        for k, shape in want.items():
            got = tuple(getattr(self, k).shape)
            if got != shape:
                raise ValueError(f"ising tape {k} has shape {got}, this "
                                 f"solve needs {shape}")


def ising_tape(n_opts: np.ndarray, cfg: IsingConfig, device) -> IsingTape:
    """The production tape: one generator on the device, seeded by
    ``cfg.seed``, draws the whole solve before the loop."""
    B, n, J = cfg.chains, cfg.iters, len(n_opts)
    g = torch.Generator(device=device)
    g.manual_seed(cfg.seed)
    kw = dict(generator=g, device=device)
    bound = torch.tensor(np.asarray(n_opts), dtype=INT, device=device)
    rnd = torch.randint(0, 1_000_000, (B, J), dtype=INT, **kw) % bound
    noise = torch.rand((B, J), dtype=FLOAT, **kw)
    j = torch.randint(0, J, (n, B), dtype=INDEX, **kw)
    kind = torch.rand((n, B), dtype=FLOAT, **kw)
    pick = torch.rand((n, B), dtype=FLOAT, **kw)
    new_o = torch.minimum((pick * bound[j]).to(INT), bound[j] - 1)
    rand_t = torch.rand((n, B), dtype=FLOAT, **kw) * float(cfg.grid - 1)
    u = torch.rand((n, B), dtype=FLOAT, **kw)
    return IsingTape(rnd=rnd, noise=noise, j=j, kind=kind, new_o=new_o,
                     rand_t=rand_t, u=u)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=FLOAT, device=device)


def _ising_loop(dur_bins, demands, costs, pred_pairs, release, caps, goal_w,
                ref_M, ref_C, opt0, start0, tape: IsingTape,
                cfg: IsingConfig):
    """The reference's ``_ising_scan``: cfg.iters steps over (B, J) chain
    states. ``dur_bins``, ``demands``, ``costs`` are (J, O), (J, O, M),
    (J, O); ``pred_pairs`` (E, 2) int64; ``goal_w``, ``ref_M``, ``ref_C``
    float32 0-d tensors."""
    B, J = opt0.shape
    dev = opt0.device
    jrow = torch.arange(J, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    succ_of = pred_pairs[None, :, 1]                                # (1, E)
    pred_of = pred_pairs[:, 0]
    p_opt, p_snap = _f32(0.35, dev), _f32(0.75, dev)

    def energy(opt, start, d):
        o = opt.to(INDEX)
        dm = demands[jrow, o].transpose(1, 2)                       # (B, M, J)
        c = costs[jrow, o].sum(dim=1)
        return kops.schedule_objective(
            start, d, dm, caps, c, pred_pairs, goal_w, ref_M, ref_C,
            T=cfg.grid, lam_cap=cfg.lam_cap, lam_prec=cfg.lam_prec,
            use_kernel=cfg.use_kernel)[0]

    opt, start = opt0, start0
    e = energy(opt0, start0, dur_bins[jrow, opt0.to(INDEX)])
    best_opt, best_start, best_e = opt, start, e
    temp, cooling = _f32(cfg.t0, dev), _f32(cfg.cooling, dev)
    for it in range(cfg.iters):
        j, kind = tape.j[it], tape.kind[it]
        # move A: re-draw the option of task j
        opt_move = kind < p_opt
        n_opt = opt.clone()
        n_opt[rows, j] = torch.where(opt_move, tape.new_o[it], opt[rows, j])
        d = dur_bins[jrow, n_opt.to(INDEX)]                         # (B, J)
        # move B: snap the start of j to max(pred finishes, release);
        # move C: a uniform start
        finish = start + d
        is_pred = succ_of == j[:, None]                             # (B, E)
        pf = torch.where(is_pred, finish[:, pred_of], 0.0).amax(dim=1)
        snap = torch.maximum(pf, release[j])
        new_start = torch.where(opt_move, start[rows, j],
                                torch.where(kind < p_snap, snap,
                                            tape.rand_t[it]))
        n_start = start.clone()
        n_start[rows, j] = new_start

        n_e = energy(n_opt, n_start, d)
        dE = n_e - e
        accept = (dE < 0) | (torch.exp(-dE / torch.clamp(temp, min=1e-9))
                             > tape.u[it])
        opt = torch.where(accept[:, None], n_opt, opt)
        start = torch.where(accept[:, None], n_start, start)
        e = torch.where(accept, n_e, e)
        better = e < best_e
        best_opt = torch.where(better[:, None], opt, best_opt)
        best_start = torch.where(better[:, None], start, best_start)
        best_e = torch.where(better, e, best_e)
        temp = temp * cooling
    return dict(opt=opt, start=start, e=e, best_opt=best_opt,
                best_start=best_start, best_e=best_e, T=temp)


def ising_anneal(problem: FlatProblem, cluster: Cluster, goal: Goal,
                 cfg: Optional[IsingConfig] = None,
                 ref: Optional[Tuple[float, float]] = None, *,
                 device=None, tape: Optional[IsingTape] = None) -> Solution:
    """Solve one problem with the penalized-energy annealer on ``device``
    (``"cuda"`` unless the caller names another). ``tape`` replaces the
    production draws (the tests pass the reference's)."""
    cfg = cfg or IsingConfig()
    device = resolve_device(device)
    t_start = time.monotonic()
    if ref is None:
        from repro_torch.core.annealer import reference_point
        ref = reference_point(problem, cluster)
    ref_M, ref_C = ref
    J = problem.num_tasks
    dur, dem, cost, n_opts = problem.option_arrays()
    horizon = max(ref_M * cfg.horizon_slack, dur.max() * 2.0)
    dt = horizon / cfg.grid
    # host arrays, rounded to float32 exactly where the reference rounds
    dur_bins = np.asarray(np.maximum(dur / dt, 1e-3), np.float32)
    # an edge-less problem gets the reference's dummy pair (0, 0): it
    # charges dur[task 0] to the precedence term; kept for parity
    pred_pairs = (np.asarray(problem.edges, np.int64).reshape(-1, 2)
                  if problem.edges else np.zeros((1, 2), np.int64))
    release = np.asarray(np.ceil(problem.release / dt), np.float32)

    B = cfg.chains
    if tape is None:
        tape = ising_tape(n_opts, cfg, device)
    tape.check(B, J, cfg.iters)
    defaults = torch.tensor([t.default_option for t in problem.tasks],
                            dtype=INT, device=device)
    even = (torch.arange(B, device=device) % 2 == 0)[:, None]
    opt0 = torch.where(even, defaults[None, :].expand(B, J), tape.rnd)
    # start init: topological prefix sums (roughly serialized) + noise
    topo = problem.as_dag().topo_order()
    s0 = np.zeros(J, np.float32)
    for i in topo:
        preds = [a for a, b in problem.edges if b == i]
        s0[i] = max([s0[a] + float(dur_bins[a, problem.tasks[a].default_option])
                     for a in preds] + [float(release[i])])
    start0 = (torch.tensor(s0, dtype=FLOAT, device=device)[None, :]
              + tape.noise * 3.0)

    def on(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    state = _ising_loop(
        on(dur_bins, FLOAT), on(dem, FLOAT), on(cost, FLOAT),
        on(pred_pairs, INDEX), on(release, FLOAT), on(cluster.caps, FLOAT),
        _f32(goal.w, device), _f32(ref_M / dt, device), _f32(ref_C, device),
        opt0, start0, tape, cfg)

    b = int(torch.argmin(state["best_e"]))          # first index on ties
    best_opt = state["best_opt"][b].cpu().numpy().astype(np.int64)
    best_start = state["best_start"][b].cpu().numpy().astype(np.float64)
    # host repair: start-time order -> SGS priority (earlier = higher)
    start, finish = sgs_schedule(problem, best_opt, priority=-best_start,
                                 caps=cluster.caps)
    mk = float(finish.max())
    cst = schedule_cost(problem, best_opt, cluster.prices_per_sec)
    sol = Solution(best_opt, start, finish, mk, cst,
                   goal.energy(mk, cst, ref_M, ref_C), solver="agora-ising")
    sol.solve_seconds = time.monotonic() - t_start
    return sol
