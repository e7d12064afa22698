"""Plain PyTorch versions of the port's kernels. They define the semantics
the CUDA kernels must reproduce, and they are what runs on the CPU.
``sgs_decode_ref`` is held to BIT-FOR-BIT equality, not tolerance: against
the JAX reference (``repro.kernels.ref.sgs_decode_ref``) in the CPU tests,
and against the CUDA kernel on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import torch

from repro_torch.device import FLOAT, INT


def as_groups(release: torch.Tensor, pred: torch.Tensor):
    """Normalise the shared per-problem arrays to the grouped form:
    release (J,) or (G, J) -> (G, J); pred (J, J) or (G, J, J) -> (G, J, J)."""
    if release.dim() == 1:
        release, pred = release[None], pred[None]
    if release.dim() != 2 or pred.dim() != 3:
        raise ValueError(f"release must be (J,) or (G, J) and pred (J, J) or "
                         f"(G, J, J); got {tuple(release.shape)} and "
                         f"{tuple(pred.shape)}")
    return release, pred


def sgs_decode_ref(dur, dem, prio, release, pred, caps, *, T: int):
    """Batched grid-SGS decode — the serial-SGS placement loop of the
    AGORA solver on a quantized time grid, with per-task option gathers
    already hoisted (dur/dem are pre-gathered per candidate).

    dur:     (B, J) int32 durations in grid bins (0 = masked no-op slot)
    dem:     (B, J, M) f32 per-task resource demands at the chosen option
    prio:    (B, J) f32 SGS priorities
    release: (J,) or (G, J) int32 release bins
    pred:    (J, J) or (G, J, J) bool; [g, j, p] = p is a predecessor of j
    caps:    (M,) f32 capacities
    T:       grid length

    Row ``b`` reads group ``b // (B // G)``, so one call decodes the chains
    of G problems (the isolated engine's problem axis, written out where
    the reference vmaps). Returns (start (B, J) int32, finish (B, J) int32,
    ok (B, J) bool). A Python loop over the J placement steps, vectorised
    over the batch: per step the highest-priority eligible task (first
    index on ties) is placed at its earliest capacity-feasible start
    (cumsum window test over the (T, M) usage, demand-masked so
    zero-demand resources never block).
    """
    release, pred = as_groups(release, pred)
    dev = dur.device
    B, J = dur.shape
    G = release.shape[0]
    if B % G:
        raise ValueError(f"{B} rows do not split into {G} groups")
    grp = torch.arange(B, device=dev) // (B // G)
    rel = release.to(INT)[grp]                                    # (B, J)
    prd = pred.to(torch.bool)[grp]                                # (B, J, J)
    dur = dur.to(INT)
    dem = dem.to(FLOAT)
    prio = prio.to(FLOAT)
    caps = caps.to(FLOAT)
    M = caps.shape[0]
    caps_eps = caps + 1e-6             # float32 + float32(1e-6), as the reference
    tgrid = torch.arange(T, dtype=INT, device=dev)[None, :]      # (1, T)
    rows = torch.arange(B, device=dev)

    usage = torch.zeros((B, T, M), dtype=FLOAT, device=dev)
    finish = torch.zeros((B, J), dtype=INT, device=dev)
    start = torch.zeros((B, J), dtype=INT, device=dev)
    scheduled = torch.zeros((B, J), dtype=torch.bool, device=dev)
    placed_ok = torch.zeros((B, J), dtype=torch.bool, device=dev)
    zero_col = torch.zeros((B, 1), dtype=INT, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=FLOAT, device=dev)
    for _ in range(J):
        eligible = (~scheduled) & ((~prd) | scheduled[:, None, :]).all(dim=2)
        score = torch.where(eligible, prio, neg_inf)
        j = score.argmax(dim=1)                                   # (B,)
        d = dur[rows, j]                                          # (B,)
        r = dem[rows, j]                                          # (B, M)
        pred_fin = torch.where(prd[rows, j], finish, 0).amax(dim=1)
        ready = torch.maximum(rel[rows, j], pred_fin)
        bad = ((usage + r[:, None, :] > caps_eps)
               & (r[:, None, :] > 0)).any(dim=2)                  # (B, T)
        cs = torch.cat([zero_col, bad.to(INT).cumsum(dim=1, dtype=INT)],
                       dim=1)                                     # (B, T+1)
        end = torch.clamp(tgrid + d[:, None], max=T)
        win_bad = cs.gather(1, end.long()) - cs[:, :T]
        ok = ((win_bad == 0) & (tgrid >= ready[:, None])
              & (tgrid + d[:, None] <= T))
        any_ok = ok.any(dim=1)
        t_star = torch.where(any_ok, ok.to(INT).argmax(dim=1).to(INT),
                             torch.maximum(ready, T - d))
        window = (tgrid >= t_star[:, None]) & (tgrid < (t_star + d)[:, None])
        usage = usage + window[:, :, None].to(FLOAT) * r[:, None, :]
        finish[rows, j] = t_star + d
        start[rows, j] = t_star
        scheduled[rows, j] = True
        placed_ok[rows, j] = any_ok
    return start, finish, placed_ok


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed order: pad with zeros to a power
    of two N, then halve, adding element k + N/2 to element k, until one
    is left. The CUDA kernels reduce in exactly this order, so the plain
    version and the kernel round alike."""
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while size > 1:
        size //= 2
        x = x[..., :size] + x[..., size:]
    return x[..., 0]


def sched_violation_ref(start, dur, dem, caps, T: int):
    """Capacity-violation mass of a batch of candidate schedules on a time
    grid — the hot spot of penalized ('Ising-form') schedule annealing.

    start, dur: (B, J) f32 or bf16 in grid units
    dem:        (B, M, J) f32 or bf16 per-task demands
    caps:       (M,) f32
    T:          grid length

    Returns viol (B,) f32: sum_t sum_m max(0, usage_btm - caps_m), with
    usage[b, m, t] = sum_j dem[b,m,j] * 1[start_bj <= t < start_bj + dur_bj]
    for the bins t < T; ``start + dur`` rounds in float32 as in the JAX
    reference (``repro/kernels/ref.py:sched_violation_ref``). Math in
    float32. The sums have a fixed order, the one the CUDA kernel uses:
    usage adds the tasks in index order (a product with the 0/1 mask is
    exact), and the violation is the ``pairwise_sum`` of the (M, T) excess
    in row-major order.
    """
    start = start.to(FLOAT)
    end = start + dur.to(FLOAT)
    dem = dem.to(FLOAT)
    B, M, J = dem.shape
    t = torch.arange(T, dtype=FLOAT, device=start.device)
    mask = ((t >= start[:, :, None])
            & (t < end[:, :, None])).to(FLOAT)                    # (B, J, T)
    usage = torch.zeros((B, M, T), dtype=FLOAT, device=start.device)
    for j in range(J):
        # the product is exact, so a fused multiply-add rounds as an add
        usage.addcmul_(dem[:, :, j, None], mask[:, None, j, :])
    over = torch.clamp(usage - caps.to(FLOAT)[None, :, None], min=0.0)
    return pairwise_sum(over.reshape(B, M * T))


def usl_runtime_ref(n, alpha, beta, gamma, work):
    """Batched USL runtime (paper Eq. 9): runtime = work / X(n) with
    X(n) = gamma * n / (1 + alpha (n-1) + beta n (n-1)). All inputs
    broadcastable to a common shape; float32 math, each operation rounded
    in the order written (the CUDA kernel's order)."""
    n, a, b, g, w = (x.to(FLOAT) for x in (n, alpha, beta, gamma, work))
    x = g * n / (1.0 + a * (n - 1.0) + b * n * (n - 1.0))
    return w / torch.clamp(x, min=1e-9)
