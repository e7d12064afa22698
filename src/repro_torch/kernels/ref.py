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
