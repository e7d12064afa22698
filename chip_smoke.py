#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each failing loudly (no phase's failure is caught):

1. build  — compile the port's three CUDA kernels
   (``src/repro_torch/kernels/csrc/*.cu``, one ``nvcc`` each, in parallel)
   from the checkout's sources and print ptxas' register/shared-memory
   report for each;
2. parity — each kernel against its plain PyTorch version on the card:
   ``sgs_decode`` bit for bit on the instances of the decode tests
   (``tests/_decode_cases.py``: the random sweep, the edge cases, grouped
   G > 1 calls, J = 300, and the main path's isolated and shared shapes
   with an odd group size at J > 32); ``sched_violation`` bit for bit on
   the shapes of ``tests/test_kernels.py``, the ising engine's shapes, the
   largest grids of its register envelope and the wide path's grids past
   it (M 4 x T 2048, M 1 x T 4097, M 9, M 12), in float32 and bfloat16, with
   ``dem`` contiguous and as the ising loop passes it, a transposed view
   (zero at caps 1e9, never negative); ``usl_runtime`` on
   ``tests/test_kernels.py``'s shapes in float32 and bfloat16 (rtol 1e-5,
   atol 1e-5); and small vectorized and ising solves whose plans must not
   depend on which of the two routes ran;
3. main path — ``Agora(..., solver="vectorized", vec_cfg=VecConfig())``
   (256 chains, 600 sweeps, 256 time bins) serves an isolated session and
   a shared-capacity session (bucket 16: warm up, then two batches of 16
   DAGs each) and one quickstart ``agora.plan``. Every plan must validate,
   shared batches must have no joint violation, warm traffic must run no
   new signature, and the decode kernel's launch counter must show each
   solve went through it (iters + 1 launches at least);
4. ising path — ``Agora(..., solver="ising")`` at ``IsingConfig()``
   defaults (512 chains, 1500 steps, 256 time bins) serves an isolated
   session (warm up, then one batch of 16 DAGs, one solve per DAG), a
   shared-capacity session (16 tenants released at t = 0: one joint
   problem) and one quickstart plan, with the same checks; the
   ``sched_violation`` kernel must have run iters + 1 times per solve;
5. control plane (``repro_torch.flow``, ``repro_torch.launch``) at
   ``VecConfig()`` on ``alibaba_cluster(machines=20)``: (a) a
   ``PlannerService`` with a shared and an isolated pool (bucket 16,
   ``max_batch=16``, deadline flush) warms both pools at once on threads
   of their own from an empty build directory (``sgs_decode`` must be
   compiled once), then serves two rounds of 16 ``synth_trace`` DAGs per
   pool (seeds 3 and 5; 4 guaranteed with feasible deadlines, 8 standard,
   4 best effort), 4 of them through ``POST /v1/plan``, and sheds one
   guaranteed request with an infeasible deadline; every plan validates,
   no signature is new after warmup, every submission's causal chain is
   complete, ``/v1/stats`` and ``/v1/metrics`` answer, and the decode
   kernel ran iters + 1 times per dispatch at least; (b) an ising-backed
   service serves a burst of 16 in one joint solve (``sched_violation``
   iters + 1 times); (c) ``StreamingRunner`` on two Poisson draws of 16
   tenants with mixed SLA classes, SLA-aware and FIFO: the guaranteed hit
   rate SLA-aware must be strictly above FIFO, with no capacity
   violation, and arrivals inside the live bucket run no new signature;
   (d) solver errors on the shared pool: availability 1.0 with degraded
   serving (the breaker opens), below 1.0 fail-fast; (e) ``python -m
   repro_torch.launch.serve_planner`` in a subprocess with its default
   flags serves ``/healthz``, a plan and ``/v1/stats``, exits cleanly on
   SIGINT, and ``obs_report`` reads its event tape;
6. this slice's paths (run before phase 5): (a) ``ising_anneal`` at
   ``IsingConfig(grid=2048)`` on ``paper_cluster()`` (M 4, 8192 cells)
   serves ``dag1`` through ``sched_violation``'s wide path, iters + 1
   launches; (b) the B=1 wrappers ``decode_schedule_full`` and
   ``decode_schedule`` through the decode kernel against the plain
   version; (c) the isolated and shared solves of phase 3's shapes
   unsharded and on (1, 1), (2, 1) and (1, 2) planner meshes over the one
   card: valid plans, ``sgs_decode`` launches per sharded solve, the
   (1, 1) mesh's plans equal to the unsharded ones; (d) ``sgs_decode``
   past the fast path's shared memory: the latency floor of a step (one
   warp running a step's irreducible chain back to back), then J 1193,
   1194, 1792, 2048, 2049 and 4096 at M 2, T 256, each on the route
   ``geometry`` picks ("fast" up to J 1193, "wide" up to J 2048,
   "wide-block" past it) and on every other route that takes the shape,
   all equal to the plain version bit for bit (ms per launch beside the
   bound and the floor), and a shared ``PlannerSession`` pool of 128
   tenants at Jmax 14 (J 1792) warms and serves valid plans, every decode
   on the "wide" route (launches counted by route);
7. plan quality against the reference (``tests/_quality.py``): the four
   cells of phases 3 and 4 on the card's production draws for the solver
   seeds of ``tests/torch_golden/quality_full.json`` (the reference's
   energies from CPU JAX): every plan valid, and each cell's mean energy
   over the seeds at most the reference's mean plus two standard errors
   of its seed spread; each (cell, seed) solved in one of up to 8
   worker processes on the card;
8. the dense, MoE and SSM model families and the VLM and audio backbones
   (``repro_torch.launch.serve_model.serve``) at full width, weights drawn
   from seed 0 and held in bfloat16: ``smollm-360m`` (32 layers, d_model
   960), ``yi-6b`` (32 layers, d_model 4096), ``granite-20b`` (52 layers,
   d_model 6144), ``olmoe-1b-7b`` (16 MoE layers, 64 experts, top 8) and
   ``deepseek-v2-lite-16b`` (MLA, one dense prefix block and 26 MoE
   layers, 64 experts, top 6, a merged shared expert) each serve a batch
   of 4 (prompt 16, 32 greedy tokens); decode ms per step, tokens per
   second, peak memory, the matrix products' share of a profiled step and
   the step's least time (for MoE, from the experts its routing reads,
   beside all experts' bytes) are printed; ``smollm-360m``'s
   teacher-forced logits on the card must agree with the port's CPU run
   of the same weights within the bfloat16 tolerance of
   ``tests/_model_cases.py``, and in float32 within its float32 rule;
   each served MoE model's first 2 layers, in float32, must route every
   token of every layer to the same experts on the card as on the CPU,
   and agree within the float32 rule (``deepseek-v2-lite-16b`` with MLA
   absorbed and expanded); ``rwkv6-3b`` (32 RWKV6 layers, d_model 2560)
   and ``zamba2-2.7b`` (54 Mamba2 layers in 9 groups, each followed by
   one shared attention block) are served the same way, their least time
   counting the float32 recurrent state read and written once and the
   shared block once (beside its bytes in all 9 groups); each one's
   leading layers at full width (2 for ``rwkv6-3b``, the first group of 6
   and the shared block for ``zamba2-2.7b``) in float32 must agree on the
   card and the CPU within the float32 rule (the final recurrent states'
   differences printed), and, on the card, the chunked forward must agree
   with the teacher-forced decode steps over the 48 served positions;
   ``llama-3.2-vision-11b`` (40 layers in 8 groups of 5, each group
   followed by a gated cross-attention sublayer over a patch cache of
   4096 patches, and an MLP; served against the zero patch cache, as the
   reference's ``serve`` serves it) and ``musicgen-large`` (48 layers fed
   frame embeddings) are served the same way, their least time counting
   the patch cache read once a step (its bytes, and those of the float32
   copy of its keys that the attention makes, printed apart); the VLM's
   first group (cut to 2 of its 5 self blocks; the cross
   sublayer with its gate set non-zero, the patch cache filled from
   seeded patches through the group's ``wk``/``wv``) must agree on the
   card and the CPU within the float32 rule's tolerance, held in
   float64 (float32's own rounding in this group exceeds that
   tolerance; its numbers are printed beside),
   and so must its forward over the patches and its teacher-forced
   decode steps over the 48 served positions on the card;
   ``musicgen-large``'s first 2 layers in float32 must agree on the card
   and the CPU over the served prompt's embeddings. No kernel of the
   port runs on this path;
9. training (``repro_torch.launch.train.train``; ``train_models``):
   ``smollm-360m`` at full width and depth, seed-0 weights, batch 8 x
   sequence 2048, 20 steps at lr 1e-3, remat "full", deterministic
   algorithms: every loss and gradient norm finite and the loss falling;
   a warm step's ms and tokens/s, device busy in a profiled step with the
   matrix products' share, the float32 score products and the AdamW
   update timed apart, peak memory, the step against its least time;
   the first 4 layers at full width resumed after an injected preemption
   at step 6 from the step-4 checkpoint, params and optimizer state bit
   for bit equal to an uninterrupted run's, each save and restore timed;
   the first 2 layers of ``smollm-360m``, ``olmoe-1b-7b`` and
   ``rwkv6-3b`` in float32 on the card and the CPU against float64: the
   loss within ``f32_tolerance(2)``, every gradient leaf within
   ``card_grad_rtol``, olmoe's expert sets equal, one train step's params
   for smollm within ``first_step_error``; and the int8 ring over 8
   replicas on the card bit for bit against the CPU's. No kernel of the
   port runs on this path;
10. the dry run (``repro_torch.launch.dryrun``; ``dryrun_models``): (a)
   ``run_roofline_cell`` for the ten archs x the four shapes on the (16,
   16) production mesh of ``meta`` entries, in worker processes, the
   sharded program traced one entry for all: every cell ``ok``, or
   ``skip`` with the reference's reason, and every ``ok`` cell's
   collective bytes above 0; a ``[dryrun ARCH x SHAPE]`` line a cell
   with its three roofline terms at 256 H100s (the collective term at
   the data sheet's NVLink rate), its collective bytes by kind, its
   dominant term, roofline fraction and per-device argument bytes beside
   the card's memory and the card's name and power limit, then a
   ``[dryrun]`` line with the cells' trace seconds and the cells the
   collective term dominates; ``[dryrun shard olmoe-1b-7b]``: phase
   11a's decode step traced on a (2, 4) mesh of ``meta`` entries, its
   collective bytes by kind equal to the formula phase 11 holds the card
   to (no card time); (b) ``smollm-360m``'s training step at phase 9a's
   shape and its decode step at phase 8's, traced on ``meta`` under
   ``FlopCounterMode`` and run once on the card under it: the counts
   equal, ``torch.profiler``'s ``with_flops`` sum beside them; each
   record through the port's ``RooflinePredictor`` (the unfused bytes,
   and the fused estimate) beside the step phases 9a and 8 measured; (c)
   GPipe (``models/pipeline.pp_loss_fn``) for ``smollm-360m`` at full
   width and depth in float32 over a ("data", "stage") (1, 4) mesh of
   the card, and over a ("data", "stage", "model") (1, 2, 4) mesh of the
   card with the model built on it (the embedding and head sharded over
   the model axis), 4 microbatches of a batch of 8 x 512: the loss
   within 2e-4 of the unstaged ``Model.loss``, every gradient leaf
   against float64 within ``card_grad_rtol``, the bytes of a step
   (forward and backward) equal to the formula; each step's ms and peak
   memory (beside the dry run's reckoning for the (1, 4) step), and the
   bubble (``[gpipe smollm-360m (1, 4)]``, ``[gpipe smollm-360m (1, 2,
   4)]``). No kernel of the port runs on this path;
11. the attention family sharded over a (data, model) mesh
   (``Model(cfg, mesh=...)``; ``sharded_models``): ``olmoe-1b-7b`` at
   published size, seed-0 weights, served through ``serve(mesh=...)``
   on a (2, 4) mesh of the one card at batch 4, prompt 16, 16 greedy
   tokens (half of phase 8's, for time) beside the one-device serve
   from the same weights: no assignment dropped on either side, where
   each row's routing first parts from the one-device run's (a near-tie
   in bfloat16), the peak memory of both;
   its first 4 layers in float64 teacher-forced on the mesh against one
   device (logits, expert sets, greedy tokens); one decode step's bytes
   of each collective kind against their formula and phase 10's
   one-entry trace of the step; a warm step's ms beside the one-device
   step's; then the first 2 layers at full width
   in float32 on (2, 4) meshes of the card and of the CPU against
   float64 (olmoe at ``capacity_factor=1.0`` with and without
   ``moe_sp_dispatch``: loss, logits, expert sets, gradients; ``yi-6b``
   with ``seq_parallel`` and ``fast_norm``: loss, logits). No kernel of
   the port runs on this path;
12. MLA, the VLM's cross-attention groups, RWKV6 and Mamba2 sharded over
   the same (2, 4) mesh (``sharded_families``): (a)
   ``deepseek-v2-lite-16b`` at published size, seed-0 weights, served
   through ``serve(mesh=...)`` (batch 4, prompt 16, 8 greedy tokens):
   no assignment dropped, peak memory beside phase 8's one-device serve,
   one decode step's bytes of each collective kind against their
   formula, a warm step's ms beside phase 8's; its first 3 layers (the
   dense prefix and 2 MoE blocks) in float64 on the mesh against one
   device over the prompt and 4 greedy steps: logits within 1e-9 of
   their largest, expert sets and tokens equal; (b) ``rwkv6-3b`` (4
   layers), ``zamba2-2.7b`` (2 groups: 12 Mamba2 layers and the shared
   block) and ``llama-3.2-vision-11b`` (its first group, 2 of 5 self
   blocks, gate set non-zero, patch cache filled from seeded patches) at
   published width, cut from their seed-0 draws: in float64 on the mesh
   against one device over the prompt and 4 greedy steps, logits and
   every cache leaf within 1e-9 of their largest; in bfloat16, one
   decode step's bytes by kind against their formula, a warm step's ms
   on the mesh and on one device, peak memory. No kernel of the port
   runs on this path;
13. a mesh whose entries sit on two devices (``mixed_mesh``):
   ``olmoe-1b-7b`` at published width, its first 2 layers, in float64 on
   a (2, 4) mesh whose entries with an odd model index are the CPU and
   the rest the card, against the (2, 4) mesh of the card alone: the
   logits and loss of a seeded 4 x 16 batch, every gradient leaf, and 4
   decode steps with the cache (2 fed, 2 greedy: logits, every cache
   leaf, expert sets, greedy tokens), each within 1e-9 of its largest;
   one decode step's collective bytes equal to phase 11's formula at
   this shape; the peak memory on the card beside the card's mesh's
   (``[mixed olmoe-1b-7b]``). No kernel of the port runs on this path.

The inputs of one kernel call of each session are captured, checked
against the plain version and timed: ``sched_violation`` as the ising
loop passes them (a transposed ``dem`` view, read through its strides)
and, on an earlier line, contiguous and in the kernel's general layout
(K = 0) beside the bin-major one ``geometry`` picks; beside them the
device time of an empty launch and of a launch with no tasks. The pool's
decode is timed on the device and as launched, beside the wide-block
route on the same inputs, with the host work of a call (50 calls back to
back, and the garbage collector's pauses among them) and each piece of
host work a launch once repeated (``sgs_decode.probe_host``).
``sched_violation``'s wide path is timed at B 512, J 10, M 4, T 2048,
beside the bin-major path on the same tasks scaled to T 256, and on phase
6a's live inputs.
``usl_runtime``, which no path calls, is timed on a grid of 4096 tasks x
256 configurations of contiguous float32 inputs, so that the call runs
no copy kernel; each timed call's PyTorch ops are recorded and the run
fails if one of them copies. The build fails if ptxas reports a spill in
any of ``sched_violation``'s or ``sgs_decode``'s kernels, the wide paths'
among them.

Prints the card's name and power limit, the control plane's numbers
(warmup, dispatch and submit-to-result seconds, hit rates, availability)
beside them, one JSON line with the kernels' numbers, and, as the last
line, {"ok": true, "device": {...}}. Exits
non-zero without that line when CUDA is not available, when the port's
sources are not beside this script, or when any check fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
CSRC = "src/repro_torch/kernels/csrc"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "sgs_decode": (f"{CSRC}/sgs_decode.cu",
                   "src/repro/kernels/sgs_decode.py:39"),
    "sched_violation": (f"{CSRC}/sched_violation.cu",
                        "src/repro/kernels/sched_energy.py:30"),
    "usl_runtime": (f"{CSRC}/usl_runtime.cu",
                    "src/repro/kernels/usl_runtime.py:19"),
}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_kernels(report: str):
    """(entry, registers, spill store bytes, spill load bytes) of each
    kernel in an ``nvcc -Xptxas -v`` report."""
    out, entry, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), *spill))
            entry, spill = None, (0, 0)
    return out


# --- measurement helpers ---------------------------------------------------

def same_outputs(a, b) -> float:
    """Raise unless the two (start, finish, ok) triples are equal; return
    the max abs difference (0.0)."""
    import torch
    err = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"output mismatch: {x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        err = max(err, float((x.to(torch.float64) - y.to(torch.float64))
                             .abs().max()) if x.numel() else 0.0)
    if err != 0.0:
        fail(f"kernel disagrees with its plain version (max abs err {err})")
    return err


def close_outputs(what, got, want, rtol, atol) -> float:
    """Raise unless ``got`` is within rtol/atol of ``want`` (same shape,
    float32); return the max abs difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: output {tuple(got.shape)}/{got.dtype} vs plain "
             f"{tuple(want.shape)}/{want.dtype}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite kernel output")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{what}: kernel disagrees with its plain version beyond rtol "
             f"{rtol}, atol {atol}")
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``, its kernels run back to back. A spin
    kernel holds the stream while the host queues ``reps`` calls, so the
    events time the kernels and not the host launching them, which is what
    ``time_ms`` reads wherever the host is the slower (the ising kernels
    run for microseconds). The spin doubles until the host has queued
    every call before it ends."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin = 1 << 22                  # cycles; about 2 ms at 1.98 GHz
    while spin <= 1 << 31:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_behind_spin = not a.query()
        torch.cuda.synchronize()
        if queued_behind_spin:
            return a.elapsed_time(b) / reps
        spin *= 2
    fail(f"could not queue {reps} calls behind a spin of {spin // 2} cycles")


def least_ms(nbytes, ops):
    """The larger of the two times, in ms, and which one bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(args, out, T):
    """Least time the card needs for one decode of these inputs: each input
    read once, each output written once, over HBM; the simple float32/int
    operations this run's data needs over the float32 peak."""
    dur, dem, prio, release, pred, caps = args
    rows, J = dur.shape
    G = 1 if release.dim() == 1 else release.shape[0]
    M = caps.shape[0]
    nbytes = (4 * dur.numel() + 4 * dem.numel() + 4 * prio.numel()
              + 4 * J * G + J * J * G + 4 * M + 9 * rows * J)
    start, finish, _ = out
    placed = (finish.clamp(0, T) - start.clamp(0, T)).clamp(min=0)
    # per row and step: J argmax compares, 3 ops per (bin, resource) for
    # the overload flag, 4 per bin for the prefix sum and the window test;
    # then one add per (placed bin, resource)
    ops = rows * J * (J + 3 * T * M + 4 * T) + M * int(placed.sum())
    return (*least_ms(nbytes, ops), nbytes, ops)


def sched_bound(args, T):
    """Least time for one violation mass of these inputs: start, dur, dem
    and caps read once and (B,) written, over HBM; over the float32 peak,
    one add per task for its end, one add per (resource, covered bin) of
    each task — what this run's intervals cover — and a subtract, a max
    and a sum add per (candidate, resource, bin)."""
    import torch
    start, dur, dem, caps = (x.float() for x in args)
    B, M, J = dem.shape
    nbytes = 4 * (start.numel() + dur.numel() + dem.numel() + M + B)
    lo = torch.ceil(start).clamp(0, T)
    hi = torch.ceil(start + dur).clamp(0, T)
    covered = int((hi - lo).clamp(min=0).sum())
    ops = B * J + M * covered + 3 * B * M * T
    return (*least_ms(nbytes, ops), nbytes, ops)


def usl_bound(n_elems):
    """Five float32 inputs read and one written per element; ten simple
    operations (two subtracts, four multiplies, two adds, two divides) and
    one max per element."""
    nbytes, ops = 6 * 4 * n_elems, 11 * n_elems
    return (*least_ms(nbytes, ops), nbytes, ops)


class Capture:
    """Wraps ``kernels.ops.<name>`` and keeps a copy of the inputs of the
    ``at``-th call (the kernel call of one step of a live solve)."""

    def __init__(self, ops, name: str, at: int):
        self.ops, self.name, self.at, self.n = ops, name, at, 0
        self.orig = getattr(ops, name)
        self.args = self.T = None

    def __call__(self, *args, **kw):
        if self.n == self.at:
            self.args, self.T = [a.clone() for a in args], kw["T"]
        self.n += 1
        return self.orig(*args, **kw)

    def __enter__(self):
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)


def profile_solve(name, sess, batch, unprofiled_s) -> None:
    """Device busy time of one warm solve, by kernel (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.plan(batch)
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    # device-side events only: a CPU op's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile {name}] one warm solve: {wall_ms:.1f} ms profiled, "
        f"{unprofiled_s * 1e3:.1f} ms unprofiled; device busy {busy_ms:.1f} "
        f"ms; idle share {1 - busy_ms / (unprofiled_s * 1e3):.3f} of the "
        f"unprofiled wall time")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top 8, and the port's own kernels wherever they rank
    for e in ranked[:8] + [e for e in ranked[8:]
                           if any(f"{k}_kernel" in e.key for k in KERNELS)]:
        log(f"[profile {name}]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d} x {e.key[:70]}")


def check_no_copy(what, fn) -> None:
    """Record the PyTorch ops one call of ``fn`` runs (torch.profiler, CPU
    side) and fail if one of them copies (``aten::copy_``, ``clone``,
    ``_to_copy``): no copy or cast kernel hides in a timed call. The
    kernel itself is launched through ctypes and is not an op."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = sorted({e.key for e in prof.key_averages()})
    copies = [n for n in names if "copy" in n or "clone" in n]
    if copies:
        fail(f"{what}: the timed call copies its inputs ({copies})")
    log(f"[no copy] {what}: the timed call runs the ops {names}, none of "
        f"them a copy")


# --- phase 5: the control plane ---------------------------------------------

SLA_MIX = (("guaranteed", 4), ("standard", 8), ("best_effort", 4))


def synth_stream(cluster, sess, tenants, seed, arrival_mean=300.0,
                 budget=1.5):
    """Poisson tenant arrivals of ``synth_trace`` DAGs with mixed SLA
    classes (35% guaranteed, 30% standard, 35% best effort), shaped like
    ``benchmarks/bench_streaming.py:poisson_stream``. A guaranteed
    tenant's deadline gives ``budget`` times its critical path of
    best-case durations (``session.admit``'s bound) past its arrival."""
    import numpy as np
    from repro_torch.cluster.workloads import synth_trace
    from repro_torch.core.session import PlanRequest
    from repro_torch.flow.streaming import (SLA_BEST_EFFORT, SLA_GUARANTEED,
                                            SLA_STANDARD, TenantRequest)
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for dag in synth_trace(tenants, cluster, seed=seed):
        t += float(rng.exponential(arrival_mean))
        dag.release_time = t
        u = float(rng.random())
        if u < 0.35:
            lb = sess.admit(PlanRequest(dag=dag),
                            now=t).completion_lower_bound
            reqs.append(TenantRequest(dag, sla=SLA_GUARANTEED,
                                      deadline=t + budget * (lb - t)))
        elif u < 0.65:
            reqs.append(TenantRequest(dag, sla=SLA_STANDARD))
        else:
            reqs.append(TenantRequest(dag, sla=SLA_BEST_EFFORT))
    return reqs


async def http_call(port, method, path, body=None):
    """One HTTP/1.1 request to 127.0.0.1:port -> (status, body bytes)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


def control_plane(dev, gpu, cfg, icfg) -> None:
    """Phase 5: the port's daemon (two pools warmed concurrently on an
    empty build directory, 64 requests of mixed SLA classes over two
    rounds, four through HTTP, one infeasible), an ising-backed service,
    the streaming runner SLA-aware and FIFO, the chaos plane with and
    without degraded serving, and the CLI in a subprocess."""
    import asyncio
    import dataclasses as dc
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch.cluster.catalog import alibaba_cluster
    from repro_torch.cluster.workloads import synth_trace
    from repro_torch.core.agora import Agora
    from repro_torch.core.objectives import Goal
    from repro_torch.core.session import SLA_GUARANTEED, PlanRequest
    from repro_torch.flow.chaos import ChaosConfig
    from repro_torch.flow.daemon import (DaemonConfig, LoadShedError,
                                         PlannerHTTPServer, PlannerService,
                                         PlanServiceError, PoolSpec,
                                         dag_to_json)
    from repro_torch.flow.executor import FlowConfig
    from repro_torch.flow.streaming import (StreamConfig, StreamingRunner,
                                            capacity_violations,
                                            deadline_hit_rate)
    from repro_torch.kernels import _build
    from repro_torch.kernels import sched_violation as sv_kernel
    from repro_torch.kernels import sgs_decode as kernel
    from repro_torch.launch.serve_planner import demo_template
    from repro_torch.obs.sink import RingSink
    from repro_torch.obs.trace import chain_complete, spans, trace_ids

    c20 = alibaba_cluster(machines=20)
    agora = Agora(c20, goal=Goal.balanced(), solver="vectorized",
                  vec_cfg=cfg, device=dev)
    sets = [synth_trace(16, c20, seed=s) for s in (3, 5)]
    for dags in sets:
        for d in dags:
            d.release_time = 0.0     # the daemon plans from submission
    template = max(sets[0], key=lambda d: d.num_tasks)
    envelope = (template.num_tasks,
                max(len(t.options) for t in template.tasks))
    for dags in sets:
        if (max(d.num_tasks for d in dags),
                max(len(t.options) for d in dags for t in d.tasks)) \
                != envelope:
            fail(f"[daemon] a burst leaves the template's envelope "
                 f"{envelope}")

    # 5a. the daemon -------------------------------------------------------
    ring = RingSink(1 << 16)
    svc = PlannerService(agora, DaemonConfig(
        pools=(PoolSpec("shared", shared_capacity=True, bucket_p=16),
               PoolSpec("isolated", shared_capacity=False, bucket_p=16)),
        max_batch=16, max_wait_s=120.0, flush="deadline", sink=ring))
    # first use of the decode kernel from the two warmup threads at once:
    # an empty build directory, so both threads ask for a library that
    # is not built yet
    built = _build.BUILD_DIR
    fresh = built / "concurrent-first-use"
    shutil.rmtree(fresh, ignore_errors=True)
    _build.use_build_dir(fresh)
    compiled = _build.compiles.get("sgs_decode", 0)
    kernel.sgs_decode.launches = 0
    sv_kernel.sched_violation.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    futures = {name: e.session.warmup_async(template, max_p=16)
               for name, e in svc.entries.items()}
    warm = {name: f.result() for name, f in futures.items()}
    warm_s = time.monotonic() - t0
    if _build.compiles.get("sgs_decode", 0) - compiled != 1:
        fail(f"[daemon] sgs_decode compiled "
             f"{_build.compiles.get('sgs_decode', 0) - compiled} times by "
             f"two concurrent warmups, expected once")
    _build.use_build_dir(built)      # back to the libraries of phase 1
    shutil.rmtree(fresh, ignore_errors=True)
    log(f"[daemon] pools warmed concurrently in {warm_s:.3f} s: "
        + ", ".join(f"{p} bucket {b} {s:.3f} s" for p, bs in warm.items()
                    for b, s in bs.items())
        + f"; of it nvcc of sgs_decode {_build.seconds['sgs_decode']:.2f} s "
        f"(one compile for both threads) ({gpu})")
    trace0 = svc.stats()["trace_count"]
    lat = {sla: [] for sla, _ in SLA_MIX}
    results, batches, shed = [], [], []

    def request(dag, sla, pool, now):
        kw = {}
        if sla == SLA_GUARANTEED:
            lb = svc.entries[pool].session.admit(
                PlanRequest(dag=dag), now=now).completion_lower_bound
            kw = dict(deadline=lb + 3600.0)   # feasible, far off
        return PlanRequest(dag=dag, sla=sla, **kw)

    async def timed(coro, sla):
        t = time.monotonic()
        res = await coro
        lat[sla].append(time.monotonic() - t)
        return res

    async def post(port, req, pool):
        body = {"dag": dag_to_json(req.dag), "sla": req.sla,
                "deadline": None if not np.isfinite(req.deadline)
                else req.deadline, "pool": pool}
        status, data = await http_call(port, "POST", "/v1/plan", body)
        if status != 200:
            fail(f"[daemon] POST /v1/plan answered {status}: {data[:200]}")
        return json.loads(data)

    async def drive():
        async with svc:
            http = PlannerHTTPServer(svc)
            _, port = await http.start()
            for rnd, pools in enumerate((("shared", "isolated"),
                                         ("isolated", "shared"))):
                before = svc.stats_counters.batches
                now = svc._now()
                calls = []
                for pool, dags in zip(pools, sets):
                    i = 0
                    for sla, n in SLA_MIX:
                        for d in dags[i:i + n]:
                            req = request(d, sla, pool, now)
                            if rnd == 1 and pool == "shared" and \
                                    len([c for c in calls if c[0]]) < 4 \
                                    and sla != "best_effort":
                                calls.append((True, sla, post(port, req,
                                                              pool)))
                            else:
                                calls.append((False, sla, svc.submit(
                                    req, pool=pool)))
                        i += n
                t = time.monotonic()
                out = await asyncio.gather(*(timed(c, sla)
                                             for _, sla, c in calls))
                batches.append((svc.stats_counters.batches - before,
                                time.monotonic() - t))
                results.extend(zip([h for h, _, _ in calls], out))
            # a guaranteed deadline no schedule can meet: shed at the door
            bad = PlanRequest(dag=dc.replace(template, name="infeasible"),
                              sla=SLA_GUARANTEED, deadline=svc._now() + 1.0)
            try:
                await svc.submit(bad, pool="shared")
                shed.append(False)
            except LoadShedError as exc:
                shed.append(exc.reason)
            status, stats = await http_call(port, "GET", "/v1/stats")
            mstatus, metrics = await http_call(port, "GET", "/v1/metrics")
            await http.stop()
            return status, json.loads(stats), mstatus, metrics.decode()

    status, stats, mstatus, metrics = asyncio.run(drive())
    torch.cuda.synchronize()
    decode_launches = kernel.sgs_decode.launches
    via_http = sum(h for h, _ in results)
    if len(results) != 64 or via_http != 4:
        fail(f"[daemon] {len(results)} answers, {via_http} through HTTP")
    for from_http, res in results:
        errs = res["errors"] if from_http else res.validate()
        if errs:
            fail(f"[daemon] invalid plan: {errs[:3]}")
        if not from_http and res.plan.joint_errors:
            fail(f"[daemon] joint violations {res.plan.joint_errors[:3]}")
    if not shed or shed[0] is False:
        fail("[daemon] the infeasible guaranteed request was served")
    if status != 200 or mstatus != 200 or \
            "planner_served_total 64" not in metrics:
        fail(f"[daemon] /v1/stats {status}, /v1/metrics {mstatus}")
    if stats["served"] != 64 or stats["shed_admission"] != 1:
        fail(f"[daemon] /v1/stats served {stats['served']}, shed "
             f"{stats['shed_admission']}")
    new_sigs = svc.stats()["trace_count"] - trace0
    if new_sigs:
        fail(f"[daemon] {new_sigs} new signatures after warmup")
    dispatches = 2 + sum(n for n, _ in batches)      # warmups + batches
    if decode_launches < (cfg.iters + 1) * dispatches:
        fail(f"[daemon] sgs_decode launched {decode_launches} times for "
             f"{dispatches} dispatches")
    ids = trace_ids(ring.events)
    complete = sum(chain_complete(spans(ring.events, t)) for t in ids)
    if len(ids) != 65 or complete != len(ids):
        fail(f"[daemon] {complete} of {len(ids)} causal chains complete "
             f"for 65 submissions")
    solve_s = {p: [e.data["seconds"] for e in ring.events
                   if e.type == "plan_solved" and e.pool == p]
               for p in svc.entries}
    log(f"[daemon] 2 rounds x 2 pools x 16 requests, 4 through POST "
        f"/v1/plan, 1 infeasible shed ({shed[0]}); dispatches per round "
        f"{[n for n, _ in batches]}, round seconds "
        f"{[round(s, 3) for _, s in batches]}; seconds per dispatch "
        + ", ".join(f"{p} {[round(x, 3) for x in xs]}"
                    for p, xs in solve_s.items())
        + f"; new signatures after warmup {new_sigs}; sgs_decode launches "
        f"{decode_launches} over {dispatches} dispatches; {complete} "
        f"complete causal chains ({gpu})")
    for sla, _ in SLA_MIX:
        p50, p99 = np.percentile(lat[sla], [50, 99])
        log(f"[daemon] submit->result {sla}: p50 {p50:.3f} s, p99 "
            f"{p99:.3f} s over {len(lat[sla])} requests ({gpu})")

    # 5b. an ising-backed service ------------------------------------------
    isvc = PlannerService(
        Agora(c20, goal=Goal.balanced(), solver="ising", vec_cfg=cfg,
              device=dev),
        DaemonConfig(pools=(PoolSpec("shared", shared_capacity=True,
                                     bucket_p=16),),
                     max_batch=16, max_wait_s=120.0))
    isvc.warmup(template, max_p=16)
    sv_kernel.sched_violation.launches = 0

    async def burst():
        async with isvc:
            return await asyncio.gather(*(isvc.submit(PlanRequest(dag=d))
                                          for d in sets[0]))

    t0 = time.monotonic()
    ires = asyncio.run(burst())
    iburst_s = time.monotonic() - t0
    torch.cuda.synchronize()
    viol = sv_kernel.sched_violation.launches
    for r in ires:
        if r.validate() or r.plan.joint_errors:
            fail(f"[ising service] invalid plan {r.request.name}")
    if isvc.stats()["batches"] != 1 or viol != icfg.iters + 1:
        fail(f"[ising service] {isvc.stats()['batches']} dispatches, "
             f"sched_violation launched {viol} times (expected "
             f"{icfg.iters + 1})")
    log(f"[ising service] one burst of 16: one joint solve in "
        f"{iburst_s:.3f} s; sched_violation launches {viol} ({gpu})")

    # 5c. the streaming runner, SLA-aware and FIFO ---------------------------
    sess = agora.session()
    hits, walls, viols = {}, {}, {}
    kernel.sgs_decode.launches = 0
    for mode, sc in (("sla", StreamConfig(bucket_p=16)),
                     ("fifo", StreamConfig(bucket_p=16, sla_aware=False,
                                           replan_on_arrival=False,
                                           overlap_rounds=False))):
        met = total = rounds = viols[mode] = 0
        per_draw = []
        t0 = time.monotonic()
        for seed in (0, 1):
            runner = StreamingRunner(
                agora, synth_stream(c20, sess, 16, seed),
                FlowConfig(mode="sim", enforce_capacity=True,
                           speculation=False, seed=seed), sc)
            recs = runner.run()
            s, f, d = runner.realized_intervals()
            viols[mode] += len(capacity_violations(s, f, d, c20.caps))
            g = [r for r in recs if r.sla == SLA_GUARANTEED]
            met += sum(r.deadline_met for r in g)
            total += len(g)
            rounds += len(runner.rounds)
            per_draw.append(round(deadline_hit_rate(recs), 3))
            if len(recs) != 16:
                fail(f"[streaming {mode}] {len(recs)} records of 16")
        walls[mode] = time.monotonic() - t0
        hits[mode] = (met, total, rounds, per_draw)
    stream_launches = kernel.sgs_decode.launches
    rate = {m: h[0] / max(h[1], 1) for m, h in hits.items()}
    if not rate["sla"] > rate["fifo"]:
        fail(f"[streaming] guaranteed hit rate SLA-aware {rate['sla']} is "
             f"not above FIFO {rate['fifo']}")
    if viols["sla"] or viols["fifo"]:
        fail(f"[streaming] capacity violations {viols}")
    if stream_launches < cfg.iters + 1:
        fail(f"[streaming] sgs_decode launched {stream_launches} times")
    # arrivals inside the live bucket and envelope run no new signature
    wsess = agora.session(shared_capacity=True, bucket_p=16)
    wsess.warmup(template)
    n0 = wsess.stats.trace_count
    rest = [d for d in sets[1] if d.name != template.name]
    for n in (2, 3, 4):
        for r in wsess.plan([template] + rest[:n - 1]):
            if r.validate():
                fail("[streaming] invalid plan inside the live bucket")
    if wsess.stats.trace_count != n0:
        fail(f"[streaming] {wsess.stats.trace_count - n0} new signatures "
             f"inside the live bucket")
    log(f"[streaming] 2 draws x 16 synth_trace tenants on "
        f"alibaba_cluster(machines=20): guaranteed hit rate SLA-aware "
        f"{rate['sla']:.3f} ({hits['sla'][0]}/{hits['sla'][1]}, per draw "
        f"{hits['sla'][3]}, {hits['sla'][2]} rounds, {walls['sla']:.1f} s) "
        f"vs FIFO {rate['fifo']:.3f} ({hits['fifo'][0]}/{hits['fifo'][1]}, "
        f"per draw {hits['fifo'][3]}, {hits['fifo'][2]} rounds, "
        f"{walls['fifo']:.1f} s); capacity "
        f"violations 0; new signatures inside the live bucket 0; "
        f"sgs_decode launches {stream_launches} ({gpu})")

    # 5d. chaos: solver errors on the daemon's shared pool -------------------
    def chaos(degraded_serve):
        ring = RingSink()
        csvc = PlannerService(agora, DaemonConfig(
            pools=(PoolSpec("shared", shared_capacity=True, bucket_p=16),),
            max_batch=1, max_wait_s=0.01,
            chaos=ChaosConfig(solver_error_solves=(0, 1, 2, 3)),
            breaker_threshold=2, breaker_cooldown_s=0.05, solve_retries=1,
            degraded_serve=degraded_serve, sink=ring))
        csvc.warmup(template, max_p=1)

        async def go():
            out = []
            async with csvc:
                for i in range(6):
                    try:
                        out.append(await csvc.submit(PlanRequest(
                            dag=dc.replace(template, name=f"c{i}"))))
                    except PlanServiceError as exc:
                        out.append(exc)
                    await asyncio.sleep(0.08)   # past the cooldown
            return out

        out = asyncio.run(go())
        plans = [o for o in out if not isinstance(o, Exception)]
        for r in plans:
            if r.validate():
                fail("[chaos] invalid plan")
        opened = any(e.type == "pool_degraded" for e in ring.events)
        return len(plans) / len(out), csvc.stats(), opened

    avail, st, opened = chaos(True)
    avail_off, _, _ = chaos(False)
    if avail != 1.0 or not opened or st["degraded_served"] < 1:
        fail(f"[chaos] degraded serving: availability {avail}, breaker "
             f"opened {opened}, degraded {st['degraded_served']}")
    if not avail_off < 1.0:
        fail(f"[chaos] fail-fast availability {avail_off}, expected < 1")
    log(f"[chaos] availability {avail:.3f} with degraded serving "
        f"({st['degraded_served']} degraded, breaker opened and ended "
        f"{st['pools']['shared']['breaker']}), {avail_off:.3f} fail-fast "
        f"({gpu})")

    # 5e. the CLI, as a user runs it ------------------------------------------
    built.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=built) as tmp:
        events = os.path.join(tmp, "events.jsonl")
        env = dict(os.environ, PYTHONPATH=SRC, PYTHONUNBUFFERED="1")
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve_planner",
             "--port", "0", "--events", events], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        watchdog = threading.Timer(600.0, proc.kill)   # a hung CLI ends
        watchdog.start()
        try:
            port, lines = None, []
            while port is None:
                line = proc.stdout.readline()
                if not line:
                    fail(f"[cli] exited before serving: {''.join(lines)}"
                         f"{proc.stderr.read()[-2000:]}")
                lines.append(line)
                m = re.search(r"serving on http://[^:]+:(\d+)", line)
                port = int(m.group(1)) if m else None
            up_s = time.monotonic() - t0

            def call(path, body=None):
                status, data = asyncio.run(http_call(
                    port, "GET" if body is None else "POST", path, body))
                return status, json.loads(data)

            health = call("/healthz")
            # guaranteed, 10 s of slack past its 120 s critical path: the
            # deadline flush sends it at once (the clock is the machine's
            # monotonic clock, which the daemon reads too)
            t0 = time.monotonic()
            status, plan = call("/v1/plan", {
                "dag": dag_to_json(demo_template()), "sla": "guaranteed",
                "deadline": time.monotonic() + 130.0})
            plan_s = time.monotonic() - t0
            sstatus, stats = call("/v1/stats")
            proc.send_signal(signal.SIGINT)
            out, err = proc.communicate(timeout=120)
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if health != (200, {"ok": True, "running": True}):
            fail(f"[cli] /healthz {health}")
        if status != 200 or plan["errors"]:
            fail(f"[cli] /v1/plan {status}: {plan}")
        if sstatus != 200 or stats["served"] != 1:
            fail(f"[cli] /v1/stats {sstatus}: served {stats.get('served')}")
        if proc.returncode != 0 or "shutting down" not in out:
            fail(f"[cli] exit {proc.returncode} after SIGINT: "
                 f"{err[-2000:]}")
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.obs_report", events],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if rep.returncode != 0:
            fail(f"[cli] obs_report exit {rep.returncode}: "
                 f"{rep.stderr[-2000:]}")
    log(f"[cli] serve_planner up in {up_s:.1f} s, /healthz ok, one "
        f"guaranteed plan of the demo template in {plan_s:.3f} s (makespan "
        f"{plan['makespan']:.1f} s), /v1/stats served 1, clean exit on "
        f"SIGINT, obs_report exit 0 ({gpu})")


# --- phases 6 and 7: the grids past the register envelope, the B=1 wrappers,
# the meshes, the decode's shape ceiling and plan quality -----------------

def wide_grid(dev, gpu, icfg):
    """Phase 6a: ``sched_violation`` past its register envelope. The ising
    engine at ``IsingConfig(grid=2048)`` on ``paper_cluster()`` (M 4, 8192
    cells: the wide path's two passes) serves ``dag1`` through the kernel,
    iters + 1 launches; returns (launches, the captured call's inputs)."""
    import torch

    from repro_torch.cluster.catalog import paper_cluster
    from repro_torch.cluster.workloads import dag1
    from repro_torch.core import ising
    from repro_torch.core.annealer import reference_point
    from repro_torch.core.dag import flatten
    from repro_torch.core.objectives import Goal
    from repro_torch.core.sgs import validate_schedule
    from repro_torch.kernels import ops
    from repro_torch.kernels import sched_violation as sv_kernel

    pc = paper_cluster()
    prob = flatten([dag1(pc)], pc.num_resources)
    cfg = dataclasses.replace(icfg, grid=2048)
    ref = reference_point(prob, pc)
    torch.cuda.synchronize()
    sv_kernel.sched_violation.launches = 0
    t0 = time.monotonic()
    with Capture(ops, "sched_violation", at=cfg.iters // 2) as cap:
        sol = ising.ising_anneal(prob, pc, Goal.balanced(), cfg, ref,
                                 device=dev)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    launches = sv_kernel.sched_violation.launches
    errs = validate_schedule(prob, sol.option_idx, sol.start, sol.finish,
                             pc.caps)
    if errs or launches != cfg.iters + 1:
        fail(f"[ising grid 2048] {len(errs)} violations, sched_violation "
             f"launched {launches} times (expected {cfg.iters + 1})")
    B, M, J = cap.args[2].shape
    N = sv_kernel.geometry(B, M, cap.T, sv_kernel._sms(dev.index or 0))[4]
    log(f"[ising grid 2048] dag1 on paper_cluster (B {B}, J {J}, M {M}, T "
        f"{cap.T}: {N} cells, {N // 4096} passes of the wide path): makespan {sol.makespan:.1f} s cost ${sol.cost:.2f} energy "
        f"{sol.energy:.4f} in {secs:.3f} s; sched_violation launches "
        f"{launches} ({gpu})")
    return launches, cap.args


def b1_wrappers(dev, kernel):
    """Phase 6b: ``decode_schedule_full`` and ``decode_schedule`` (B=1)
    through the decode kernel, each against the plain version."""
    import numpy as np
    import torch

    from repro_torch.cluster.catalog import paper_cluster
    from repro_torch.cluster.workloads import dag1, dag2, motivation_dag
    from repro_torch.core import vectorized as vec
    from repro_torch.core.annealer import reference_point
    from repro_torch.core.dag import flatten

    pc = paper_cluster()
    rng = np.random.default_rng(0)
    cfg = vec.VecConfig()
    n0, checked = kernel.sgs_decode.launches, 0
    for dag in (dag1(pc), dag2(pc), motivation_dag(pc)):
        prob = flatten([dag], pc.num_resources)
        dp = vec.DeviceProblem.build(prob, pc, reference_point(prob, pc)[0],
                                     cfg, dev)
        n_opts = dp.n_opts.cpu().numpy()
        opt = torch.tensor(rng.integers(0, 1 << 20, len(n_opts)) % n_opts,
                           dtype=torch.int32, device=dev)
        prio = torch.tensor(rng.normal(size=len(n_opts)),
                            dtype=torch.float32, device=dev)
        same_outputs(vec.decode_schedule_full(dp, opt, prio),
                     vec.decode_schedule_full(dp, opt, prio,
                                              use_kernel=False))
        got = vec.decode_schedule(dp, opt, prio)
        want = vec.decode_schedule(dp, opt, prio, use_kernel=False)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail("[b1] decode_schedule: kernel and plain routes disagree")
        checked += 1
    torch.cuda.synchronize()
    launches = kernel.sgs_decode.launches - n0
    if launches != 2 * checked:
        fail(f"[b1] sgs_decode launched {launches} times for {checked} "
             f"problems x 2 wrappers")
    log(f"[b1] decode_schedule_full and decode_schedule on dag1, dag2 and "
        f"the motivation DAG: kernel == plain (start, finish, ok, makespan, "
        f"cost, infeasible count); sgs_decode launches {launches}")


def meshes(dev, gpu, cfg, kernel):
    """Phase 6c: the mesh-sharded solves on (1, 1), (2, 1) and (1, 2)
    planner meshes over one card, at the isolated and shared shapes of
    phase 3 (16 DAGs, ``VecConfig()``); valid plans, ``sgs_decode``
    launches per sharded solve, and the (1, 1) mesh gives the unsharded
    plans."""
    import numpy as np
    import torch

    from repro_torch.cluster.catalog import alibaba_cluster
    from repro_torch.cluster.workloads import synth_trace
    from repro_torch.core import vectorized as vec
    from repro_torch.core.annealer import reference_point
    from repro_torch.core.dag import flatten
    from repro_torch.core.objectives import Goal
    from repro_torch.core.sgs import validate_schedule
    from repro_torch.launch.mesh import make_planner_mesh

    for name, shared, machines, seed in (("isolated", False, 4034, 1),
                                         ("shared", True, 20, 3)):
        cluster = alibaba_cluster(machines=machines)
        dags = synth_trace(16, cluster, seed=seed)
        if shared:
            for d in dags:
                d.release_time = 0.0
        probs = [flatten([d], cluster.num_resources) for d in dags]
        refs = [reference_point(p, cluster) for p in probs]
        solve = (vec.vectorized_anneal_shared if shared
                 else vec.vectorized_anneal_many)
        plans = {}
        for shape in (None, (1, 1), (2, 1), (1, 2)):
            mesh = None if shape is None else make_planner_mesh(
                chains=shape[1], devices=[dev] * (shape[0] * shape[1]))
            torch.cuda.synchronize()
            kernel.sgs_decode.launches = 0
            t0 = time.monotonic()
            out = solve(probs, cluster, Goal.balanced(), cfg, refs,
                        bucket_p=16, mesh=mesh, device=dev)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            launches = kernel.sgs_decode.launches
            sols, joint = out if shared else (out, [])
            for p, sol in zip(probs, sols):
                if validate_schedule(p, sol.option_idx, sol.start,
                                     sol.finish, cluster.caps):
                    fail(f"[mesh {name} {shape}] invalid plan")
            if joint:
                fail(f"[mesh {name} {shape}] joint violations {joint[:3]}")
            # a shard launches one decode a sweep and one at the start;
            # the shared engine's problem axis is replicated (one row)
            shards = 1 if shape is None else (
                shape[1] if shared else shape[0] * shape[1])
            want = shards * (cfg.iters + 1) + (1 if shared else 0)
            if launches != want:
                fail(f"[mesh {name} {shape}] sgs_decode launched {launches} "
                     f"times, expected {want}")
            plans[shape] = [s.option_idx for s in sols]
            same = shape is None or all(
                np.array_equal(a, b) for a, b in zip(plans[None], plans[shape]))
            if shape == (1, 1) and not same:
                fail(f"[mesh {name}] the (1, 1) mesh differs from the "
                     f"unsharded solve")
            log(f"[mesh {name}] {'unsharded' if shape is None else shape}: "
                f"{len(sols)} valid plans in {secs:.3f} s, mean energy "
                f"{float(np.mean([s.energy for s in sols])):.5f}; "
                f"sgs_decode launches {launches}; plans equal to the "
                f"unsharded solve: {same} ({gpu})")


def wide_decode(dev, gpu, cfg, kernel, ops):
    """Phase 6d: ``sgs_decode`` past the fast path's shared memory. First
    the latency floor of a step (``kernel.chain_cycles``). Then, at M 2, T
    256, 8 rows each: J 1193 (the last J the fast route takes), 1194 (the
    first it refuses), 1792 (a shared pool of 128 tenants at Jmax 14), 2048
    (the last J the "wide" route's 64-bit lane mask holds), 2049 and 4096
    (256 tenants at Jmax 16) route as ``_decode_cases.wide_route`` says,
    and every route that takes the shape equals the plain version bit for
    bit and is timed on the same inputs, beside the bound and the floor.
    Then a shared ``PlannerSession`` pool of 128 tenants at ``VecConfig()``
    warms and serves valid plans, every decode on the "wide" route.
    Returns (the pool's launches by route, one captured decode of the pool,
    the J 4096 case for the "wide-block" entry, cycles and GHz of a step's
    chain)."""
    import numpy as np
    import torch
    from _decode_cases import wide_instance, wide_route

    from repro_torch.cluster.catalog import alibaba_cluster
    from repro_torch.cluster.workloads import synth_trace
    from repro_torch.core.agora import Agora

    chain, ghz = kernel.chain_cycles()
    log(f"[sgs_decode chain] one step's irreducible chain (a redux, the "
        f"chosen slot's dependent shared loads, a shuffle, one word of the "
        f"window search), back to back on one warp: {chain:.1f} cycles at "
        f"{ghz:.3f} GHz, {chain / ghz:.1f} ns a step ({gpu})")
    M, T, rows = 2, 256, 8
    rng = np.random.default_rng(5)
    block_case = None
    for J in (1193, 1194, 1792, 2048, 2049, 4096):
        args = [torch.from_numpy(a).to(dev) for a in
                wide_instance(rng, 1, rows, J, M, T)]
        route = kernel.geometry(rows, J, M, T, rows)[0]
        if route != ("fast" if J < 1194 else wide_route(J)):
            fail(f"[sgs_decode wide] J {J}: routed to {route}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = ops.sgs_decode(*args, T=T, use_kernel=False)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        parts = []
        for other in kernel.ROUTES:
            taken, warps, smem, _, scratch = kernel.geometry(rows, J, M, T,
                                                             rows, other)
            if taken is None:
                continue
            same_outputs(kernel.sgs_decode(*args, T=T, route=other), want)
            ms = kernel_ms(lambda: kernel.sgs_decode(*args, T=T,
                                                     route=other), 5)
            parts.append(
                f"{other}{' (taken)' if other == route else ''} {ms:.4f} "
                f"ms/launch, {ms * 1e3 / J:.3f} us per step (W {warps}, "
                f"{smem} B shared memory a block, {scratch} B scratch)")
        out = ops.sgs_decode(*args, T=T, use_kernel=True)
        same_outputs(out, want)
        bound_ms, bound_by, nbytes, nops = bound(args, out, T)
        log(f"[sgs_decode wide] rows {rows} J {J} M {M} T {T}: "
            f"{'; '.join(parts)}; every route == plain version (plain "
            f"{plain_ms:.1f} ms); bound {bound_ms:.5f} ms ({bound_by}; "
            f"{nbytes} B, {nops} ops), latency floor "
            f"{J * chain / ghz * 1e-6:.4f} ms ({J} chains) ({gpu})")
        if J == 4096:
            block_case = (args, T, out, plain_ms)

    cluster = alibaba_cluster(machines=20)
    dags = synth_trace(128, cluster, seed=3)
    for d in dags:
        d.release_time = 0.0           # the tenants contend for the cores
    template = max(dags, key=lambda d: d.num_tasks)
    sess = Agora(cluster, solver="vectorized", vec_cfg=cfg,
                 device=dev).session(shared_capacity=True, bucket_p=128)
    torch.cuda.synchronize()
    counters = ("launches", "wide_launches", "wide_block_launches")
    for name in counters:
        setattr(kernel.sgs_decode, name, 0)
    t0 = time.monotonic()
    sess.warmup(template)
    warm_s = time.monotonic() - t0
    t0 = time.monotonic()
    with Capture(ops, "sgs_decode", at=cfg.iters // 2) as cap:
        res = sess.plan(dags)
    torch.cuda.synchronize()
    plan_s = time.monotonic() - t0
    launches, wide, block = (getattr(kernel.sgs_decode, n) for n in counters)
    errs = [e for r in res for e in r.validate()]
    joint = [e for r in res for e in r.plan.joint_errors]
    if len(res) != len(dags) or errs or joint:
        fail(f"[pool 128] {len(res)} plans for {len(dags)}, invalid "
             f"{errs[:3]}, joint violations {joint[:3]}")
    need = 2 * (cfg.iters + 2)          # warmup and one batch
    if wide < need or wide != launches or block:
        fail(f"[pool 128] sgs_decode launched {launches} times, {wide} past "
             f"the fast route, {block} on the wide-block route (expected "
             f"{need}, all on the wide route)")
    rows, J = cap.args[0].shape
    log(f"[pool 128] a shared session of 128 tenants (Jmax "
        f"{template.num_tasks}, bucket 128: decode rows {rows}, J {J}) on "
        f"alibaba_cluster(machines=20): warmup {warm_s:.3f} s, a batch of "
        f"128 in {plan_s:.3f} s, every plan valid, no joint violation; "
        f"sgs_decode launches by route: fast {launches - wide}, wide "
        f"{wide - block}, wide-block {block} ({gpu})")
    by_route = {"fast": launches - wide, "wide": wide - block,
                "wide-block": block}
    return by_route, (cap.args, cap.T), block_case, (chain, ghz)


def host_gap(fn, reps: int):
    """Host milliseconds of each of ``reps`` back-to-back calls of ``fn``
    (nothing synchronises between them) and the garbage collector's pauses
    among them: (median, max, [pause ms])."""
    import gc
    import statistics

    import torch
    pauses, started = [], []

    def watch(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((time.perf_counter() - started.pop()) * 1e3)

    fn()
    torch.cuda.synchronize()
    host = []
    gc.callbacks.append(watch)
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
    finally:
        gc.callbacks.remove(watch)
    torch.cuda.synchronize()
    return statistics.median(host), max(host), pauses


# phase 8's archs, each served this many times (the first cold)
SERVED = (("smollm-360m", 2), ("yi-6b", 1), ("granite-20b", 1),
          ("olmoe-1b-7b", 1), ("deepseek-v2-lite-16b", 1),
          ("rwkv6-3b", 1), ("zamba2-2.7b", 1),
          ("llama-3.2-vision-11b", 1), ("musicgen-large", 1))


class Routes:
    """While active, records each call of ``repro_torch.models.moe.route``
    (one a MoE layer and step): its top-k experts (N, k) and router
    probabilities (N, E), on the device they ran on."""

    def __init__(self, moe_mod):
        self.moe, self.seen = moe_mod, []

    def __call__(self, router, xf, cfg):
        probs, tope, topw = self.orig(router, xf, cfg)
        self.seen.append((tope, probs))
        return probs, tope, topw

    def gap(self, k: int) -> float:
        """The smallest gap between a k-th and a (k+1)-th router
        probability over the recorded calls."""
        gaps = []
        for _, p in self.seen:
            top = p.sort(-1, descending=True)[0]
            gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return min(gaps)

    def __enter__(self):
        self.orig, self.moe.route = self.moe.route, self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def step_bytes(model, routed):
    """Bytes of the parameters one decode step must read: each block's
    (the dense prefix's, attention, norms, the router, the shared expert,
    the SSM layers', zamba2's shared attention block once, the VLM's
    cross-attention groups) and the head,
    and of the routed experts the ``routed[i]`` distinct ones of MoE block
    i that the step's tokens went to; the bytes of every expert, which a
    dispatch over the whole (E, cap, d) slot buffer reads; and the bytes of
    zamba2's shared attention block (0 without one), which the step reads
    once in each of its groups."""
    total, experts = _nbytes(model.head), 0
    shared = (0 if model.shared_attn is None else
              sum(_nbytes(w) for leaves in model.shared_attn.values()
                  for w in leaves.values()))
    moe_blocks = [b for b in model.blocks if "moe" in b]
    for blk in [*model.prefix, *model.blocks, *model.cross]:
        for part, leaves in blk.items():
            total += sum(_nbytes(w) for name, w in leaves.items()
                         if part != "moe" or name == "router")
    for blk, n in zip(moe_blocks, routed):
        one = sum(_nbytes(blk["moe"][w][0])
                  for w in ("w_gate", "w_up", "w_down"))
        total += n * one
        experts += blk["moe"]["w_gate"].shape[0] * one
    return total + shared, experts, shared


def cache_bytes(cache):
    """Bytes of a model's cache: (the attention KV cache's; the recurrent
    state's: rwkv6's token shifts and wkv state, zamba2's conv and SSM
    states, which a decode step reads and writes once; the VLM's patch
    cache's, which a step reads once, all of it)."""
    blocks = cache.get("blocks", {})
    state = blocks.get("mamba", blocks if "wkv" in blocks else {})
    state_b = sum(_nbytes(t) for t in _leaves(state))
    patch_b = sum(_nbytes(t) for t in _leaves(
        cache.get("cross_groups", {}).get("cross_kv", {})))
    total = sum(_nbytes(t) for t in _leaves(cache))
    return total - state_b - patch_b, state_b, patch_b


def serve_models(dev, gpu):
    """Phase 8: the dense, MoE and SSM model families and the VLM and audio
    backbones served at full width through
    ``repro_torch.launch.serve_model.serve`` (batch 4, prompt 16, 32 greedy
    tokens, weights drawn from seed 0): ``smollm-360m`` twice (cold,
    warm), ``yi-6b``, ``granite-20b``, ``olmoe-1b-7b``,
    ``deepseek-v2-lite-16b``, ``rwkv6-3b``, ``zamba2-2.7b``,
    ``llama-3.2-vision-11b`` and ``musicgen-large`` once, tokens of the
    right shape in the vocabulary. For each: decode ms per token
    step (CUDA events over 16 warm steps), tokens per second including
    prefill, peak memory, the share of a profiled step's device time in
    matrix products, and the step's least time: the bfloat16 parameters
    it must read once over HBM (attention, norms, the dense prefix, the
    router, the shared expert, the head, and of the routed experts only
    the distinct ones the step's tokens went to, counted from its
    routing), beside the bytes of every expert; for the SSM family, plus
    the float32 recurrent state read and written once, zamba2's shared
    block counted once; for the VLM, plus its patch cache read once.
    ``smollm-360m``'s teacher-forced logits over the
    16 prompt positions, on the card and on the CPU from the same weights, must
    agree within the bfloat16 tolerance of ``tests/_model_cases.py``, and
    run in float32 within its ``f32_tolerance``: bfloat16's tolerance is
    wide enough to pass a wrong computation, float32's is not. Each MoE
    arch's served weights cut to their first 2 layers at full width
    (``deepseek-v2-lite-16b``: its dense prefix and one MoE block, MLA
    absorbed and expanded) run their teacher-forced logits in float32 on
    the card and the CPU: the expert sets must be equal at every token and
    layer, and the logits within ``f32_tolerance``; the smallest gap
    between a k-th and a (k+1)-th router probability is printed. (A model
    drawn at 2 layers is no stand-in: a stacked leaf takes its fan-in from
    the layer axis, so its MoE blocks' matrices come 3-5x larger than the
    served model's.) The SSM archs' own checks are ``ssm_checks``'s, the
    VLM's ``vlm_checks``' and the audio model's ``audio_checks``'.
    Returns ({arch: ms a decode step}, {arch: its serve's peak memory,
    bytes})."""
    import numpy as np
    import torch
    from _model_cases import bf16_tolerance, f32_tolerance
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve_model import frame_table, serve
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model

    B, P, G = 4, 16, 32

    def teacher_forced(model, seq, cache=None):
        """Logits of ``seq`` (tokens (B, S), or embeddings (B, S, d) for a
        model fed them) one decode step a position, from ``cache`` or an
        empty one."""
        cache = model.init_cache(B, P + G) if cache is None else cache
        key = "embeds" if model.cfg.embedding_inputs else "tokens"
        out = []
        for t in range(seq.shape[1]):
            logits, cache = model.decode_step(
                cache, {key: seq[:, t:t + 1]}, t)
            out.append(logits)
        return torch.cat(out, 1), cache

    def float32_pair(served, small, **keep):
        """The served model cut to ``small`` (``keep``: how many entries of
        each layer list of its parameters stay) as float32 models on the
        card and on the CPU, and the CPU's weights' bytes."""
        params = served.params()
        for part, n in keep.items():
            params[part] = params[part][:n]
        card = Model(small, device=dev, params=params)
        host = Model(small, device="cpu", params=card.params())
        return card, host, sum(int(w.numel()) * 4 for w in host.parameters())

    def vlm_checks(arch, cfg, served, prompt, seq):
        """The served VLM's first group at full width, cut to its first M =
        2 self blocks (of 5; the cut keeps the whole run under 900 s),
        group 0's cross-attention sublayer with its gate set to a seeded
        value in [0.5, 1.5) (the drawn gate is zero, which would make the
        sublayer add nothing) and its MLP, and the head. Its patch cache is
        filled from seeded patches (B, 4096, d) x 0.02 through the group's
        ``wk`` and ``wv``. In float32 this group's own rounding reaches
        about 0.001 of its logits (its residual stream grows to an RMS of
        hundreds, its self-attention scores to hundreds): the float32
        logits of the card and of the CPU each part from the float64 ones
        by that much, past ``f32_tolerance(M + 1)``. So the group is held
        in float64, where rounding sits far below that tolerance: the
        teacher-forced logits over the prompt on the card and on the CPU
        within ``f32_tolerance(M + 1)``; then on the card ``Model.forward``
        over the patches against the teacher-forced ``decode_step`` over
        the filled patch cache and the served sequence (48 positions),
        within the same, and again over the patches x 0.2, where the cross
        sublayer must move the logits (its gate at zero against set) by
        more than the tolerance, so that the comparison sees it. The
        float32 card against CPU, and each against float64, are printed
        beside."""
        M = 2
        gen = torch.Generator(device="cpu")
        gen.manual_seed(4)
        gate = 0.5 + float(torch.rand((), generator=gen))
        params = served.params()
        params["blocks"] = params["blocks"][:M]
        params["cross"] = [dict(params["cross"][0])]
        params["cross"][0]["cross"] = {**params["cross"][0]["cross"],
                                       "gate": torch.tensor(gate)}
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        unit = torch.randn(B, cfg.num_patches, cfg.d_model, generator=gen,
                           device=dev)

        def cut(dtype, device, weights):
            return Model(cfg.replace(num_layers=M, cross_attn_every=M,
                                     dtype=dtype, param_dtype=dtype),
                         device=device, params=weights)

        def filled(model, patches):
            cache = model.init_cache(B, P + G)
            w = model.cross[0]["cross"]
            p = patches.to(device=model.device, dtype=w["wk"].dtype)
            for n in ("k", "v"):
                cache["cross_groups"]["cross_kv"][n][0] = torch.einsum(
                    "bpd,dhk->bphk", p, w[f"w{n}"])
            return cache

        tol = f32_tolerance(M + 1)
        logits, size = {}, 0
        for dtype in ("float64", "float32"):
            card = cut(dtype, dev, params)
            host = cut(dtype, "cpu", card.params())
            size = sum(_nbytes(w) for w in host.parameters())
            logits[dtype] = (
                teacher_forced(card, prompt, filled(card, unit * 0.02))[0],
                teacher_forced(host, prompt.cpu(),
                               filled(host, unit * 0.02))[0])
            del host
            if dtype == "float64":
                log(f"[serve {arch}] the served model's first group ({M} "
                    f"self blocks, the cross sublayer, gate {gate:.4f}, "
                    f"patch cache filled from {cfg.num_patches} seeded "
                    f"patches) at full width: {size / 1e9:.2f} GB of "
                    f"float64 weights on the CPU ({gpu})")
                for scale in (0.02, 0.2):
                    patches = unit * scale
                    full, _ = card.forward({"tokens": seq,
                                            "patches": patches})
                    stepped, _ = teacher_forced(card, seq,
                                                filled(card, patches))
                    err = float((full - stepped).abs().max())
                    gate_w = card.cross[0]["cross"]["gate"]
                    gate_w.zero_()
                    bare, _ = card.forward({"tokens": seq,
                                            "patches": patches})
                    gate_w.fill_(gate)
                    moved = float((full - bare).abs().max())
                    log(f"[serve {arch}] on the card, float64, the first "
                        f"group, patches x {scale}: Model.forward over the "
                        f"patches against teacher-forced decode_step over "
                        f"the filled patch cache, {seq.shape[1]} positions: "
                        f"max abs err {err:.3g}, tolerance {tol:.6f}; the "
                        f"cross sublayer moves the logits by up to "
                        f"{moved:.6f} (its gate at zero against set) "
                        f"({gpu})")
                    if err > tol:
                        fail(f"[serve {arch}] forward and decode steps "
                             f"differ by {err}, beyond the tolerance {tol}")
                if moved <= tol:
                    fail(f"[serve {arch}] the cross sublayer moves the "
                         f"logits by {moved}, within the tolerance {tol}: "
                         f"the comparison would not see it")
            del card
        (card64, host64), (card32, host32) = (
            tuple(t.cpu().double() for t in pair)
            for pair in (logits["float64"], logits["float32"]))
        err = float((card64 - host64).abs().max())

        def apart(a, b):
            return float((a - b).abs().max())

        log(f"[serve {arch}] card against CPU, the first group, "
            f"teacher-forced logits over {P} positions: float64 max abs err "
            f"{err:.3g}, tolerance {tol:.6f} (max |logit| "
            f"{float(host64.abs().max()):.4f}); float32 (not held: its "
            f"rounding here) {apart(card32, host32):.6f}, the card's "
            f"float32 from float64 {apart(card32, card64):.6f}, the CPU's "
            f"{apart(host32, host64):.6f} ({gpu})")
        if err > tol:
            fail(f"[serve {arch}] card and CPU float64 logits differ by "
                 f"{err}, beyond the tolerance {tol}")

    def audio_checks(arch, cfg, served, prompt):
        """The served audio model's first 2 layers and its head at full
        width in float32: the teacher-forced logits over the served
        prompt's embeddings on the card and on the CPU within
        ``f32_tolerance(2)``, and on the card its forward against those
        decode steps within the same."""
        small = cfg.replace(num_layers=2, dtype="float32")
        card, host, size = float32_pair(served, small, blocks=2)
        tol = f32_tolerance(small.num_layers)
        got, _ = teacher_forced(card, prompt)
        want, _ = teacher_forced(host, prompt.cpu())
        err = float((got.cpu() - want).abs().max())
        full, _ = card.forward({"embeds": prompt})
        err_fwd = float((full - got).abs().max())
        log(f"[serve {arch}] card against CPU in float32, the served "
            f"model's first 2 layers at full width ({size / 1e9:.2f} GB of "
            f"weights on the CPU), fed the served prompt's embeddings: "
            f"teacher-forced logits over {P} positions max abs err "
            f"{err:.6f}, float32 tolerance {tol:.6f} (max |logit| "
            f"{float(want.abs().max()):.4f}); on the card, Model.forward "
            f"against those decode steps {err_fwd:.6f} ({gpu})")
        if max(err, err_fwd) > tol:
            fail(f"[serve {arch}] float32 logits differ by "
                 f"{max(err, err_fwd)} (card against CPU {err}, forward "
                 f"against decode {err_fwd}), beyond the float32 tolerance "
                 f"{tol}")

    def ssm_checks(arch, cfg, served, prompt, seq):
        """The served SSM model's leading layers at full width in float32
        (``rwkv6-3b``: its first 2 layers; ``zamba2-2.7b``: its first
        group, M Mamba2 layers and the shared block) and its head: the
        teacher-forced logits over the prompt on the card and on the CPU
        within ``f32_tolerance``, each final cache leaf's max abs
        difference printed; then on the card ``Model.forward`` (the chunked
        forms) against the teacher-forced ``decode_step`` (``gla_step``)
        over the served sequence (prompt and generated tokens, 48
        positions: 3 chunks of ``rwkv6``'s 16; zamba2 at its
        ``gla_chunk`` 128, one chunk, and at 16, three), within
        ``f32_tolerance``."""
        zamba = cfg.block_pattern == "zamba2"
        n = cfg.shared_attn_every if zamba else 2
        small = cfg.replace(num_layers=n, dtype="float32")
        card, host, size = float32_pair(served, small, blocks=n)
        tol = f32_tolerance(small.num_layers)
        got, got_cache = teacher_forced(card, prompt)
        want, want_cache = teacher_forced(host, prompt.cpu())
        err = float((got.cpu() - want).abs().max())

        def diffs(w, g, path):
            if isinstance(w, dict):
                for k in w:
                    yield from diffs(w[k], g[k], f"{path}.{k}" if path else k)
            else:
                yield (f"{path} {float((g.cpu() - w).abs().max()):.3g} (max "
                       f"|{path}| {float(w.abs().max()):.4g})")

        leaves = list(diffs(want_cache["blocks"], got_cache["blocks"], ""))
        log(f"[serve {arch}] card against CPU in float32, the served "
            f"model's first {n} layers{' (one group)' if zamba else ''} at "
            f"full width ({size / 1e9:.2f} GB of weights on the CPU): "
            f"teacher-forced logits over {P} positions max abs err "
            f"{err:.6f}, float32 tolerance {tol:.6f} (max |logit| "
            f"{float(want.abs().max()):.4f}); final cache, max abs err: "
            f"{'; '.join(leaves)} ({gpu})")
        if err > tol:
            fail(f"[serve {arch}] card and CPU float32 logits differ by "
                 f"{err}, beyond the float32 tolerance {tol}")
        del host, want_cache
        for chunk in ((small.gla_chunk, 16) if zamba else (None,)):
            m = card if chunk in (None, small.gla_chunk) else Model(
                small.replace(gla_chunk=chunk), device=dev,
                params=card.params())
            chunked, _ = m.forward({"tokens": seq})
            stepped, _ = teacher_forced(m, seq)
            err = float((chunked - stepped).abs().max())
            what = (f"gla_chunk {chunk}, {-(-seq.shape[1] // chunk)} "
                    f"chunk(s)" if zamba else "chunk 16, 3 chunks")
            log(f"[serve {arch}] on the card, float32, {n} layers: "
                f"Model.forward (chunked, {what}) against teacher-forced "
                f"decode_step (gla_step) over {seq.shape[1]} positions: "
                f"max abs err {err:.6f}, float32 tolerance {tol:.6f} "
                f"({gpu})")
            if err > tol:
                fail(f"[serve {arch}] chunked forward and decode steps "
                     f"differ by {err}, beyond the float32 tolerance {tol}")

    def card_against_cpu(arch, cfg, served, prompt):
        """The served MoE model's first 2 layers (its prefix first) and its
        head at full width, in float32, on the card and on the CPU: expert
        sets equal, logits within the float32 tolerance."""
        small = cfg.replace(num_layers=2, dtype="float32")
        card, host, size = float32_pair(served, small,
                                        blocks=2 - cfg.first_dense)
        for absorb in ((True, False) if cfg.mla else (True,)):
            c = small.replace(mla_absorb=absorb)
            with Routes(moe) as on_card:
                got, _ = teacher_forced(Model(c, device=dev,
                                              params=card.params()), prompt)
            with Routes(moe) as on_host:
                want, _ = teacher_forced(Model(c, device="cpu",
                                               params=host.params()),
                                         prompt.cpu())
            if len(on_card.seen) != len(on_host.seen) or not on_card.seen:
                fail(f"[serve {arch}] {len(on_card.seen)} MoE calls on the "
                     f"card, {len(on_host.seen)} on the CPU")
            for i, ((a, _), (b, _)) in enumerate(zip(on_card.seen,
                                                     on_host.seen)):
                if not torch.equal(a.sort(-1)[0].cpu(), b.sort(-1)[0]):
                    fail(f"[serve {arch}] MoE call {i}: the card's expert "
                         f"sets differ from the CPU's")
            err = float((got.cpu() - want).abs().max())
            tol = f32_tolerance(small.num_layers)
            what = f", mla_absorb={absorb}" if cfg.mla else ""
            log(f"[serve {arch}] card against CPU in float32, 2 layers at "
                f"full width{what} ({size / 1e9:.2f} GB of weights on the "
                f"CPU): expert sets equal at all "
                f"{sum(int(a.shape[0]) for a, _ in on_card.seen)} "
                f"token-layer routings ({len(on_card.seen)} MoE calls); "
                f"smallest top-{cfg.top_k} gap {on_card.gap(cfg.top_k)!r} "
                f"(card), {on_host.gap(cfg.top_k)!r} (CPU); logits max abs "
                f"err {err:.6f}, float32 tolerance {tol:.6f} (max |logit| "
                f"{float(want.abs().max()):.4f}) ({gpu})")
            if err > tol:
                fail(f"[serve {arch}] card and CPU float32 logits differ by "
                     f"{err}, beyond the float32 tolerance {tol}")

    decode_ms, peaks = {}, {}
    for arch, runs in SERVED:
        cfg = get_config(arch)
        t_arch = time.monotonic()
        for run in range(runs):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            res = serve(arch, smoke=False, batch=B, prompt_len=P,
                        gen_tokens=G, seed=0, quiet=True, device=dev)
            peak = peaks[arch] = torch.cuda.max_memory_allocated(dev)
            toks = res["tokens"]
            if toks.shape != (B, G) or toks.min() < 0 or \
                    toks.max() >= cfg.vocab_size:
                fail(f"[serve {arch}] tokens {toks.shape} outside the "
                     f"vocabulary")
            log(f"[serve {arch}] {'cold' if run == 0 else 'warm'}: {B} x {G} "
                f"tokens after a prompt of {P} in {res['seconds']:.3f} s, "
                f"{B * (P + G) / res['seconds']:.1f} tokens/s including "
                f"prefill, {res['seconds'] * 1e3 / (P + G):.3f} ms a step "
                f"as served; peak memory {peak / 2 ** 30:.3f} GiB "
                f"({torch.cuda.max_memory_allocated(dev)} B) ({gpu})")
        model = Model(cfg, seed=0, device=dev)
        prompt = torch.as_tensor(res["prompt"], device=dev)
        if not cfg.embedding_inputs:
            prompt = prompt.to(torch.int32)
        logits, cache = teacher_forced(model, prompt)
        if logits.shape != (B, P, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"[serve {arch}] teacher-forced logits "
                 f"{tuple(logits.shape)} not finite")
        if arch == "smollm-360m":
            host = Model(cfg, device="cpu", params=model.params())
            want, _ = teacher_forced(host, prompt.cpu())
            got = logits.float().cpu()
            want = want.float()
            err = float((got - want).abs().max())
            tol = bf16_tolerance(cfg.num_layers, want)
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            log(f"[serve {arch}] teacher-forced logits over {P} prompt "
                f"positions, card against CPU from the same weights: max "
                f"abs err {err:.5f}, mean abs err "
                f"{float((got - want).abs().mean()):.6f}, bfloat16 "
                f"tolerance {tol:.5f} (max |logit| "
                f"{float(want.abs().max()):.4f}); argmax agrees at "
                f"{agree:.4f} of the positions ({gpu})")
            if err > tol:
                fail(f"[serve {arch}] card and CPU logits differ by {err}, "
                     f"beyond the bfloat16 tolerance {tol}")
            # the same weights in float32: the two devices differ only in
            # the order of their float32 sums
            c32 = cfg.replace(dtype="float32")
            got32, _ = teacher_forced(Model(c32, device=dev,
                                            params=model.params()), prompt)
            want32, _ = teacher_forced(Model(c32, device="cpu",
                                             params=host.params()),
                                       prompt.cpu())
            err32 = float((got32.cpu() - want32).abs().max())
            tol32 = f32_tolerance(cfg.num_layers)
            agree32 = float((got32.argmax(-1).cpu() == want32.argmax(-1))
                            .float().mean())
            log(f"[serve {arch}] the same in float32: max abs err "
                f"{err32:.6f}, float32 tolerance {tol32:.6f} (max |logit| "
                f"{float(want32.abs().max()):.4f}); argmax agrees at "
                f"{agree32:.4f} of the positions ({gpu})")
            if err32 > tol32:
                fail(f"[serve {arch}] card and CPU float32 logits differ by "
                     f"{err32}, beyond the float32 tolerance {tol32}")
            del host, got32, want32
        # a warm decode step at position P, timed and profiled
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        feed = ({"embeds": frame_table(cfg, dev)[nxt.long()]}
                if cfg.embedding_inputs else {"tokens": nxt})
        step = lambda: model.decode_step(cache, feed, P)
        with Routes(moe) as routed:
            step()
        distinct = [int(torch.unique(e).numel()) for e, _ in routed.seen]
        ms = decode_ms[arch] = time_ms(step, reps=16)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA)
        mm = sum(e.device_time_total for e in events
                 if e.key in ("aten::mm", "aten::bmm"))
        copies = sum(e.device_time_total for e in events
                     if e.key == "aten::copy_")
        dt = cfg.cdtype
        weights, experts, shared = step_bytes(model, distinct)
        kv, state, patch = cache_bytes(cache)
        # the recurrent state is read and written once a step, the patch
        # cache read once
        bound_ms = (weights + 2 * state + patch) / HBM_BYTES_PER_S * 1e3
        routing = (f"; {distinct} distinct experts of {cfg.num_experts} "
                   f"routed to in its {len(distinct)} MoE layers (mean "
                   f"{sum(distinct) / len(distinct):.2f}); all experts "
                   f"{experts} B, {experts / HBM_BYTES_PER_S * 1e3:.4f} ms, "
                   f"which a dispatch over the whole (E, cap, d) buffer "
                   f"reads" if cfg.moe else "")
        recurrent = (f"; the float32 recurrent state {state} B, read and "
                     f"written once, counted in it" if state else "")
        # the attention upcasts k to float32 (models/layers.py:_sdpa): for
        # the patch cache, a float32 copy of every group's keys a step
        patch_note = (f"; the patch cache {patch} B, read once, counted in "
                      f"it; the float32 copy of its keys the attention "
                      f"makes {patch} B written a step" if patch else "")
        groups = (f"; the shared attention block {shared} B, counted "
                  f"once, {len(model.blocks) // cfg.shared_attn_every * shared}"
                  f" B if read in each of its "
                  f"{len(model.blocks) // cfg.shared_attn_every} groups"
                  if shared else "")
        log(f"[serve {arch}] decode step at batch {B}: {ms:.3f} ms a step "
            f"(CUDA events, 16 warm steps), {B * 1e3 / ms:.1f} tokens/s; "
            f"one profiled step: device busy {busy / 1e3:.3f} ms, of it "
            f"matrix products (aten::mm, aten::bmm) {mm / 1e3:.3f} ms, a "
            f"share of {mm / max(busy, 1e-9):.3f}, copies (aten::copy_) "
            f"{copies / 1e3:.3f} ms; least time {bound_ms:.4f} ms "
            f"({weights} B of parameters a step reads ({dt} matrices), over "
            f"HBM{recurrent}{patch_note}; the KV cache adds {kv} B){groups}"
            f"{routing}, {bound_ms / ms:.3f} of it reached ({gpu})")
        del cache, logits
        if cfg.moe:
            card_against_cpu(arch, cfg, model, prompt)
        seq = None if cfg.embedding_inputs else torch.cat([
            prompt, torch.as_tensor(res["tokens"], dtype=torch.int32,
                                    device=dev)], 1)
        if cfg.block_pattern != "attn":
            ssm_checks(arch, cfg, model, prompt, seq)
        if cfg.cross_attn_every:
            vlm_checks(arch, cfg, model, prompt, seq)
        if cfg.embedding_inputs:
            audio_checks(arch, cfg, model, prompt)
        del model
        torch.cuda.empty_cache()
        log(f"[serve {arch}] phase 8 for this arch took "
            f"{time.monotonic() - t_arch:.1f} s")
    return decode_ms, peaks


def quality_seed(cell: str, seed: int):
    """One cell of phase 7 at one solver seed, in a worker process on the
    card: (mean energy of the seed's plans, number of plans, validation
    errors, seconds), as ``_quality.sweep`` reckons a seed."""
    import importlib

    import numpy as np
    import torch

    import _quality as q

    torch.set_num_threads(1)        # one core a worker
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    api = q.modules({m: importlib.import_module(f"repro_torch.{m}")
                     for m in q.MODULES}, device=dev)
    t0 = time.monotonic()
    energies, errors, _ = q.solve(api, cell, "full", seed)
    return (float(np.mean(energies)), len(energies), errors,
            time.monotonic() - t0)


def quality(dev, gpu):
    """Phase 7: plan quality against the reference (``tests/_quality.py``).
    Each of the four cells of phases 3 and 4 at ``VecConfig()`` /
    ``IsingConfig()`` is solved on the card's production draws for the
    solver seeds of ``tests/torch_golden/quality_full.json`` (the
    reference's energies, written on CPU JAX by
    ``tests/_quality_reference.py``); every plan must be valid and the
    cell must hold the rule. A cell that misses it fails the run. Each
    (cell, seed) is one job of a pool of worker processes (up to 8,
    spawned, joined at the end), all on the one card: each solve is
    seeded, so a seed's plans do not depend on the process that makes
    them, and the host's work, which dominates the solves, runs on as
    many cores as there are workers."""
    import concurrent.futures
    import multiprocessing

    import _quality as q

    with open(os.path.join(ROOT, "tests", "torch_golden",
                           "quality_full.json")) as f:
        golden = json.load(f)["cells"]
    refs = {cell: {int(s): m for s, m in golden[cell]["seeds"].items()}
            for cell in sorted(q.CELLS)}
    # the ising-isolated cell's seeds take longest: first in
    jobs = sorted(((cell, seed) for cell in refs for seed in refs[cell]),
                  key=lambda j: j[0] != "ising-isolated")
    t0 = time.monotonic()
    workers = min(8, os.cpu_count() or 4)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {j: pool.submit(quality_seed, *j) for j in jobs}
        done = {j: f.result() for j, f in futures.items()}
    missed = []
    for cell, ref in refs.items():
        means = {s: done[(cell, s)][:2] for s in sorted(ref)}
        errors = [e for s in sorted(ref) for e in done[(cell, s)][2]]
        if errors:
            fail(f"[quality {cell}] invalid plans: {errors[:3]}")
        holds, mean, bound = q.check({s: m for s, (m, _) in means.items()},
                                     ref)
        log(f"[quality {cell}] seeds {sorted(ref)}, "
            f"{golden[cell]['plans_per_seed']} plans a seed, all valid: the "
            f"port's mean energy {mean!r} against the reference's mean "
            f"{float(sum(ref.values()) / len(ref))!r}, bound {bound!r}: "
            f"{'holds' if holds else 'MISSED'}; port per seed "
            f"{ {s: round(m, 5) for s, (m, _) in means.items()} } in "
            f"{sum(done[(cell, s)][3] for s in ref):.1f} s of solves "
            f"({gpu})")
        if not holds:
            missed.append(cell)
    log(f"[quality] {len(jobs)} seeds of {len(refs)} cells in "
        f"{time.monotonic() - t0:.1f} s ({workers} worker processes on the "
        f"one card)")
    if missed:
        fail(f"[quality] the rule is missed in {missed}")


# --- phase 9: training -------------------------------------------------------

# 9a's cell: smollm-360m at full width and depth, batch 8 x sequence 2048
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "smollm-360m", 8, 2048, 20
BF16_OPS_PER_S = 989e12      # bfloat16 dense on the tensor cores
# 9c: the first 2 layers of one arch a distinct backward (dense, MoE
# dispatch with its load-balance loss, the chunked RWKV6 recurrence), at
# (batch, sequence)
CARD_VS_CPU = (("smollm-360m", 2, 256), ("olmoe-1b-7b", 2, 64),
               ("rwkv6-3b", 2, 64))


def train_flops(cfg, B, S, n_params):
    """(model FLOPs of one training step, of them the float32 score
    products): 6 N T for the parameters' products, forward and backward
    (the tied head counted in N), plus the attention's two S x S products
    a layer, counted whole (the port computes every score, then masks),
    three times (the forward and the two products of each one's backward).
    The score products q k^T and the two of their backward take float32
    operands (``models/layers.py:_sdpa``)."""
    product = 2 * B * cfg.num_heads * S * S * cfg.head_dim
    return (6 * n_params * B * S + 2 * 3 * product * cfg.num_layers,
            3 * product * cfg.num_layers)


def train_models(dev, gpu):
    """Phase 9: training (``repro_torch.launch.train.train``), in four
    parts: ``train_smollm`` (a), ``train_resume`` (b), ``train_card_vs_cpu``
    (c) and ``train_ring`` (d). Returns 9a's warm step ms."""
    step_ms = train_smollm(dev, gpu)
    train_resume(dev, gpu)
    train_card_vs_cpu(dev, gpu)
    train_ring(dev, gpu)
    return step_ms


def product_census():
    """A ``TorchDispatchMode`` that, while active, counts the matrix
    products that run, by (op, dtype, operand shapes and strides), in its
    ``calls``."""
    import collections

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    products = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in products:
                a, b = args[0], args[1]
                self.calls[(func, a.dtype, tuple(a.shape), a.stride(),
                            tuple(b.shape), b.stride())] += 1
            return func(*args, **(kwargs or {}))
    return Census()


def train_smollm(dev, gpu):
    """Phase 9a: ``smollm-360m`` at full width and depth, weights from seed
    0, batch 8 x sequence 2048, 20 steps at lr 1e-3, remat "full", through
    ``train``: every loss and gradient norm finite, the mean loss of the
    last 5 steps below that of the first 5. The trainer's own steps are
    measured, its ``make_train_step`` wrapped: each step timed with CUDA
    events (a warm step: the median of steps 2-15), step 16 run under a
    dispatch census of its matrix products (the float32 ones then timed
    apart at their shapes and counts), step 18 under the profiler (device
    busy, the matrix products' share, the top kernels and ops). Then the
    AdamW update timed apart on the trained state, under deterministic
    algorithms as the trainer runs it and without, a warm step without
    them, peak memory, and the step's least time."""
    import contextlib
    import statistics

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import deterministic, train
    from repro_torch.models.common import param_count
    from repro_torch.optim import adamw

    B, S, STEPS = TRAIN_B, TRAIN_S, TRAIN_STEPS
    CENSUS_AT, PROFILE_AT = 16, 18
    cfg = get_config(TRAIN_ARCH)
    census = product_census()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    timed, made = [], {}
    orig = train_mod.make_train_step

    def measured(model, opt_cfg, grad_accum=1):
        step = orig(model, opt_cfg, grad_accum)
        made.update(model=model, opt_cfg=opt_cfg, step=step)

        def run(state, batch):
            i = len(timed)
            ctx = {CENSUS_AT: census, PROFILE_AT: prof}.get(
                i, contextlib.nullcontext())
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with ctx:
                a.record()
                out = step(state, batch)
                b.record()
                if i == PROFILE_AT:
                    torch.cuda.synchronize()
            timed.append((a, b))
            return out
        return run

    def operand(shape, stride, dtype):
        size = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
        return torch.randn(size, device=dev).to(dtype).as_strided(shape,
                                                                  stride)

    t0 = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    train_mod.make_train_step = measured
    try:
        out = train(TRAIN_ARCH, smoke=False, steps=STEPS, batch=B, seq=S,
                    lr=1e-3, seed=0, device=dev, quiet=True)
    finally:
        train_mod.make_train_step = orig
    train_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses, norms = out["losses"], out["grad_norms"]
    if len(losses) != STEPS or not np.isfinite(losses + norms).all():
        fail(f"[train {TRAIN_ARCH}] losses {losses} grad norms {norms}: "
             f"not {STEPS} finite steps")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"[train {TRAIN_ARCH}] {STEPS} steps of {B} x {S} tokens through "
        f"train() in {train_s:.2f} s (the first step's warmup included): "
        f"loss {losses[0]:.4f} at step 0, {losses[-1]:.4f} at step "
        f"{STEPS - 1}; mean of the first 5 {first5:.4f}, of the last 5 "
        f"{last5:.4f}; grad norms {norms[0]:.3f} .. {norms[-1]:.3f}; peak "
        f"memory {peak / 2 ** 30:.3f} GiB ({peak} B) ({gpu})")
    if not last5 < first5:
        fail(f"[train {TRAIN_ARCH}] the loss does not fall: mean of the "
             f"last 5 steps {last5} against the first 5 {first5}")
    step_ms = [a.elapsed_time(b) for a, b in timed]
    ms = statistics.median(step_ms[2:CENSUS_AT])
    model, opt_cfg, state = made["model"], made["opt_cfg"], out["opt_state"]
    del out
    def update():
        # the update's work does not depend on the values: the parameters
        # stand in for gradients of their shapes
        adamw.update(model.params(), model.params(), state, opt_cfg)

    with deterministic(dev):          # as the trainer runs it
        adamw_ms = time_ms(update, reps=5)
    adamw_free_ms = time_ms(update, reps=5)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=0)).batch_at(STEPS).items()}
    # a step without deterministic algorithms: what exact resume costs
    free_ms = time_ms(lambda: made["step"](state, batch), reps=1)
    events = prof.key_averages()
    busy = max(sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA) / 1e3, 1e-9)
    mm = sum(e.device_time_total for e in events
             if e.key in ("aten::mm", "aten::bmm")) / 1e3
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:8]
    # the ops that launched them, by the device time of their own kernels
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:10]
    f32_ms, f32_calls, f32_shapes = 0.0, 0, 0
    for (op, dtype, sa, ta, sb, tb), n in census.calls.items():
        if dtype != torch.float32:
            continue
        a, b = operand(sa, ta, dtype), operand(sb, tb, dtype)
        f32_ms += n * time_ms(lambda: op(a, b), reps=3)
        f32_calls += n
        f32_shapes += 1
        del a, b
    n_params = param_count(model.params())
    flops, f32_flops = train_flops(cfg, B, S, n_params)
    ops_ms = ((flops - f32_flops) / BF16_OPS_PER_S
              + f32_flops / FP32_OPS_PER_S) * 1e3
    adamw_bytes = 4 * n_params * 7      # params r+w, grad r, mu, nu r+w
    adamw_bound = adamw_bytes / HBM_BYTES_PER_S * 1e3
    least = max(ops_ms, adamw_bound)
    log(f"[train {TRAIN_ARCH}] a warm step: {ms:.2f} ms (CUDA events, the "
        f"median of steps 2-{CENSUS_AT - 1}; {min(step_ms[2:CENSUS_AT]):.2f} "
        f"to {max(step_ms[2:CENSUS_AT]):.2f}), {B * S * 1e3 / ms:.0f} "
        f"tokens/s; step 0 {step_ms[0]:.2f} ms; one profiled step: "
        f"device busy {busy:.2f} ms, of it matrix products (aten::mm, "
        f"aten::bmm) {mm:.2f} ms, a share of {mm / busy:.3f}; the float32 "
        f"products of a step ({f32_calls} calls of {f32_shapes} shapes, "
        f"the scores q k^T and their backward) timed apart {f32_ms:.2f} ms, "
        f"{f32_ms / busy:.3f} of busy; the AdamW update timed apart "
        f"{adamw_ms:.2f} ms as the trainer runs it, {adamw_ms / busy:.3f} of "
        f"busy; without deterministic algorithms the update takes "
        f"{adamw_free_ms:.2f} ms and a warm step {free_ms:.2f} ms ({gpu})")
    log(f"[train {TRAIN_ARCH}] least time {least:.2f} ms: {n_params} "
        f"parameters, {flops / 1e12:.2f} TFLOP a step, {f32_flops / 1e12:.2f} "
        f"of them float32 score products at {FP32_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s, the rest at {BF16_OPS_PER_S / 1e12:.0f} bfloat16: "
        f"{ops_ms:.2f} ms; the AdamW update's {adamw_bytes} B over HBM "
        f"{adamw_bound:.2f} ms; the warm step is {ms / least:.2f} times "
        f"it ({least / ms:.3f} of the bound reached) ({gpu})")
    log(f"[train {TRAIN_ARCH}] the profiled step's top kernels: " + "; ".join(
        f"{e.key[:70]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
        for e in kernels))
    log(f"[train {TRAIN_ARCH}] the profiled step's top ops by their own "
        f"kernels' device time: " + "; ".join(
            f"{e.key} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
            for e in ops))
    del model, made, state, batch, prof, events
    torch.cuda.empty_cache()
    return ms


def train_resume(dev, gpu):
    """Phase 9b: ``smollm-360m`` at full width cut to its first 4 layers
    (the seed-0 draw of the whole model, cut: drawn at 4 layers, its
    stacked leaves would take a fan-in of 4), 8 steps of batch 8 x 2048
    with a checkpoint every 4: a run that dies at step 6 and resumes from
    step 4 must end with params and optimizer state equal bit for bit to
    an uninterrupted run; each save's and restore's seconds and bytes. The
    checkpoints go to a temporary directory, removed at the end."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import flatten, leaves

    B, S = TRAIN_B, TRAIN_S
    made = []

    class Recorded(train_mod.Checkpointer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    params = init_params(get_config(TRAIN_ARCH), seed=0, device=dev,
                         dtype=torch.float32)
    params["blocks"] = params["blocks"][:4]
    kw = dict(arch=TRAIN_ARCH, smoke=False, steps=8, batch=B, seq=S,
              lr=1e-3, ckpt_every=4, seed=0, device=dev, quiet=True,
              config_overrides={"num_layers": 4}, params=params)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    orig, train_mod.Checkpointer = train_mod.Checkpointer, Recorded
    try:
        t0 = time.monotonic()
        whole = train(**kw)
        try:
            train(ckpt_dir=tmp, die_at_step=6, **kw)
        except RuntimeError as e:
            if "injected preemption" not in str(e):
                raise
        else:
            fail("[train resume] the run did not die at step 6")
        resumed = train(ckpt_dir=tmp, **kw)
        resume_s = time.monotonic() - t0
    finally:
        train_mod.Checkpointer = orig
        shutil.rmtree(tmp, ignore_errors=True)
    if resumed["steps_run"] != 4:
        fail(f"[train resume] {resumed['steps_run']} steps after the "
             f"resume, expected 4")
    unequal = []
    for tree in ("params", "opt_state"):
        for (k, a), b in zip(flatten(whole[tree]), leaves(resumed[tree])):
            if not torch.equal(a, b):
                unequal.append((f"{tree}/{k}", float(
                    (a.double() - b.double()).abs().max())))
    ck_log = [e for c in made for e in c.log]
    log(f"[train resume] full width, 4 layers, {B} x {S} tokens, 8 steps, a "
        f"checkpoint every 4: died at step 6, resumed from step "
        f"{ck_log[1]['step'] if len(ck_log) > 1 else None}; "
        + "; ".join(f"{e['op']} step {e['step']}: {e['bytes']} B in "
                    f"{e['seconds']:.3f} s"
                    + (f" (host copy {e['copy_seconds']:.3f} s)"
                       if e["op"] == "save" else "") for e in ck_log)
        + f"; the three runs {resume_s:.1f} s; losses after the resume "
        f"{resumed['losses']} against {whole['losses'][4:]} ({gpu})")
    if unequal:
        fail(f"[train resume] {len(unequal)} leaves of the resumed run "
             f"differ from the uninterrupted run's: {unequal[:5]}")
    log(f"[train resume] params and optimizer state of the resumed run "
        f"equal bit for bit to the uninterrupted run's "
        f"({len(leaves(whole['params']))} + "
        f"{len(leaves(whole['opt_state']))} leaves)")
    del whole, resumed
    torch.cuda.empty_cache()


def train_card_vs_cpu(dev, gpu):
    """Phase 9c: the first 2 layers of ``smollm-360m``, ``olmoe-1b-7b`` and
    ``rwkv6-3b`` (one distinct backward each: dense, MoE dispatch with its
    load-balance loss, the chunked RWKV6 recurrence), drawn whole from seed
    0 and cut, in float32 on the card (as the trainer runs it, under
    deterministic algorithms) and on the CPU, and in float64 on the card
    from the same weights (the gradient to the precision that matters):
    the float32 losses within ``f32_tolerance(2)`` of each other; every
    float32 gradient leaf of the card within ``card_grad_rtol`` of its
    largest from the float64 one, a rule the CPU's own float32 error
    sets (``tests/_model_cases.py``); olmoe's expert sets equal on the
    three; for smollm one ``make_train_step`` on
    each float32 side, the params within ``first_step_error``'s bound at
    the gradients' allowance."""
    import numpy as np
    import torch
    from _model_cases import (card_grad_rtol, f32_tolerance,
                              first_step_error, grad_error)

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import deterministic
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten, leaves

    for arch, b9, s9 in CARD_VS_CPU:
        t0 = time.monotonic()
        full = get_config(arch)
        small = full.replace(num_layers=2, dtype="float32")
        params = init_params(full, seed=0, device=dev, dtype=torch.float32)
        params["blocks"] = params["blocks"][:2]
        card = Model(small, device=dev, params=params, trainable=True)
        del params
        torch.cuda.empty_cache()
        host = Model(small, device="cpu", params=card.params(),
                     trainable=True)
        exact = Model(small.replace(dtype="float64", param_dtype="float64"),
                      device=dev, params=card.params(), trainable=True)
        size = sum(_nbytes(w) for w in host.parameters())
        rng = np.random.default_rng(1)
        labels = rng.integers(0, full.vocab_size, (b9, s9)).astype(np.int32)
        labels[0, :3] = -1
        batch = {"tokens": rng.integers(0, full.vocab_size, (b9, s9)).astype(
            np.int32), "labels": labels}
        got = {}
        for side, m in (("card", card), ("cpu", host), ("float64", exact)):
            with deterministic(m.device), Routes(moe) as routed:
                loss, _ = m.loss(batch)
                grads = torch.autograd.grad(loss, leaves(m.params()))
            # compared on the card, in float64
            got[side] = (float(loss.detach()),
                         [g.to(dev, torch.float64) for g in grads],
                         [e.cpu() for e, _ in routed.seen])
            del grads
        del exact
        names = [k for k, _ in flatten(host.params())]
        tol_loss = f32_tolerance(2)
        err_loss = abs(got["card"][0] - got["cpu"][0])
        g_card, g_cpu, g64 = (dict(zip(names, got[k][1]))
                              for k in ("card", "cpu", "float64"))
        e_card = {k: grad_error(g_card[k], g64[k]) for k in names}
        e_cpu = {k: grad_error(g_cpu[k], g64[k]) for k in names}
        rtol = {k: card_grad_rtol(e_cpu[k], 2) for k in names}
        worst = max(names, key=lambda k: e_card[k] / rtol[k])
        e_apart = {k: grad_error(g_card[k], g_cpu[k]) for k in names}
        apart = max(names, key=e_apart.get)
        routing = ""
        if small.moe:
            calls = [got[k][2] for k in ("card", "cpu", "float64")]
            if len({len(c) for c in calls}) != 1 or not calls[0]:
                fail(f"[train card-vs-cpu {arch}] MoE calls "
                     f"{[len(c) for c in calls]} on the card, the CPU and "
                     f"in float64")
            for i, sets in enumerate(zip(*calls)):
                first = sets[0].sort(-1)[0]
                if not all(torch.equal(first, e.sort(-1)[0]) for e in sets):
                    fail(f"[train card-vs-cpu {arch}] MoE call {i}: the "
                         f"expert sets differ between the card, the CPU and "
                         f"float64")
            routing = (f"; expert sets equal in all {len(calls[0])} MoE "
                       f"calls")
        log(f"[train card-vs-cpu {arch}] the first 2 layers at full width "
            f"({size / 1e9:.3f} GB of float32 weights on the CPU, as much "
            f"again of gradients), {b9} x {s9} "
            f"tokens: float32 loss {got['cpu'][0]:.6f}, card against CPU "
            f"{err_loss:.3g} (tolerance {tol_loss:.6f}), against float64 "
            f"{got['card'][0] - got['float64'][0]:.3g} and "
            f"{got['cpu'][0] - got['float64'][0]:.3g}; float32 gradients "
            f"against float64, the worst leaf against its rule {worst}: card "
            f"{e_card[worst]:.3g}, CPU {e_cpu[worst]:.3g} of its largest "
            f"(rule {rtol[worst]:.3g}); the most apart, card against CPU, "
            f"{apart} at {e_apart[apart]:.3g}; over "
            f"{len(names)} leaves{routing} ({gpu})")
        if err_loss > tol_loss or e_card[worst] > rtol[worst]:
            fail(f"[train card-vs-cpu {arch}] loss {err_loss} (tolerance "
                 f"{tol_loss}) or gradient {worst} {e_card[worst]} (rule "
                 f"{rtol[worst]}) beyond the float32 rule")
        if arch == TRAIN_ARCH:
            ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
            old = {k: p.detach().clone() for k, p in flatten(host.params())}
            states = [make_train_step(m, ocfg)(adamw.init(m.params(), ocfg),
                                               batch)[0] for m in (card, host)]
            # the gradient the step applied, clipped: mu / (1 - b1) at step 1
            applied = {k: m / (1 - ocfg.b1) for k, m in flatten(states[1].mu)}
            del g_card, g_cpu, g64
            ratios = {k: first_step_error(
                a.detach().cpu().numpy(), b.detach().numpy(), old[k].numpy(),
                applied[k].numpy(), ocfg.lr, rtol[k] + e_cpu[k])
                for (k, a), b in zip(flatten(card.params()),
                                     leaves(host.params()))}
            worst = max(ratios, key=ratios.get)
            log(f"[train card-vs-cpu {arch}] one make_train_step (lr "
                f"{ocfg.lr}) on each side in float32: the updated params' "
                f"worst leaf {worst} at {ratios[worst]:.3g} of its "
                f"first-step bound ({gpu})")
            if ratios[worst] > 1.0:
                fail(f"[train card-vs-cpu {arch}] updated params {worst} "
                     f"beyond the first-step bound ({ratios[worst]})")
        del card, host, got
        torch.cuda.empty_cache()
        log(f"[train card-vs-cpu {arch}] took {time.monotonic() - t0:.1f} s")


def train_ring(dev, gpu):
    """Phase 9d: ``ring_allreduce_int8`` over 8 replicas on the card of a
    gradient of ``smollm-360m``'s ``w_gate`` shape: the replicas identical
    and equal bit for bit to the CPU's ring of the same inputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import compressed

    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    shape = (cfg.d_model, cfg.d_ff)            # smollm-360m's w_gate
    xs = [torch.randn(shape, generator=gen, device=dev) * 1e-3
          for _ in range(8)]
    got = compressed.ring_allreduce_int8(xs)
    want = compressed.ring_allreduce_int8([x.cpu() for x in xs])
    identical = all(torch.equal(g, got[0]) for g in got)
    equal = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    exact = torch.stack(xs).mean(0)
    rel = float((got[0] - exact).norm() / exact.norm())
    ring_ms = time_ms(lambda: compressed.ring_allreduce_int8(xs), reps=3)
    log(f"[train ring] ring_allreduce_int8 over 8 replicas on the card of a "
        f"{shape} gradient: replicas identical {identical}, equal bit for "
        f"bit to the CPU's ring {equal}, relative error against the exact "
        f"mean {rel:.4g}; {ring_ms:.2f} ms a reduce ({gpu})")
    if not (identical and equal):
        fail("[train ring] the card's ring differs between replicas or from "
             "the CPU's")


# --- phase 10: the dry run, its roofline against the card, GPipe ----------

# 10b's cells: phase 9a's training step and phase 8's decode step of the
# same arch, each as a shape of its own
DRY_TRAIN = ("train_8x2048", TRAIN_S, TRAIN_B, "train")
DRY_DECODE = ("decode_4x48", 48, 4, "decode")     # phase 8: 16 + 32 tokens
# 10c: GPipe over a (1, 4) ("data", "stage") mesh of the one card, and
# over a (1, 2, 4) ("data", "stage", "model") one: (stages, model ranks)
PP_B, PP_S, PP_STAGES, PP_MICRO = 8, 512, 4, 4
PP_MODEL = (2, 4)


def dryrun_models(dev, gpu, train_ms, decode_ms):
    """Phase 10: ``dryrun_cells`` (a), ``dryrun_shard_step``,
    ``dryrun_against_card`` (b) and ``gpipe`` (c). Returns the one-entry
    trace's bytes of phase 11a's step, which phase 11 must measure."""
    dryrun_cells(gpu)
    step = dryrun_shard_step(gpu)
    dryrun_against_card(dev, gpu, train_ms, decode_ms)
    gpipe(dev, gpu)
    return step


# phase 11a's decode step: batch, prompt, generated tokens
SHARD_STEP = (4, 16, 16)


def moe_step_bytes(cfg, B, D, M, esize, aux_size):
    """The bytes of each collective kind in one decode step of the MoE
    attention family (``olmoe-1b-7b``) on a (D, M) mesh, batch B,
    activations of ``esize`` bytes, the load-balance loss of ``aux_size``
    (every participant's output): all-reduce M B d esize x (1 + L) (the
    embedding's vocabulary shards, each layer's row-parallel attention)
    and L x 2 D M aux_size (the load-balance loss's pmean over data and
    model); all-to-all L x 2 directions x D M entries x (E / M, M cap, d)
    esize (cap from a data row's B / D tokens); all-gather M B V esize
    (the logits' vocabulary shards)."""
    from repro_torch.models import moe
    L, E, d = cfg.num_layers, cfg.num_experts, cfg.d_model
    cap = moe.capacity(B // D, cfg)
    act = M * B * d * esize
    return {"all-reduce": act * (1 + L) + L * 2 * D * M * aux_size,
            "all-to-all": L * 2 * D * M * E * cap * d * esize,
            "all-gather": M * B * cfg.vocab_size * esize}


def dryrun_shard_step(gpu):
    """Phase 10's check of the one-entry trace (no card time): phase 11a's
    ``olmoe-1b-7b`` decode step (published size, bfloat16, batch 4, a
    cache of 48 written at position 16) traced on a (2, 4) mesh of
    ``meta`` entries, entry (0, 0) for all: its collective bytes by kind
    equal to ``moe_step_bytes``. Returns them: phase 11 must measure the
    same on the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.steps import StepBundle
    from repro_torch.models.transformer import Model

    t0 = time.monotonic()
    cfg = get_config(SHARD_ARCH)
    B, P, G = SHARD_STEP
    mesh = DeviceMesh(np.full((2, 4), torch.device("meta"), dtype=object),
                      ("data", "model"))
    model = Model(cfg, device="meta", mesh=mesh)
    cache = model.init_cache(B, P + G)
    batch = {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                   device="meta")}
    rec = dr.trace(StepBundle(lambda: model.decode_step(cache, batch, P),
                              (), (), None), mesh=mesh)
    got = {k: v for k, v in rec["coll"].items() if v}
    want = moe_step_bytes(cfg, B, 2, 4, 2, 4)
    log(f"[dryrun shard {SHARD_ARCH}] phase 11a's decode step (batch {B}, "
        f"a cache of {P + G}, position {P}) traced on a (2, 4) mesh of meta "
        f"entries, entry (0, 0) for all 8: collective bytes {got}, the "
        f"formula {want}; {rec['flops']:.6g} FLOP, {rec['bytes']:.6g} B "
        f"unfused; traced in {time.monotonic() - t0:.1f} s ({gpu})")
    if got != want:
        fail(f"[dryrun shard {SHARD_ARCH}] the one-entry trace's collective "
             f"bytes {got}, the formula {want}")
    return got


def dryrun_cells(gpu):
    """Phase 10a: ``run_roofline_cell`` for the ten archs x the four shapes
    on the (16, 16) production mesh of ``meta`` entries, a cell a worker
    process at a time (up to 8, spawned, joined at the end): every cell
    ``ok``, or ``skip`` with the reference's reason where ``runnable``
    gives one (``long_500k`` for the archs with full attention). The
    sharded program is traced, one entry for all, so every ``ok`` cell
    moves collective bytes (16 divides every published vocabulary: the
    embedding and the logits move at least). One line a cell: its three
    terms at 256 H100s (the collective term at the data sheet's NVLink
    rate), its collective bytes by kind, the dominant term, the roofline
    fraction, and the per-device argument bytes against one card's
    memory; then the cells the collective term dominates."""
    import concurrent.futures
    import multiprocessing

    import torch

    from repro_torch import roofline as rl
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import shapes as shp

    t0 = time.monotonic()
    bound = []
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    cells = [(a, s) for a in ARCH_IDS for s in shp.SHAPES]
    # the SSM archs' chunked recurrences trace longest: first in
    heavy = [c for c in cells if get_config(c[0]).block_pattern != "attn"]
    order = heavy + [c for c in cells if c not in heavy]
    workers = min(8, os.cpu_count() or 4)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {c: pool.submit(dr.run_roofline_cell, *c) for c in order}
        recs = {c: f.result() for c, f in futures.items()}
    counts = {"ok": 0, "skip": 0}
    for arch, shape in cells:
        rec = recs[(arch, shape)]
        reason = shp.runnable(get_config(arch), shp.SHAPES[shape])
        want = "skip" if reason else "ok"
        if rec["status"] != want or rec.get("reason") != reason:
            fail(f"[dryrun {arch} x {shape}] {rec['status']} "
                 f"({rec.get('reason') or rec.get('error')}), expected "
                 f"{want}\n{rec.get('trace', '')}")
        counts[want] += 1
        if reason:
            log(f"[dryrun {arch} x {shape}] skip: {reason}")
            continue
        if not rec["collective_total"] > 0:
            fail(f"[dryrun {arch} x {shape}] collective bytes "
                 f"{rec['collective_bytes']}: the sharded program moves "
                 f"the embedding's and the logits' vocabulary shards at "
                 f"least")
        arg = rec["memory"]["argument_bytes"]
        coll = {k: v for k, v in rec["collective_bytes"].items() if v}
        if rec["dominant"] == "collective":
            bound.append(f"{arch} x {shape}")
        log(f"[dryrun {arch} x {shape}] {rec['mesh']} ({rec['chips']} "
            f"H100s): t_compute {rec['t_compute'] * 1e3:.3f} ms, t_memory "
            f"{rec['t_memory'] * 1e3:.3f} ms (unfused), t_memory_est "
            f"{rec['t_memory_est'] * 1e3:.3f} ms, t_collective "
            f"{rec['t_collective'] * 1e3:.3f} ms at "
            f"{rl.NVLINK_BW / 1e9:.0f} GB/s a card (the data sheet's "
            f"NVLink rate); collective bytes {coll}; dominant "
            f"{rec['dominant']} (with the estimate: {rec['dominant_est']}); "
            f"roofline fraction {rec['roofline_fraction']:.4f} (with the "
            f"estimate {rec['roofline_fraction_est']:.4f}); "
            f"{rec['hlo_flops']:.4g} FLOP, {rec['hlo_bytes']:.4g} B, model "
            f"FLOPs {rec['model_flops']:.4g}; argument bytes per device "
            f"{arg} ({arg / card_bytes:.3f} of the card's {card_bytes} B); "
            f"traces {rec['compile_s']} s ({gpu})")
    log(f"[dryrun] {counts['ok']} cells ok, {counts['skip']} skipped as the "
        f"reference skips them, on the (16, 16) mesh of meta entries, the "
        f"sharded program traced one entry for all, in "
        f"{time.monotonic() - t0:.1f} s ({workers} worker processes; "
        f"{sum(r.get('compile_s', 0) for r in recs.values()):.1f} s of "
        f"traces); dominated by the collective term: {len(bound)} cells "
        f"{bound} ({gpu})")


def dryrun_against_card(dev, gpu, train_ms, decode_ms):
    """Phase 10b: ``smollm-360m``'s training step of phase 9a (batch 8 x
    2048, remat "full") and decode step of phase 8 (batch 4, a cache of
    48) traced on ``meta`` under ``torch.utils.flop_counter.
    FlopCounterMode``, then run once for real on the card (weights from
    seed 0) under the same counter: the two counts must be equal (the
    meta trace is the program the card runs), ``torch.profiler``'s
    ``with_flops`` sum printed beside them. Each record then goes to the
    port's ``RooflinePredictor`` (one chip, no collective bytes), with the
    unfused bytes of the trace and with the roofline's fused estimate; the
    predicted step beside the one phases 9a and 8 measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import roofline as rl
    from repro_torch.core.predictor import RooflinePredictor, RooflineRecord
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.shapes import ShapeSpec

    t0 = time.monotonic()
    predictor = RooflinePredictor()
    for spec, measured in ((DRY_TRAIN, train_ms), (DRY_DECODE, decode_ms)):
        shape = ShapeSpec(*spec)
        bundle, cfg, _, _ = dr.lower_cell(
            TRAIN_ARCH, "", make_mesh_for(["meta"], 1), shape=shape)
        counter = FlopCounterMode(display=False)
        rec = dr.trace(bundle, modes=(counter,))
        meta_flops = counter.get_total_flops()
        del bundle
        card, *_ = dr.lower_cell(TRAIN_ARCH, "", make_mesh_for([dev], 1),
                                 shape=shape, device=dev)
        with FlopCounterMode(display=False) as counter:
            card.fn(*card.args)
            torch.cuda.synchronize()
        card_flops = counter.get_total_flops()
        # apart: under a dispatch mode the profiler sees each op twice
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            card.fn(*card.args)
            torch.cuda.synchronize()
        prof_flops = sum(e.flops for e in prof.key_averages())
        del card, prof
        torch.cuda.empty_cache()
        log(f"[dryrun card {shape.name}] {TRAIN_ARCH} {shape.kind} step "
            f"(batch {shape.global_batch}, {shape.seq_len} positions): "
            f"FlopCounterMode counts {meta_flops} FLOP traced on meta, "
            f"{card_flops} run on the card; the dry run's counter "
            f"{rec['flops']:.0f} FLOP, {rec['bytes']:.0f} B unfused; "
            f"torch.profiler with_flops {prof_flops} ({gpu})")
        if meta_flops != card_flops or rec["flops"] != meta_flops:
            fail(f"[dryrun card {shape.name}] the meta trace's "
                 f"{meta_flops} FLOP (dry-run counter {rec['flops']}) are "
                 f"not the card's {card_flops}")
        est = rl.estimate_hbm_bytes(cfg, shape, shape.kind)
        for name, nbytes in (("unfused bytes", rec["bytes"]),
                             ("fused estimate", est)):
            key = f"{shape.name} {name}"
            predictor.add(key, RooflineRecord(rec["flops"], nbytes, 0.0, 1))
            ms = predictor.predict(key) * 1e3
            log(f"[dryrun card {shape.name}] predicted with the {name} "
                f"({nbytes:.4g} B): {ms:.3f} ms (compute "
                f"{rec['flops'] / rl.PEAK_FLOPS * 1e3:.3f} ms at "
                f"{rl.PEAK_FLOPS / 1e12:.0f} TFLOP/s, memory "
                f"{nbytes / rl.HBM_BW * 1e3:.3f} ms at "
                f"{rl.HBM_BW / 1e12:.2f} TB/s); measured {measured:.3f} ms "
                f"(phase {9 if shape.kind == 'train' else 8}); measured / "
                f"predicted {measured / ms:.3f} ({gpu})")
    log(f"[dryrun card] took {time.monotonic() - t0:.1f} s")


def gpipe(dev, gpu):
    """Phase 10c: ``pp_loss_fn`` for ``smollm-360m`` at full width and depth
    (32 layers, d_model 960) in float32, remat "none", weights from seed
    0, a batch of 8 x 512 seeded tokens, 4 microbatches, on a ("data",
    "stage") (1, 4) mesh whose entries are all the card (the model built
    with ``mesh=None``: the embedding and head on the card), and on a
    ("data", "stage", "model") (1, 2, 4) mesh of the card with the model
    built on it (the embedding and head sharded over 4 model ranks, the
    blocks over 2 stages), each against the unstaged ``Model.loss`` on
    the same card and weights: the loss within 2e-4
    (``tests/test_distributed.py``'s rule); every gradient leaf, against
    the unstaged step's in float64, within ``card_grad_rtol`` of its
    largest, a rule the unstaged float32 step's own error sets (at this
    width float32 parts from float64 by about 1e-2 of a leaf's largest on
    any device, and pipelining only reorders float32 sums); the bytes of
    a step (forward and backward) equal to the formula (``gpipe_bytes``).
    Each step's ms (forward and backward, CUDA events) and peak memory
    beside the peak the dry run's counter reckons from a ``meta`` trace
    of the (1, 4) and unstaged steps, and the schedule's bubble."""
    import numpy as np
    import torch
    from _model_cases import card_grad_rtol, grad_error

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.steps import StepBundle
    from repro_torch.models.pipeline import STAGE_AXIS, pp_loss_fn
    from repro_torch.models.transformer import Model

    t0 = time.monotonic()
    cfg = get_config(TRAIN_ARCH).replace(dtype="float32", remat="none")
    rng = np.random.default_rng(0)
    tokens = {k: rng.integers(0, cfg.vocab_size, (PP_B, PP_S))
              for k in ("tokens", "labels")}

    def pp_mesh(device, shape, names):
        return DeviceMesh(np.full(shape, torch.device(device), dtype=object),
                          names)

    def step(model, device, mesh=None):
        """The step (loss and its gradients) on ``device``: pipelined over
        ``mesh``, or unstaged."""
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in tokens.items()}
        loss_fn = (pp_loss_fn(model, mesh, PP_MICRO) if mesh is not None
                   else model.loss)
        weights = list(model.parameters())

        def run():
            loss, _ = loss_fn(batch)
            return loss.detach(), torch.autograd.grad(loss, weights)
        return run

    # the peak the dry run's counter reckons for each step: its
    # allocations at most, beside the parameters
    reckoned = {}
    meta = Model(cfg, device="meta", trainable=True)
    for staged in (True, False):
        run = step(meta, "meta", pp_mesh("meta", (1, PP_STAGES),
                                         ("data", STAGE_AXIS))
                   if staged else None)
        rec = dr.trace(StepBundle(run, (), (), None))
        reckoned[staged] = rec["temp_bytes"] + sum(
            w.numel() * 4 for w in meta.parameters())
    del meta

    model = Model(cfg, seed=0, device=dev, trainable=True)
    names = [n for n, _ in model.named_parameters()]
    K2, M2 = PP_MODEL
    meshes = {"(1, 4)": pp_mesh(dev, (1, PP_STAGES), ("data", STAGE_AXIS)),
              "(1, 2, 4)": pp_mesh(dev, (1, K2, M2),
                                   ("data", STAGE_AXIS, "model")),
              "unstaged": None}
    out = {}
    for name, mesh in meshes.items():
        m = model if name != "(1, 2, 4)" else Model(
            cfg, device=dev, trainable=True, params=model.params(),
            mesh=mesh)
        run = step(m, dev, mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        loss, grads = run()
        peak = torch.cuda.max_memory_allocated(dev)
        hops = dict(mesh.hops) if mesh is not None else {}
        ms = time_ms(run, reps=3)
        out[name] = (loss, [g.double() for g in grads], ms, peak, hops)
        del m, run, grads
    c64 = cfg.replace(dtype="float64", param_dtype="float64")
    run64 = step(Model(c64, device=dev, trainable=True,
                       params=model.params()), dev)
    del model
    torch.cuda.empty_cache()
    _, g64 = run64()
    del run64
    base, base_grads, base_ms, base_peak, _ = out["unstaged"]
    e_base = {n: grad_error(g, w) for n, g, w in zip(names, base_grads, g64)}
    rtol = {n: card_grad_rtol(e_base[n], cfg.num_layers) for n in names}
    gib = 2 ** 30
    for name, shape in (("(1, 4)", (1, PP_STAGES, 1)),
                        ("(1, 2, 4)", (1, K2, M2))):
        loss, grads, ms, peak, hops = out[name]
        formula = gpipe_bytes(cfg, *shape)
        K = shape[1]
        e_pp = {n: grad_error(g, w) for n, g, w in zip(names, grads, g64)}
        worst = max(names, key=lambda n: e_pp[n] / rtol[n])
        err = abs(float(loss) - float(base))
        bubble = (K - 1) / (PP_MICRO + K - 1)
        log(f"[gpipe {TRAIN_ARCH} {name}] {cfg.num_layers} layers at "
            f"d_model {cfg.d_model}, float32, remat none, batch {PP_B} x "
            f"{PP_S}, {K} stages on a {name} mesh of {dev}"
            + (", the embedding and head sharded over its model axis"
               if shape[2] > 1 else "")
            + f", {PP_MICRO} microbatches: loss {float(loss):.6f} against "
            f"the unstaged {float(base):.6f}, |diff| {err:.3g} (rule 2e-4); "
            f"gradients against the unstaged step in float64: the worst "
            f"leaf against its rule {worst} {e_pp[worst]:.3g} of its "
            f"largest (card_grad_rtol {rtol[worst]:.3g}; the unstaged "
            f"float32 step's own {e_base[worst]:.3g}), the largest errors "
            f"pipelined {max(e_pp.values()):.3g}, unstaged "
            f"{max(e_base.values()):.3g} ({gpu})")
        log(f"[gpipe {TRAIN_ARCH} {name}] a step (forward and backward, "
            f"CUDA events, 3 warm) {ms:.2f} ms pipelined, {base_ms:.2f} ms "
            f"unstaged; peak memory {peak / gib:.3f} GiB pipelined, "
            f"{base_peak / gib:.3f} GiB unstaged"
            + (f", reckoned from a meta trace {reckoned[True] / gib:.3f} "
               f"and {reckoned[False] / gib:.3f} GiB" if shape[2] == 1
               else "")
            + f"; bubble (K - 1) / (n_micro + K - 1) = {bubble:.4f} of each "
            f"stage's ticks (on one card the stages run one after another, "
            f"so no tick overlaps another); bytes of the step {hops} "
            f"against the formula {formula} ({gpu})")
        if err > 2e-4:
            fail(f"[gpipe {TRAIN_ARCH} {name}] pipelined loss {float(loss)} "
                 f"against the unstaged {float(base)}")
        if e_pp[worst] > rtol[worst]:
            fail(f"[gpipe {TRAIN_ARCH} {name}] gradient {worst} off float64 "
                 f"by {e_pp[worst]} of its largest, past {rtol[worst]}")
        if hops != formula:
            fail(f"[gpipe {TRAIN_ARCH} {name}] hop bytes {hops}, formula "
                 f"{formula}")
    del out, base_grads, g64
    torch.cuda.empty_cache()
    log(f"[gpipe] took {time.monotonic() - t0:.1f} s")


def gpipe_bytes(cfg, D, K, M):
    """The bytes of each collective kind in a pipelined step (loss and
    gradients, remat "none") of a batch PP_B x PP_S in float32 on a (D, K,
    M) ("data", "stage", "model") mesh with D = 1, every participant's
    output (``tests/test_torch_pipeline.py:model_axis_bytes``). ``act`` =
    B S d x 4. Forward: (K - 1) hops of every microbatch, and the
    ``psum``'s buffer on each of the K M entries (an all-reduce of K M
    act); with the model on a model axis of M > 1, the embedding's
    all-reduce over its vocabulary shards (M act) and the logits'
    all-gather (M B S V x 4). Backward: each transpose, its inputs' bytes:
    the hops and both all-reduces again, the all-gather as a
    reduce-scatter (B S V x 4). One data shard: nothing moves between
    data rows and no gradient is reduced over data."""
    act = PP_B * PP_S * cfg.d_model * 4
    out = {"collective-permute": 2 * (K - 1) * act,
           "all-reduce": 2 * K * M * act}
    if M > 1:
        logits = PP_B * PP_S * cfg.vocab_size * 4
        out["all-reduce"] += 2 * M * act
        out["all-gather"] = M * logits
        out["reduce-scatter"] = logits
    return out


# --- phase 11: the attention family sharded over a (data, model) mesh -----

SHARD_ARCH = "olmoe-1b-7b"
SHARD_BATCH = (4, 64)             # 11b: card against CPU, 2 layers


def shard_mesh(device, mixed: bool = False):
    """Phase 11's (data, model) (2, 4) mesh of 8 entries of ``device``;
    ``mixed`` (phase 13): the entries with an odd model index on the CPU,
    so that every collective over ``model`` crosses the two devices."""
    from repro_torch.launch.mesh import make_mesh_for
    return make_mesh_for([("cpu" if mixed and j % 2 else device)
                          for _ in range(2) for j in range(4)],
                         model_parallel=4)


class RouteLog:
    """While installed, each call of ``repro_torch.models.moe.route`` is
    recorded, (top-k experts (N, k), router probabilities (N, E)), for the
    thread that asked (``record``): phase 11 runs MoE layers on the CPU
    in a worker thread while the card serves, so one thread's record must
    not take the other's calls (``Routes`` records every call)."""

    def __init__(self, moe_mod):
        self.moe, self.lists = moe_mod, {}

    def __call__(self, router, xf, cfg):
        probs, tope, topw = self.orig(router, xf, cfg)
        seen = self.lists.get(threading.get_ident())
        if seen is not None:
            seen.append((tope, probs))
        return probs, tope, topw

    def __enter__(self):
        self.orig, self.moe.route = self.moe.route, self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    @contextlib.contextmanager
    def record(self):
        me = threading.get_ident()
        self.lists[me] = seen = []
        try:
            yield seen
        finally:
            del self.lists[me]


def shard_side(cfg, params, device, mesh, batch, routes):
    """One side of phase 11b: ``cfg`` (2 layers) built from ``params`` on
    ``device``, sharded over ``mesh``, trainable where it is MoE; its
    logits of ``batch`` and their loss (the reference's, as
    ``Model.loss``), and for MoE the gradient of every leaf. Returns
    (loss, logits, gradients, each MoE call's top-k experts on the CPU,
    the weights' bytes)."""
    import torch

    from repro_torch.launch.train import deterministic
    from repro_torch.models.transformer import Model, _masked_ce
    from repro_torch.tree import leaves

    m = Model(cfg, device=device, params=params, trainable=cfg.moe,
              mesh=mesh)
    size = sum(_nbytes(w) for w in m.parameters())
    with deterministic(m.device), routes.record() as seen:
        logits, aux = m(batch)
        ce, _ = _masked_ce(logits, torch.as_tensor(batch["labels"]).long()
                           .to(m.device))
        loss = ce + cfg.router_aux_coef * aux
        grads = (torch.autograd.grad(loss, leaves(m.params()))
                 if cfg.moe else [])
    return (float(loss.detach()), logits.detach(), list(grads),
            [e.cpu() for e, _ in seen], size)


def sharded_models(dev, gpu, one_ms, dry_step):
    """Phase 11. 11a: ``olmoe-1b-7b`` at published width and depth,
    seed-0 weights, served sharded over a (2, 4) mesh of the one card
    through ``serve(mesh=...)`` at batch 4, prompt 16, 16 greedy tokens
    (half of phase 8's, for time) beside the one-device serve from the
    same weights
    (the sharded model's blocks are views of them), each MoE call's
    routing recorded: no assignment dropped on either side (each data
    shard routes 2 tokens x top 8 into a capacity of 4); the data shards'
    model ranks route alike; where a row's routing parts from the
    one-device run's while both are fed the same tokens, the step, the
    layer and the one-device router's gap between its k-th and (k+1)-th
    probability there (in bfloat16 a rounding of the row-parallel sums
    parts the two runs on such near-ties, as it parts the card's and the
    CPU's: the repository compares MoE models whole in float32 or wider);
    the greedy tokens' agreement; both serves' peak memory. Then
    ``exact_check`` (the first 4 layers in float64, where the two
    programs must agree) and one decode step's bytes of each collective
    kind against their formula (the all-to-all: 16 layers x 2 directions
    x 8 entries x (16 x 16 x 2048 x 2 B) = 268,435,456 B). 11b:
    ``sharded_checks``, whose CPU runs go on in a worker thread from the
    phase's start. Last, with the CPU idle again, a warm decode step's ms
    (CUDA events, 16 steps) on the mesh beside the one-device step's."""
    import concurrent.futures

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve_model import serve
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.tree import map_tree

    B, P, G = SHARD_STEP
    arch = SHARD_ARCH
    cfg = get_config(arch)
    L, E, k = cfg.num_layers, cfg.num_experts, cfg.top_k
    mesh = shard_mesh("cuda:0")
    D, M = mesh.shape["data"], mesh.shape["model"]
    one = Model(cfg, seed=0, device=dev)
    tree = one.params()
    # 11b's weights, copied to the CPU: the served olmoe's first 2
    # layers, and yi-6b drawn whole from seed 0 and cut
    yi = init_params(get_config("yi-6b"), seed=0, device=dev,
                     dtype=torch.bfloat16)
    cut = {a: map_tree(lambda x: x.cpu(), dict(t, blocks=t["blocks"][:2]))
           for a, t in ((arch, tree), ("yi-6b", yi))}
    # the card's runs read olmoe's from the served model (views), yi's
    # from the CPU copy, so that the serves' peak is phase 8's
    on_card = dict(cut, **{arch: dict(tree, blocks=tree["blocks"][:2])})
    del yi
    torch.cuda.empty_cache()
    threads = torch.get_num_threads()
    # the card's host thread keeps a core while the worker computes
    torch.set_num_threads(max(threads - 2, 1))
    with RouteLog(moe) as routes, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        checks = sharded_checks_start(cut, routes, pool)
        served, peaks, seen_by = {}, {}, {}
        for name, m in (("one device", None), ("(2, 4)", mesh)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            with routes.record() as seen:
                served[name] = serve(arch, smoke=False, batch=B,
                                     prompt_len=P, gen_tokens=G, seed=0,
                                     quiet=True, device=dev, params=tree,
                                     mesh=m)
            peaks[name] = torch.cuda.max_memory_allocated(dev)
            seen_by[name] = seen
        log(f"[shard {arch}] served on a (2, 4) mesh of cuda:0 (8 entries, "
            f"{E // M} experts a model rank): {B} x {G} tokens after a "
            f"prompt of {P} in {served['(2, 4)']['seconds']:.3f} s "
            f"({served['(2, 4)']['seconds'] * 1e3 / (P + G):.1f} ms a step "
            f"as served, the CPU's checks running beside it), one device "
            f"{served['one device']['seconds']:.3f} s; peak memory "
            f"{peaks['(2, 4)'] / 2 ** 30:.3f} GiB ({peaks['(2, 4)']} B) "
            f"against the one-device serve's "
            f"{peaks['one device'] / 2 ** 30:.3f} GiB ({peaks['one device']}"
            f" B) ({gpu})")
        if peaks["(2, 4)"] > 2 * peaks["one device"]:
            fail(f"[shard {arch}] peak memory {peaks['(2, 4)']} B: the "
                 f"entries copy their blocks of the weights")
        drops = {name: sum(int((~moe.slots(e, E, moe.capacity(
            e.shape[0], cfg))[1]).sum()) for e, _ in seen)
            for name, seen in seen_by.items()}
        # a sharded step-layer's D x M calls: entry (i, j) routes data row i
        calls = [e for e, _ in seen_by["(2, 4)"]]
        sets = []
        for c in range(0, len(calls), D * M):
            rows = [calls[c + i * M:c + (i + 1) * M] for i in range(D)]
            if any(not torch.equal(r[0], e) for r in rows for e in r):
                fail(f"[shard {arch}] the model ranks of a data row routed "
                     f"apart")
            sets.append(torch.cat([r[0] for r in rows]).sort(-1)[0])
        sets = torch.stack(sets).reshape(P + G, L, B, k)
        sets1 = torch.stack([e.sort(-1)[0] for e, _ in seen_by["one device"]]
                            ).reshape(P + G, L, B, k)
        top = torch.stack([p for _, p in seen_by["one device"]]).sort(
            -1, descending=True)[0]
        gaps = (top[..., k - 1] - top[..., k]).reshape(P + G, L, B)
        one_t, mesh_t = (served[n]["tokens"] for n in ("one device",
                                                        "(2, 4)"))
        parted = []
        for r in range(B):
            apart = np.nonzero(one_t[r] != mesh_t[r])[0]
            fed = P + (int(apart[0]) if apart.size else G)  # same tokens
            bad = (sets[:fed, :, r] != sets1[:fed, :, r]).any(-1).nonzero()
            parted.append((r, tuple(int(x) for x in bad[0]) if len(bad)
                           else None, float(gaps[tuple(bad[0]) + (r,)])
                           if len(bad) else None,
                           int(apart[0]) if apart.size else None))
        log(f"[shard {arch}] routing recorded in both serves ({len(calls)} "
            f"MoE calls on the mesh: 8 entries x {L} layers x {P + G} "
            f"steps; capacity {moe.capacity(B // D, cfg)} a shard of "
            f"{B // D} tokens): dropped assignments {drops['(2, 4)']}, one "
            f"device {drops['one device']}; the data rows' model ranks "
            f"route alike; each row's first (step, layer) where its routing "
            f"parts from the one-device run's while both are fed the same "
            f"tokens, the one-device router's gap between its top-{k} and "
            f"next probability there, and the first generated token that "
            f"parts: {parted}; greedy token rows equal "
            f"{int((one_t == mesh_t).all(1).sum())} of {B} ({gpu})")
        if drops["(2, 4)"] or drops["one device"]:
            fail(f"[shard {arch}] {drops} assignments dropped at a shape "
                 f"where none can drop")
        seq = torch.cat([torch.as_tensor(served["one device"]["prompt"],
                                         device=dev),
                         torch.as_tensor(one_t, device=dev)], 1).to(
            torch.int32)
        del served, seen_by, calls
        exact_check(dev, gpu, one, seq[:, :P], mesh, routes)

        # one decode step's collectives against their formula
        sharded = Model(cfg, device=dev, params=tree, mesh=mesh)
        caches = {"one device": one.init_cache(B, P + G),
                  "(2, 4)": sharded.init_cache(B, P + G)}
        nxt = {"tokens": seq[:, P:P + 1]}
        mesh.hops.clear()
        sharded.decode_step(caches["(2, 4)"], nxt, P)
        d, cap = cfg.d_model, moe.capacity(B // D, cfg)
        want = moe_step_bytes(cfg, B, D, M, 2, 4)
        got = dict(mesh.hops)
        log(f"[shard {arch}] one decode step's collective bytes (every "
            f"participant's output): {got}; the formula {want}: all-reduce "
            f"M B d x 2 B x (1 + L) (the embedding's vocabulary shards, "
            f"each layer's row-parallel attention) + L x 2 D M x 4 B (the "
            f"load-balance loss's pmean over data and model), all-to-all L "
            f"x 2 directions x D M entries x (E / M, M cap, d) = {L} x 2 x "
            f"{D * M} x ({E // M} x {M * cap} x {d} x 2 B), all-gather M B "
            f"V x 2 B (the logits' vocabulary shards); phase 10's one-entry "
            f"meta trace of this step {dry_step} ({gpu})")
        if got != want or got != dry_step:
            fail(f"[shard {arch}] collective bytes {got}, the formula "
                 f"{want}, the one-entry trace {dry_step}")
        sharded_checks(dev, gpu, on_card, checks, routes)
    torch.set_num_threads(threads)

    ms = {name: time_ms(lambda: model.decode_step(caches[name], nxt, P),
                        reps=16)
          for name, model in (("one device", one), ("(2, 4)", sharded))}
    log(f"[shard {arch}] decode step at batch {B}: {ms['(2, 4)']:.3f} ms a "
        f"step on the (2, 4) mesh, {ms['one device']:.3f} ms on one device "
        f"(CUDA events, 16 warm steps at position {P}, the CPU idle; phase "
        f"8's one-device step {one_ms:.3f} ms in this run), "
        f"{ms['(2, 4)'] / ms['one device']:.2f}x ({gpu})")
    del sharded, caches, one, tree, on_card
    torch.cuda.empty_cache()


def exact_check(dev, gpu, served, seq, mesh, routes):
    """Phase 11a's exact check: the served ``olmoe-1b-7b`` cut to its first
    4 layers at full width, in float64 on the card, one device against
    the (2, 4) mesh, teacher-forced over ``seq`` (the served prompt, 16
    positions): every MoE call's expert sets equal, every step's greedy
    token equal, the logits within ``f32_tolerance(4)`` (in float64 the
    two programs' own rounding sits far below it, and a routing near-tie
    cannot part them, as it parts the bfloat16 runs at full depth)."""
    import torch
    from _model_cases import f32_tolerance

    from repro_torch.models.transformer import Model

    arch, n = SHARD_ARCH, 4
    cfg = served.cfg.replace(num_layers=n, dtype="float64",
                             param_dtype="float64")
    params = served.params()
    params["blocks"] = params["blocks"][:n]
    one = Model(cfg, device=dev, params=params)
    sharded = Model(cfg, device=dev, params=one.params(), mesh=mesh)
    B, T = seq.shape
    got = {}
    for name, model in (("one device", one), ("(2, 4)", sharded)):
        cache = model.init_cache(B, T)
        out = []
        with routes.record() as seen:
            for t in range(T):
                lg, cache = model.decode_step(cache,
                                              {"tokens": seq[:, t:t + 1]}, t)
                out.append(lg)
        got[name] = (torch.cat(out, 1), [e.sort(-1)[0] for e, _ in seen])
    a, b = got["one device"][0], got["(2, 4)"][0]
    err = float((a - b).abs().max())
    tol = f32_tolerance(n)
    D, M = mesh.shape["data"], mesh.shape["model"]
    # a sharded step-layer's calls: entry (i, j) routes data row i
    mesh_sets = [torch.cat([got["(2, 4)"][1][c + i * M] for i in range(D)])
                 for c in range(0, len(got["(2, 4)"][1]), D * M)]
    same_sets = len(mesh_sets) == len(got["one device"][1]) and all(
        torch.equal(x, y) for x, y in zip(mesh_sets, got["one device"][1]))
    same_argmax = bool((a.argmax(-1) == b.argmax(-1)).all())
    log(f"[shard {arch}] float64, the first {n} layers at full width, one "
        f"device against the (2, 4) mesh, teacher-forced over {T} "
        f"positions: logits max abs err {err:.3e} (tolerance {tol}; max "
        f"|logit| {float(a.abs().max()):.4f}); expert sets equal at all "
        f"{len(mesh_sets)} step-layers: {same_sets}; greedy tokens equal at "
        f"every step: {same_argmax} ({gpu})")
    if err > tol or not same_sets or not same_argmax:
        fail(f"[shard {arch}] float64: the sharded program parts from the "
             f"one-device program")
    del one, sharded, got, params
    torch.cuda.empty_cache()


def shard_variants():
    """Phase 11b's cases: (name, its 2-layer float32 config)."""
    from repro_torch.configs import get_config
    small = dict(num_layers=2, dtype="float32", remat="none")
    olmoe = get_config(SHARD_ARCH).replace(capacity_factor=1.0, **small)
    return [(SHARD_ARCH, olmoe.replace(moe_sp_dispatch=False)),
            (SHARD_ARCH, olmoe.replace(moe_sp_dispatch=True)),
            ("yi-6b", get_config("yi-6b").replace(
                seq_parallel=True, fast_norm=True, **small))]


def shard_batch(cfg):
    import numpy as np
    b, s = SHARD_BATCH
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": labels}


def sharded_checks_start(cut, routes, pool):
    """Phase 11b's CPU runs, queued on ``pool`` (one worker thread) from
    the phase's start: each case's float32 run on a (2, 4) mesh of the
    CPU, then each MoE case's float64 run there, which ``sharded_checks``
    reads only where a leaf's float32 gradient passes its rule and
    cancels unstarted where none does; the sequence-sharded dispatch's
    first (its float32 gradient has been the one nearest the rule on
    this card). Returns {(case index, dtype): future}."""
    host = shard_mesh("cpu")
    futures = {}
    cases = shard_variants()
    for n, (arch, cfg) in enumerate(cases):
        futures[n, "float32"] = pool.submit(
            shard_side, cfg, cut[arch], "cpu", host, shard_batch(cfg),
            routes)
    for n, (arch, cfg) in reversed(list(enumerate(cases))):
        if cfg.moe:
            futures[n, "float64"] = pool.submit(
                shard_side, cfg.replace(dtype="float64",
                                        param_dtype="float64"),
                cut[arch], "cpu", host, shard_batch(cfg), routes)
    return futures


def sharded_checks(dev, gpu, cut, futures, routes):
    """Phase 11b: the first 2 layers at full width (``cut``), in float32
    on (2, 4) meshes of the card and of the CPU (the CPU's runs in a
    worker thread, ``sharded_checks_start``), and in float64 on the
    card's mesh from the same weights (the referee, as in phase 9c):
    ``olmoe-1b-7b`` (the served weights, cut) at ``capacity_factor=1.0``,
    batch 4 x 64, where assignments drop, with and without
    ``moe_sp_dispatch``, and ``yi-6b`` (drawn whole from seed 0, cut)
    with ``seq_parallel`` and ``fast_norm``. The card's float32 loss and logits within
    ``f32_tolerance(2)`` of the float64 ones, or where the CPU's own
    float32 error passes that, within twice it (at full width float32's
    rounding passes the absolute rule on any device:
    ``tests/_model_cases.py:card_grad_rtol``'s reasoning); the card
    against the CPU printed. For olmoe also the expert sets of every
    entry's MoE call equal on the three, and every gradient leaf of the
    card within ``card_grad_rtol`` of its largest from the float64 one;
    a leaf past it (float32's own rounding: the rule is twice the CPU's
    error on one sample) is held in float64 instead, the card's against
    the CPU's float64 run, within ``grad_tolerance(2)``, every leaf."""
    import torch
    from _model_cases import (card_grad_rtol, f32_tolerance, grad_error,
                              grad_tolerance)

    from repro_torch.models import moe
    from repro_torch.tree import flatten

    card_mesh = shard_mesh("cuda:0")
    M = card_mesh.shape["model"]
    b, s = SHARD_BATCH
    tol = f32_tolerance(2)
    for n, (arch, small) in enumerate(shard_variants()):
        t0 = time.monotonic()
        batch = shard_batch(small)
        got = {"card": shard_side(small, cut[arch], dev, card_mesh, batch,
                                  routes),
               "float64": shard_side(small.replace(dtype="float64",
                                                   param_dtype="float64"),
                                     cut[arch], dev, card_mesh, batch,
                                     routes)}
        card_s = time.monotonic() - t0
        got["cpu"] = futures[n, "float32"].result()
        size = got["cpu"][4]

        def diff(a, b, i):
            return (abs(got[a][0] - got[b][0]) if i == 0 else float(
                (got[a][1].to(dev, torch.float64)
                 - got[b][1].to(dev, torch.float64)).abs().max()))
        err = {side: [diff(side, "float64", i) for i in (0, 1)]
               for side in ("card", "cpu")}
        rule = [max(tol, 2 * e) for e in err["cpu"]]
        apart = [diff("card", "cpu", i) for i in (0, 1)]
        what = ", ".join(f"{k}={getattr(small, k)}" for k in (
            ("moe_sp_dispatch",) if small.moe else
            ("seq_parallel", "fast_norm")))
        line = (f"[shard card-vs-cpu {arch}] the first 2 layers at full "
                f"width ({size / 1e9:.2f} GB of float32 weights on the "
                f"CPU), {what}, batch {b} x {s}, on (2, 4) meshes of the "
                f"card and of the CPU: float32 loss {got['cpu'][0]:.6f}; "
                f"against float64, the card's loss {err['card'][0]:.3g} and "
                f"logits {err['card'][1]:.6f}, the CPU's "
                f"{err['cpu'][0]:.3g} and {err['cpu'][1]:.6f} (rule "
                f"{rule[0]:.3g}, {rule[1]:.6f}: f32_tolerance(2) {tol}, or "
                f"twice the CPU's); card against CPU {apart[0]:.3g}, "
                f"{apart[1]:.6f}")
        if err["card"][0] > rule[0] or err["card"][1] > rule[1]:
            fail(f"{line}: beyond the float32 rule")
        if small.moe:
            calls = [got[k][3] for k in ("card", "cpu", "float64")]
            if len({len(c) for c in calls}) != 1 or not calls[0]:
                fail(f"[shard card-vs-cpu {arch}] MoE calls "
                     f"{[len(c) for c in calls]}")
            for i, sets in enumerate(zip(*calls)):
                first = sets[0].sort(-1)[0]
                if not all(torch.equal(first, e.sort(-1)[0]) for e in sets):
                    fail(f"[shard card-vs-cpu {arch}] MoE call {i}: the "
                         f"expert sets differ between the card, the CPU and "
                         f"float64")
            # every model rank routes its data row's tokens, or under
            # moe_sp_dispatch its slice of them
            assigned = b * s * small.top_k * (1 if small.moe_sp_dispatch
                                              else M)
            dropped = sum(int((~moe.slots(e, small.num_experts,
                                          moe.capacity(e.shape[0], small))
                               [1]).sum()) for e in calls[0])
            names = [k for k, _ in flatten(cut[arch])]
            g_card, g_cpu, g64 = (dict(zip(names, got[k][2]))
                                  for k in ("card", "cpu", "float64"))
            e_card = {k: grad_error(g_card[k].double(), g64[k])
                      for k in names}
            e_cpu = {k: grad_error(g_cpu[k].to(dev).double(), g64[k])
                     for k in names}
            rtol = {k: card_grad_rtol(e_cpu[k], 2) for k in names}
            worst = max(names, key=lambda k: e_card[k] / rtol[k])
            line += (f"; expert sets equal in all {len(calls[0])} MoE calls "
                     f"(8 entries x 2 layers), {dropped} of {assigned} "
                     f"assignments dropped; gradients against float64, the "
                     f"worst leaf against its rule {worst}: card "
                     f"{e_card[worst]:.3g}, CPU {e_cpu[worst]:.3g} (rule "
                     f"{rtol[worst]:.3g}), over {len(names)} leaves")
            over = [k for k in names if e_card[k] > rtol[k]]
            if over:
                # float32's own rounding passes the rule on these leaves:
                # they are held in float64, the card's against the CPU's,
                # where rounding sits far below grad_tolerance (the VLM's
                # group is held so, phase 8)
                g_host = dict(zip(names, futures[n, "float64"].result()[2]))
                e64 = {k: grad_error(g_host[k].to(dev), g64[k])
                       for k in names}
                worst64 = max(names, key=e64.get)
                gtol = grad_tolerance(2)
                line += (f"; past the rule in float32: {over} (card "
                         f"{[round(e_card[k] / rtol[k], 3) for k in over]} "
                         f"of it), so held in float64, the card against the "
                         f"CPU: the worst leaf {worst64} at "
                         f"{e64[worst64]:.3g} of its largest (tolerance "
                         f"{gtol})")
                if e64[worst64] > gtol:
                    fail(f"{line}: float64 gradients part")
            else:
                futures[n, "float64"].cancel()
        log(f"{line}; the card's runs {card_s:.1f} s, the phase so far "
            f"waited {time.monotonic() - t0:.1f} s for this case ({gpu})")
        del got
        torch.cuda.empty_cache()


# --- phase 12: MLA, the VLM's groups, RWKV6 and Mamba2 sharded -----------

FAMILY_ARCH = "deepseek-v2-lite-16b"
# (arch, the layers kept from its seed-0 draw at published width)
FAMILY_CUTS = (("rwkv6-3b", 4), ("zamba2-2.7b", 12),
               ("llama-3.2-vision-11b", 2))
FAMILY_RTOL = 1e-9                # float64: of each compared value's largest


def family_bytes(cfg, B, D, M, S_max, esize):
    """The bytes of each collective kind in one decode step of ``cfg`` on
    a (D, M) mesh, batch B, a cache of S_max positions, activations of
    ``esize`` bytes (every participant's output, as ``DeviceMesh`` counts
    them). ``act`` = M B d esize: every entry's copy of its data row's (B
    / D, 1, d) activations. The vocabulary splits over ``model`` in every
    arch here: the embedding lookup is one all-reduce of ``act``, the
    logits one all-gather, M B V esize.

    * MLA + MoE (``deepseek-v2-lite-16b``): all-reduce ``act`` for each
      row-parallel sublayer, the prefix block's MLA (heads cut) and dense
      MLP and each MoE block's MLA and shared expert, and the pmean of
      each MoE block's load-balance loss over data and model (2 D M
      float32 scalars); all-to-all L_moe x 2 directions x D M entries x
      (E / M, M cap, d) esize (cap from a data row's B / D tokens); the
      latent cache by position over ``model`` where it divides S_max,
      all-gathered (c_kv and k_rope, (B / D, S_max, r + dr) an entry) in
      every layer;
    * RWKV6: all-reduce ``act`` for each layer's time mix (``wo`` by row)
      and channel mix (``wv`` by row); all-gather each layer's new wkv
      state, replicated over ``model`` in the cache ((B / D, H, hd, hd)
      float32 an entry, each rank advancing its heads);
    * Mamba2 (zamba2): for each Mamba2 layer, all-gather its projection
      ((B / D, 1, 2 d_inner + 2 d_state + H) an entry) and its conv
      outputs ((B / D, 1, conv_dim)), all-reduce its gated norm's float32
      sums of squares ((B / D, 1, 1)) and ``out_proj``'s partial sums
      (``act``); each group's shared block, attention and MLP, each an
      all-reduce of ``act``; its k and v by kv head, so no gather;
    * the VLM: each self block's attention and MLP and the group's
      cross-attention (q by head) and MLP, each an all-reduce of ``act``;
      the self caches and the patch cache by kv head where ``model``
      divides the kv heads (8 over 4 at published width), else by
      position, all-gathered ((B / D, S_max or P, KH, Dh) an entry, k and
      v)."""
    from repro_torch.models import moe, ssm

    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    act = M * B * d * esize
    out = {"all-reduce": act, "all-gather": M * B * V * esize}
    if cfg.mla:
        n_moe = L - cfg.first_dense
        cap = moe.capacity(B // D, cfg)
        out["all-reduce"] += (2 * L * act + n_moe * 2 * D * M * 4)
        out["all-to-all"] = (n_moe * 2 * D * M * cfg.num_experts * cap * d
                             * esize)
        if S_max % M == 0:
            out["all-gather"] += (L * M * B * S_max
                                  * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                                  * esize)
    elif cfg.block_pattern == "rwkv6":
        H, hd = ssm.rwkv6_dims(cfg)
        out["all-reduce"] += 2 * L * act
        out["all-gather"] += L * M * B * H * hd * hd * 4
    elif cfg.block_pattern == "zamba2":
        d_inner, H, conv_dim = ssm.mamba2_dims(cfg)
        G = L // cfg.shared_attn_every
        out["all-reduce"] += L * act + L * M * B * 4 + 2 * G * act
        out["all-gather"] += (L * M * B * (2 * d_inner + 2 * cfg.ssm_state
                                           + H + conv_dim) * esize)
    else:
        G = L // cfg.cross_attn_every
        out["all-reduce"] += 2 * L * act + 2 * G * act
        if cfg.num_kv_heads % M:
            kv = M * B * cfg.num_kv_heads * cfg.head_dim * esize
            for n, S in ((L, S_max), (G, cfg.num_patches)):
                out["all-gather"] += n * 2 * kv * S if S % M == 0 else 0
    return out


def family_run(model, prompt, gen, patches=None):
    """``model`` (one device or sharded) over ``prompt`` (B, P) one decode
    step a position, then ``gen`` greedy steps, from an empty cache of P +
    gen positions (the VLM's patch cache filled from ``patches`` through
    each group's ``wk`` and ``wv``). Returns (the logits (B, P + gen, V),
    the greedy tokens (B, gen), the final cache)."""
    import torch
    B, P = prompt.shape
    cache = model.init_cache(B, P + gen)
    if patches is not None:
        for g, gp in enumerate(model.cross):
            for n in ("k", "v"):
                w = gp["cross"][f"w{n}"]
                cache["cross_groups"]["cross_kv"][n][g] = torch.einsum(
                    "bpd,dhk->bphk", patches.to(w.dtype), w)
    out, toks, nxt = [], [], prompt[:, :1]
    for t in range(P + gen):
        if t < P:
            nxt = prompt[:, t:t + 1]
        logits, cache = model.decode_step(cache, {"tokens": nxt}, t)
        out.append(logits)
        if t >= P - 1 and t < P + gen - 1:
            nxt = logits[:, -1].argmax(-1, keepdim=True).to(prompt.dtype)
            toks.append(nxt)
    return torch.cat(out, 1), torch.cat(toks, 1), cache


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (0 where both are zero)."""
    scale = float(b.abs().max())
    err = float((a.double() - b.double()).abs().max())
    return err / scale if scale else err


def family_exact(dev, gpu, what, one, mesh, prompt, gen, patches=None,
                 routes=None):
    """``one`` (a float64 model on ``dev``) against the same weights
    sharded over ``mesh`` (views of ``one``'s), each over ``prompt`` and
    ``gen`` greedy steps (``family_run``): the logits and every leaf of the
    final cache within ``FAMILY_RTOL`` of their largest, the greedy tokens
    equal, and where ``routes`` records the MoE calls (a ``Routes``) the
    expert sets of every step-layer equal. Returns the line's numbers."""
    import torch

    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    two = Model(one.cfg, device=dev, params=one.params(), mesh=mesh)
    got = {}
    for name, model in (("one device", one), ("(2, 4)", two)):
        if routes is not None:
            routes.seen.clear()
        logits, toks, cache = family_run(model, prompt, gen, patches)
        sets = [e.sort(-1)[0] for e, _ in routes.seen] if routes else []
        got[name] = (logits, toks, cache, sets)
    a, b = got["(2, 4)"], got["one device"]
    err = rel_err(a[0], b[0])
    cache_err = {path: rel_err(x, y) for (path, x), (_, y) in
                 zip(flatten(a[2]), flatten(b[2]))}
    worst = max(cache_err, key=cache_err.get)
    same_toks = bool(torch.equal(a[1], b[1]))
    same_sets = True
    if routes is not None:
        D, M = mesh.shape["data"], mesh.shape["model"]
        # a sharded step-layer's D x M calls: entry (i, j) routes data row i
        mesh_sets = [torch.cat([a[3][c + i * M] for i in range(D)])
                     for c in range(0, len(a[3]), D * M)]
        same_sets = len(mesh_sets) == len(b[3]) and all(
            torch.equal(x, y) for x, y in zip(mesh_sets, b[3]))
    line = (f"{what}: float64 on the (2, 4) mesh against one device over "
            f"a prompt of {prompt.shape[1]} and {gen} greedy steps: logits "
            f"{err:.3e} of their largest ({float(b[0].abs().max()):.4f}); "
            f"the final cache's worst leaf {worst} {cache_err[worst]:.3e} of "
            f"its largest; greedy tokens equal {same_toks}"
            + (f"; expert sets equal at all {len(b[3])} step-layers "
               f"{same_sets}" if routes is not None else "")
            + f" (rule {FAMILY_RTOL}) ({gpu})")
    log(line)
    if err > FAMILY_RTOL or cache_err[worst] > FAMILY_RTOL or \
            not same_toks or not same_sets:
        fail(f"{line}: the sharded program parts from the one-device "
             f"program")
    del two, got
    torch.cuda.empty_cache()


def sharded_families(dev, gpu, one_ms, one_peak):
    """Phase 12: the archs that phase 11 does not reach, sharded over the
    (2, 4) mesh of ``cuda:0`` (``shard_mesh``). 12a: ``FAMILY_ARCH``
    (``deepseek-v2-lite-16b``) at published width and depth, seed-0
    bfloat16 weights, served through ``serve(mesh=...)`` (batch 4, prompt
    16, 8 greedy tokens: a quarter of phase 8's, for time), each MoE call's
    routing recorded: no assignment dropped (each data shard routes 2
    tokens x top 6 over 64 experts into 4 slots an expert), the peak
    memory beside phase 8's one-device serve (``one_peak``; twice it
    fails: the entries would copy their blocks), one decode step's bytes
    of each collective kind equal to ``family_bytes``, a warm step's ms
    (CUDA events, 8 steps) beside phase 8's ``one_ms``. Its bfloat16
    tokens are not held equal to one device's: routing parts on
    near-ties (phase 11). The function is held in float64 instead
    (``family_exact``): the first 3 layers, the dense prefix and 2 MoE
    blocks. 12b: each of ``FAMILY_CUTS`` drawn whole from seed 0 in
    bfloat16 and cut (the VLM to its first group of 2 self blocks, its
    gate set to a seeded value in [0.5, 1.5), its patch cache filled from
    seeded patches x 0.02): held in float64 by ``family_exact``; then in
    bfloat16 one decode step's bytes against ``family_bytes``, a warm
    step's ms on the mesh and on one device, the peak memory."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve_model import serve
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.tree import map_tree

    B, P, G, GEN = 4, 16, 8, 4
    mesh = shard_mesh("cuda:0")
    D, M = mesh.shape["data"], mesh.shape["model"]

    # 12a --------------------------------------------------------------
    t0 = time.monotonic()
    arch = FAMILY_ARCH
    cfg = get_config(arch)
    E = cfg.num_experts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sharded = Model(cfg, seed=0, device=dev, mesh=mesh)
    with Routes(moe) as routed:
        res = serve(arch, smoke=False, batch=B, prompt_len=P, gen_tokens=G,
                    seed=0, quiet=True, device=dev, params=sharded.params(),
                    mesh=mesh)
    peak = torch.cuda.max_memory_allocated(dev)
    toks = res["tokens"]
    if toks.shape != (B, G) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"[shard2 {arch}] tokens {toks.shape} outside the vocabulary")
    calls = [e for e, _ in routed.seen]
    drops = sum(int((~moe.slots(e, E, moe.capacity(e.shape[0], cfg))[1])
                    .sum()) for e in calls)
    for c in range(0, len(calls), D * M):
        for i in range(D):
            row = calls[c + i * M:c + (i + 1) * M]
            if any(not torch.equal(row[0], e) for e in row):
                fail(f"[shard2 {arch}] the model ranks of a data row routed "
                     f"apart")
    cache = sharded.init_cache(B, P + G)
    nxt = {"tokens": torch.as_tensor(toks[:, :1], dtype=torch.int32,
                                     device=dev)}
    mesh.hops.clear()
    sharded.decode_step(cache, nxt, P)
    got = dict(mesh.hops)
    want = family_bytes(cfg, B, D, M, P + G, 2)
    ms = time_ms(lambda: sharded.decode_step(cache, nxt, P), reps=8)
    log(f"[shard2 {arch}] served on a (2, 4) mesh of cuda:0 (8 entries; "
        f"{cfg.num_heads // M} heads and {E // M} experts a model rank; the "
        f"latent cache by position): {B} x {G} tokens after a prompt of {P} "
        f"in {res['seconds']:.3f} s ({res['seconds'] * 1e3 / (P + G):.1f} "
        f"ms a step as served); decode step {ms:.3f} ms (CUDA events, 8 "
        f"warm steps at position {P}) against phase 8's one-device "
        f"{one_ms:.3f} ms, {ms / one_ms:.2f}x; peak memory "
        f"{peak / 2 ** 30:.3f} GiB ({peak} B) against phase 8's one-device "
        f"serve's {one_peak / 2 ** 30:.3f} GiB; dropped assignments {drops} "
        f"of {sum(int(e.numel()) for e in calls)} ({len(calls)} MoE calls, "
        f"capacity {moe.capacity(B // D, cfg)} a data shard of {B // D} "
        f"tokens); one decode step's collective bytes {got}, the formula "
        f"{want} (all-to-all 26 x 2 x 8 x (64 x 4 x 2048 x 2 B); the latent "
        f"cache 27 x 8 x (2 x {P + G} x 576 x 2 B); the logits 8 x (2 x "
        f"102400 x 2 B)) ({gpu})")
    if drops:
        fail(f"[shard2 {arch}] {drops} assignments dropped at a shape where "
             f"none can drop")
    if got != want:
        fail(f"[shard2 {arch}] collective bytes {got}, the formula {want}")
    if peak > 2 * one_peak:
        fail(f"[shard2 {arch}] peak memory {peak} B: the entries copy their "
             f"blocks of the weights")
    del cache
    n = 3
    params = sharded.params()
    params["blocks"] = params["blocks"][:n - cfg.first_dense]
    one = Model(cfg.replace(num_layers=n, dtype="float64",
                            param_dtype="float64"), device=dev,
                params=params)
    del sharded, params
    torch.cuda.empty_cache()
    prompt = torch.as_tensor(res["prompt"], dtype=torch.int32, device=dev)
    with Routes(moe) as routes:
        family_exact(dev, gpu, f"[shard2 {arch}] the first {n} layers (the "
                     f"dense prefix, 2 MoE blocks) at full width", one, mesh,
                     prompt, GEN, routes=routes)
    del one
    torch.cuda.empty_cache()
    log(f"[shard2 {arch}] took {time.monotonic() - t0:.1f} s")

    # 12b --------------------------------------------------------------
    prompt_rng = np.random.default_rng(0)
    for arch, cut in FAMILY_CUTS:
        t0 = time.monotonic()
        cfg = get_config(arch)
        drawn = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        keep = {"blocks": drawn["blocks"][:cut]}
        if cfg.cross_attn_every:
            keep["cross"] = drawn["cross"][:1]
        # copies: a kept layer would otherwise hold its whole stack
        tree = map_tree(lambda x: x.clone(), dict(drawn, **keep))
        del drawn, keep
        small = cfg.replace(num_layers=cut)
        patches = None
        if cfg.cross_attn_every:
            small = small.replace(cross_attn_every=cut)
            gen = torch.Generator(device="cpu")
            gen.manual_seed(4)
            gate = 0.5 + float(torch.rand((), generator=gen))
            tree["cross"][0]["cross"]["gate"].fill_(gate)
            gen = torch.Generator(device=dev)
            gen.manual_seed(3)
            patches = torch.randn(B, cfg.num_patches, cfg.d_model,
                                  generator=gen, device=dev) * 0.02
        torch.cuda.empty_cache()
        prompt = torch.as_tensor(prompt_rng.integers(
            0, cfg.vocab_size, (B, P)), dtype=torch.int32, device=dev)
        layers = ("self blocks and the cross sublayer" if patches is not None
                  else "layers")
        what = f"[shard2 {arch}] {cut} {layers} at full width"
        one = Model(small.replace(dtype="float64", param_dtype="float64"),
                    device=dev, params=tree)
        family_exact(dev, gpu, what, one, mesh, prompt, GEN, patches)
        del one
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        one = Model(small, device=dev, params=tree)
        two = Model(small, device=dev, params=one.params(), mesh=mesh)
        caches = {name: m.init_cache(B, P + G) for name, m in
                  (("one device", one), ("(2, 4)", two))}
        nxt = {"tokens": prompt[:, :1]}
        mesh.hops.clear()
        two.decode_step(caches["(2, 4)"], nxt, P)
        got = dict(mesh.hops)
        want = family_bytes(small, B, D, M, P + G, 2)
        ms = {name: time_ms(lambda: m.decode_step(caches[name], nxt, P),
                            reps=8)
              for name, m in (("one device", one), ("(2, 4)", two))}
        peak = torch.cuda.max_memory_allocated(dev)
        size = sum(_nbytes(w) for w in one.parameters())
        log(f"{what}, bfloat16 ({size / 1e9:.2f} GB of weights): decode step "
            f"at batch {B} {ms['(2, 4)']:.3f} ms on the (2, 4) mesh, "
            f"{ms['one device']:.3f} ms on one device "
            f"({ms['(2, 4)'] / ms['one device']:.2f}x; CUDA events, 8 warm "
            f"steps at position {P}); peak memory {peak / 2 ** 30:.3f} GiB "
            f"({peak} B) with both models' caches; one step's collective "
            f"bytes {got}, the formula {want}; the phase for this arch "
            f"{time.monotonic() - t0:.1f} s ({gpu})")
        if got != want:
            fail(f"[shard2 {arch}] collective bytes {got}, the formula "
                 f"{want}")
        del one, two, caches, tree
        torch.cuda.empty_cache()


# --- phase 13: a mesh whose entries sit on two devices -------------------

MIXED_ARCH = "olmoe-1b-7b"
MIXED_LAYERS = 2
MIXED_BATCH = (4, 16)             # the loss's batch; decode: 2 fed, 2 greedy
MIXED_RTOL = 1e-9                 # float64: of each compared value's largest


def mixed_mesh(dev, gpu):
    """Phase 13: ``MIXED_ARCH`` at published width cut to its first
    ``MIXED_LAYERS`` layers of its seed-0 draw, in float64, sharded over a
    (2, 4) mesh whose entries with an odd model index sit on the CPU and
    the rest on ``dev`` (``shard_mesh(mixed=True)``: every collective over
    ``model`` crosses the two devices, every CPU entry's blocks are
    copies, its cache parts copied there and written back), held against
    the same model on the (2, 4) mesh of ``dev`` alone (the program phase
    11 holds against one device), each value within ``MIXED_RTOL`` of its
    largest: a batch of ``MIXED_BATCH`` seeded tokens' logits and loss,
    every gradient leaf of the loss; then 4 decode steps, 2 over the
    batch's first tokens and 2 greedy: the logits, every cache leaf, each
    MoE call's expert sets and the greedy tokens equal. One decode step's
    collective bytes equal ``moe_step_bytes`` at this shape (float64
    activations and load-balance loss). Peak memory on the card against
    the card's mesh's, and each side's seconds."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.tree import flatten, leaves

    t0 = time.monotonic()
    cfg = get_config(MIXED_ARCH).replace(num_layers=MIXED_LAYERS,
                                          dtype="float64",
                                          param_dtype="float64")
    tree = init_params(cfg, seed=0, device=dev)
    B, S = MIXED_BATCH
    rng = np.random.default_rng(13)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                device=dev) for k in ("tokens", "labels")}
    meshes = {"cuda:0": shard_mesh(dev), "mixed": shard_mesh(dev, True)}
    got, peaks, secs = {}, {}, {}
    with RouteLog(moe) as routes:
        for name, mesh in meshes.items():
            t1 = time.monotonic()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            model = Model(cfg, device=dev, params=tree, trainable=True,
                          mesh=mesh)
            loss, _ = model.loss(batch)
            grads = torch.autograd.grad(loss, leaves(model.params()))
            with torch.no_grad():
                logits, _ = model(batch)
            del model
            serving = Model(cfg, device=dev, params=tree, mesh=mesh)
            with routes.record() as seen:
                dec, toks, cache = family_run(serving, batch["tokens"][:, :2],
                                              2)
            mesh.hops.clear()
            serving.decode_step(serving.init_cache(B, 8),
                                {"tokens": batch["tokens"][:, :1]}, 0)
            hops = dict(mesh.hops)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated(dev)
            secs[name] = time.monotonic() - t1
            # held on the host, so that the next side's peak is its own
            got[name] = dict(loss=loss.detach().cpu(), logits=logits.cpu(),
                             grads=[g.cpu() for g in grads],
                             decode=dec.cpu(), tokens=toks.cpu(),
                             cache={k: v.cpu() for k, v in flatten(cache)},
                             sets=[e.sort(-1)[0].cpu() for e, _ in seen],
                             hops=hops)
            del serving, cache, grads, logits, dec
    a, b = got["mixed"], got["cuda:0"]
    errs = {"loss": rel_err(a["loss"], b["loss"]),
            "logits": rel_err(a["logits"], b["logits"]),
            "decode logits": rel_err(a["decode"], b["decode"])}
    grad_errs = [rel_err(x, y) for x, y in zip(a["grads"], b["grads"])]
    cache_errs = {k: rel_err(a["cache"][k], b["cache"][k])
                  for k in b["cache"]}
    errs["worst gradient leaf"] = max(grad_errs)
    errs["worst cache leaf"] = max(cache_errs.values())
    same_sets = len(a["sets"]) == len(b["sets"]) and all(
        torch.equal(x, y) for x, y in zip(a["sets"], b["sets"]))
    same_toks = bool(torch.equal(a["tokens"], b["tokens"]))
    want = moe_step_bytes(cfg, B, 2, 4, 8, 8)
    gib = 2 ** 30
    line = (f"[mixed {MIXED_ARCH}] {MIXED_LAYERS} layers at published width "
            f"in float64 on a (2, 4) mesh whose odd model ranks sit on the "
            f"CPU, against the (2, 4) mesh of {dev}: loss, logits of a "
            f"{B} x {S} batch, {len(grad_errs)} gradient leaves, 4 decode "
            f"steps (2 fed, 2 greedy), relative to each value's largest: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (rule {MIXED_RTOL}); expert sets equal at all "
            f"{len(b['sets'])} MoE calls {same_sets}; greedy tokens equal "
            f"{same_toks}; one decode step's collective bytes {a['hops']} "
            f"(the card's mesh {b['hops']}), the formula {want}; peak "
            f"memory on the card {peaks['mixed'] / gib:.3f} GiB "
            f"({peaks['mixed']} B) against the card's mesh's "
            f"{peaks['cuda:0'] / gib:.3f} GiB ({peaks['cuda:0']} B); "
            f"{secs['mixed']:.1f} s mixed, {secs['cuda:0']:.1f} s on the "
            f"card ({gpu})")
    log(line)
    if max(errs.values()) > MIXED_RTOL or not same_sets or not same_toks:
        fail(f"{line}: the mixed mesh parts from the card's")
    if a["hops"] != want or b["hops"] != want:
        fail(f"[mixed {MIXED_ARCH}] collective bytes {a['hops']} and "
             f"{b['hops']}, the formula {want}")
    del got, tree
    torch.cuda.empty_cache()
    log(f"[mixed] took {time.monotonic() - t0:.1f} s")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one warm solve per session with "
                             "torch.profiler and print device busy time")
    profile = parser.parse_args(argv).profile
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    for source, _ in KERNELS.values():
        if not os.path.exists(os.path.join(ROOT, source)):
            print(f"chip_smoke: {source} not found beside this script; run "
                  f"it from a checkout of the repository", file=sys.stderr)
            return 2
    sys.path.insert(0, SRC)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    from _decode_cases import (SCHED_ENVELOPE_SHAPES, SCHED_MAIN_SHAPES,
                               SCHED_SHAPES, SCHED_WIDE_SHAPES, USL_SHAPES,
                               kernel_cases, sched_instance, usl_instance)

    from repro_torch.cluster.catalog import alibaba_cluster, paper_cluster
    from repro_torch.cluster.workloads import dag1, synth_trace
    from repro_torch.core import dag as tdag
    from repro_torch.core import ising
    from repro_torch.core import vectorized as vec
    from repro_torch.core.agora import Agora
    from repro_torch.core.objectives import Goal
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import sched_violation as sv_kernel
    from repro_torch.kernels import sgs_decode as kernel
    from repro_torch.kernels import usl_runtime as usl_kernel

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(gpu)

    laps = [time.monotonic()]

    def lap(phases):
        laps.append(time.monotonic())
        log(f"[time] phase {phases}: {laps[-1] - laps[-2]:.1f} s (the run so "
            f"far {laps[-1] - laps[0]:.1f} s)")

    # 1. build ---------------------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build(*KERNELS)
    log(f"[build] {len(libs)} kernels in {time.monotonic() - t0:.2f} s "
        f"(one nvcc each, in parallel)")
    for name, lib in libs.items():
        log(f"[build] {KERNELS[name][0]} -> {os.path.relpath(lib, ROOT)} "
            f"(nvcc {_build.seconds[name]:.2f} s)")
        report = lib.with_suffix(".log")
        entries = ptxas_kernels(report.read_text()) if report.exists() else []
        if name != "sched_violation":
            for entry, regs, st, ld in entries:
                log(f"[build] {name}: {entry[:60]}: {regs} registers, spill "
                    f"stores {st} B, loads {ld} B")
            if name == "sgs_decode":
                # the fast, wide and wide-block routes' kernels, the
                # prep, the step chain
                if len(entries) != 5:
                    fail(f"ptxas reports {len(entries)} sgs_decode kernels, "
                         f"expected 5")
                spilled = [e for e, _, st, ld in entries if st or ld]
                if spilled:
                    fail(f"ptxas spills in sgs_decode {spilled}")
            continue
        # one kernel per (C cells a lane, K bins a row, MM resources), and
        # the wide path's kernel (256 threads a block)
        if not entries:
            fail("no ptxas report for sched_violation")
        shown, most, wide = [], 0, []
        for entry, regs, st, ld in entries:
            m = re.search(r"kernelILi(\d+)ELi(\d+)ELi(\d+)E", entry)
            if st or ld:
                fail(f"ptxas spills in sched_violation {entry}: stores {st} "
                     f"B, loads {ld} B")
            if "wide" in entry:
                wide.append(regs)
                continue
            shown.append(f"<{','.join(m.groups()) if m else entry}> {regs}")
            most = max(most, regs)
        if len(wide) != 2:
            fail("no ptxas report for sched_violation's two wide kernels")
        log(f"[build] sched_violation: {len(shown)} kernels <C,K,MM> "
            f"registers: {', '.join(shown)}; the wide path's kernels "
            f"{wide} registers; no spills; at most {most} registers x "
            f"{sv_kernel.MAX_THREADS} threads a block, {max(wide)} x 256 "
            f"on the wide path")
        if most * sv_kernel.MAX_THREADS > 65536 or max(wide) * 256 > 65536:
            fail(f"sched_violation: {most} registers a thread do not fit "
                 f"{sv_kernel.MAX_THREADS} threads in one SM's 64 K, or "
                 f"{wide} do not fit 256")

    # 2. kernels against their plain versions, on the card -------------------
    def on_card(args):
        return [torch.from_numpy(a).to(dev) for a in args]

    cases = kernel_cases()
    for args, T in cases:
        a = on_card(args)
        same_outputs(ops.sgs_decode(*a, T=T, use_kernel=True),
                     ops.sgs_decode(*a, T=T, use_kernel=False))
    torch.cuda.synchronize()
    log(f"[parity] {len(cases)} decode instances: kernel == plain version")

    sched_shapes = (SCHED_SHAPES + SCHED_MAIN_SHAPES + SCHED_ENVELOPE_SHAPES
                    + SCHED_WIDE_SHAPES)
    sched_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, J, M, T in sched_shapes:
            start, dur, dem, caps = sched_instance(B, J, M, T)
            start, dur, caps = on_card([start, dur, caps])
            # dem contiguous, and as the ising loop passes it: a (B, M, J)
            # view of a (B, J, M) tensor
            views = (torch.from_numpy(dem).to(dev), torch.from_numpy(
                np.ascontiguousarray(dem.transpose(0, 2, 1))).to(dev)
                .transpose(1, 2))
            for layout, dm in zip(("contiguous", "transposed"), views):
                what = f"sched_violation {(B, J, M, T)} {dtype} {layout}"
                s_, d_, dm = (x.to(dtype) for x in (start, dur, dm))
                got = ops.sched_violation(s_, d_, dm, caps, T=T,
                                          use_kernel=True)
                want = ops.sched_violation(s_, d_, dm.contiguous(), caps,
                                           T=T, use_kernel=False)
                sched_err = max(sched_err, close_outputs(
                    what, got, want, rtol=2e-5, atol=2e-4))
                if not torch.equal(got, want):
                    fail(f"{what}: kernel differs from its plain version")
                if (got < 0).any():
                    fail(f"{what}: negative violation")
                free = ops.sched_violation(s_, d_, dm,
                                           torch.full_like(caps, 1e9), T=T,
                                           use_kernel=True)
                if (free != 0).any():
                    fail(f"{what}: nonzero violation at caps 1e9")
    torch.cuda.synchronize()
    log(f"[parity] sched_violation on {len(sched_shapes)} shapes x "
        f"(float32, bfloat16) x (dem contiguous, transposed view): bit for "
        f"bit equal to the plain version (max abs err {sched_err}); zero at "
        f"caps 1e9, never negative")

    usl_err = 0.0
    exact = True
    for dtype in (torch.float32, torch.bfloat16):
        for shape in USL_SHAPES:
            args = [x.to(dtype) for x in on_card(usl_instance(shape))]
            got = ops.usl_runtime(*args, use_kernel=True)
            want = ops.usl_runtime(*args, use_kernel=False)
            usl_err = max(usl_err, close_outputs(
                f"usl_runtime {shape} {dtype}", got, want, rtol=1e-5,
                atol=1e-5))
            exact = exact and torch.equal(got, want)
    torch.cuda.synchronize()
    log(f"[parity] usl_runtime on {len(USL_SHAPES)} shapes x (float32, "
        f"bfloat16): within rtol 1e-5, atol 1e-5 of the plain version "
        f"(max abs err {usl_err}, bit for bit: {exact})")

    # small end-to-end: the kernel route and the plain route give one plan
    def same_plans(what, xs, ys):
        for x, y in zip(xs, ys):
            if not (np.array_equal(x.option_idx, y.option_idx)
                    and np.array_equal(x.start, y.start)
                    and np.array_equal(x.finish, y.finish)):
                fail(f"{what}: kernel and plain routes disagree")
            if x.energy != y.energy:
                fail(f"{what}: energies differ")

    small = vec.VecConfig(chains=8, iters=40, grid=128, seed=0)
    c20 = alibaba_cluster(machines=20)
    dags = synth_trace(3, c20, seed=11)
    for d in dags:
        d.release_time = 0.0
    probs = [tdag.flatten([d], c20.num_resources) for d in dags]
    for solve in (vec.vectorized_anneal_many, vec.vectorized_anneal_shared):
        packed = tdag.pack_problems(probs, c20.num_resources, bucket_p=4)
        tape = vec.draw_tape(packed, small, dev)
        plans = []
        for use_kernel in (True, False):
            cfg = dataclasses.replace(small, use_kernel=use_kernel)
            out = solve(probs, c20, Goal.balanced(), cfg, bucket_p=4,
                        device=dev, tape=tape)
            plans.append(out[0] if isinstance(out, tuple) else out)
        same_plans(solve.__name__, *plans)
    small_ising = ising.IsingConfig(chains=32, iters=100, seed=0)
    tape = ising.ising_tape(probs[0].option_arrays()[3], small_ising, dev)
    plans = [[ising.ising_anneal(
        probs[0], c20, Goal.balanced(),
        dataclasses.replace(small_ising, use_kernel=use_kernel),
        device=dev, tape=tape)] for use_kernel in (True, False)]
    same_plans("ising_anneal", *plans)
    log("[parity] small isolated, shared and ising solves: kernel route == "
        "plain route, plan for plan")

    # 3-4. the main path and the ising path at their config defaults ---------
    usl_kernel.usl_runtime.launches = 0      # no path calls it
    cfg = vec.VecConfig()
    icfg = ising.IsingConfig()
    results = {}

    def serve(name, solver, cluster, seeds, shared, release_zero):
        """Warm a bucket-16 session up and serve a batch of 16 per seed;
        check plans, signatures and the path kernel's launches."""
        if solver == "ising":
            counted, call = sv_kernel.sched_violation, "sched_violation"
            per_solve, at = icfg.iters + 1, icfg.iters // 2
        else:
            counted, call = kernel.sgs_decode, "sgs_decode"
            per_solve = cfg.iters + 1 + (1 if shared else 0)
            at = cfg.iters // 2
        batches = [synth_trace(16, cluster, seed=s) for s in seeds]
        if release_zero:           # tenants contend for the same cores
            for b in batches:
                for d in b:
                    d.release_time = 0.0
        template = max(batches[0], key=lambda d: d.num_tasks)
        envelope = (template.num_tasks,
                    max(len(t.options) for t in template.tasks))
        for b in batches:
            jmax = max(d.num_tasks for d in b)
            omax = max(len(t.options) for d in b for t in d.tasks)
            if (jmax, omax) != envelope:
                fail(f"{name}: batch envelope {(jmax, omax)} != template's "
                     f"{envelope}")
        agora = Agora(cluster, solver=solver, vec_cfg=cfg, device=dev)
        sess = agora.session(shared_capacity=shared, bucket_p=16)
        torch.cuda.synchronize()
        counted.launches = 0
        t0 = time.monotonic()
        warm = sess.warmup(template)
        warm_s = time.monotonic() - t0
        traces = sess.stats.trace_count
        steady, captured = [], None
        for i, batch in enumerate(batches):
            t0 = time.monotonic()
            if i == 0:
                with Capture(ops, call, at=at) as cap:
                    res = sess.plan(batch)
                captured = (cap.args, cap.T)
            else:
                res = sess.plan(batch)
            steady.append(time.monotonic() - t0)
            for r in res:
                errs = r.validate()
                if errs:
                    fail(f"{name}: invalid plan {r.request.name}: {errs[:3]}")
                if shared and r.plan.joint_errors:
                    fail(f"{name}: joint violations {r.plan.joint_errors[:3]}")
                if not np.all(np.isfinite([r.makespan, r.cost])):
                    fail(f"{name}: non-finite makespan or cost")
            if len(res) != len(batch):
                fail(f"{name}: {len(res)} plans for {len(batch)} requests")
        torch.cuda.synchronize()
        launches = counted.launches
        # the ising engine solves an isolated batch one problem at a time
        per_batch = [len(b) if solver == "ising" and not shared else 1
                     for b in batches]
        solves = 1 + sum(per_batch)
        if sess.stats.trace_count != traces:
            fail(f"{name}: {sess.stats.trace_count - traces} new signatures "
                 f"after warmup")
        need = solves * per_solve
        if launches < need:
            fail(f"{name}: {call} launched {launches} times, expected at "
                 f"least {need}")
        bs = sess.stats.bucket(16)
        log(f"[{name}] warmup {warm_s:.3f} s ({warm}); steady batches "
            f"{[round(s, 3) for s in steady]} s; bucket 16 warmup_seconds "
            f"{bs.warmup_seconds:.3f} steady_seconds {bs.steady_seconds:.3f}; "
            f"trace_count {sess.stats.trace_count}; {call} launches "
            f"{launches} over {solves} solves")
        results[name] = dict(launches=launches, captured=captured,
                             solve_s=steady, warm_s=warm_s)
        if profile:
            if solver == "ising" and not shared:
                # one request: a batch is 16 sequential solves
                t0 = time.monotonic()
                sess.plan(batches[-1][:1])
                one_s = time.monotonic() - t0
                profile_solve(name, sess, batches[-1][:1], one_s)
            else:
                profile_solve(name, sess, batches[-1], steady[-1])

    def quickstart(name, solver, counted, per_solve):
        counted.launches = 0
        pc = paper_cluster()
        t0 = time.monotonic()
        plan = Agora(pc, solver=solver, vec_cfg=cfg, device=dev).plan(
            [dag1(pc)])
        quick_s = time.monotonic() - t0
        if plan.validate():
            fail(f"{name}: invalid plan {plan.validate()[:3]}")
        if counted.launches < per_solve:
            fail(f"{name}: kernel launched {counted.launches} times")
        log(f"[{name}] dag1 on paper_cluster: makespan {plan.makespan:.1f} "
            f"s cost ${plan.cost:.2f} in {quick_s:.3f} s; kernel launches "
            f"{counted.launches}")

    serve("isolated", "vectorized", alibaba_cluster(), (1, 2), shared=False,
          release_zero=False)
    serve("shared", "vectorized", alibaba_cluster(machines=20), (3, 5),
          shared=True, release_zero=True)
    quickstart("quickstart", "vectorized", kernel.sgs_decode, cfg.iters + 1)

    serve("ising-isolated", "ising", alibaba_cluster(), (1,), shared=False,
          release_zero=False)
    serve("ising-shared", "ising", alibaba_cluster(machines=20), (3,),
          shared=True, release_zero=True)
    quickstart("ising-quickstart", "ising", sv_kernel.sched_violation,
               icfg.iters + 1)

    # 6. the grids past the envelope, the B=1 wrappers, the meshes, the
    # decode's shape ceiling ------------------------------------------------
    wide_launches, wide_args = wide_grid(dev, gpu, icfg)
    b1_wrappers(dev, kernel)
    meshes(dev, gpu, cfg, kernel)
    pool_routes, pool_decode, block_case, (chain, ghz) = wide_decode(
        dev, gpu, cfg, kernel, ops)

    # kernel numbers at the paths' shapes ------------------------------------
    entries = []

    def entry(name, launches, err, ms, plain_ms, bound_ms, bound_by):
        kernel_name = name.split("[")[0]
        source, replaces = KERNELS[kernel_name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

    for name in ("isolated", "shared"):
        args, T = results[name]["captured"]
        if args is None:
            fail(f"{name}: no decode captured")
        k_args = [args[0].contiguous(), args[1].contiguous(),
                  args[2].contiguous(), *[x.contiguous() for x in
                                          ops._ref.as_groups(args[3], args[4])],
                  args[5].contiguous()]
        out_k = ops.sgs_decode(*args, T=T, use_kernel=True)
        out_p = ops.sgs_decode(*args, T=T, use_kernel=False)
        err = same_outputs(out_k, out_p)
        reps = 50 if name == "isolated" else 10
        call_ms = time_ms(lambda: kernel.sgs_decode(*k_args, T=T), reps)
        ms = kernel_ms(lambda: kernel.sgs_decode(*k_args, T=T), reps)
        # the wide route on the same inputs, for the choice of route; these
        # launches are not on the path
        same_outputs(kernel.sgs_decode(*k_args, T=T, route="wide"), out_p)
        wide_ms = kernel_ms(lambda: kernel.sgs_decode(*k_args, T=T,
                                                      route="wide"), reps)
        plain_ms = time_ms(lambda: ops.sgs_decode(*args, T=T,
                                                  use_kernel=False), reps=3)
        bound_ms, bound_by, nbytes, nops = bound(args, out_k, T)
        rows, J = args[0].shape
        M, G = args[5].shape[0], k_args[3].shape[0]
        _, warps, smem, _, _ = kernel.geometry(rows, J, M, T, rows // G)
        log(f"[{name}] decode rows {rows} J {J} M {M} T {T}: kernel "
            f"{ms:.4f} ms/launch on the device, {ms * 1e3 / J:.3f} us per "
            f"step ({call_ms:.4f} ms per call as launched; {warps} rows per "
            f"block, {smem} B shared memory per block); the wide route on "
            f"the same inputs {wide_ms:.4f} ms; plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}; {nbytes} B, {nops} ops), "
            f"latency floor {J * chain / ghz * 1e-6:.5f} ms")
        entry(f"sgs_decode[{name}]", results[name]["launches"], err, ms,
              plain_ms, bound_ms, bound_by)

    # the wide route, on a decode of phase 6d's 128-tenant pool
    args, T = pool_decode
    k_args = [args[0].contiguous(), args[1].contiguous(), args[2].contiguous(),
              *[x.contiguous() for x in ops._ref.as_groups(args[3], args[4])],
              args[5].contiguous()]
    out_k = ops.sgs_decode(*args, T=T, use_kernel=True)
    err = same_outputs(out_k, ops.sgs_decode(*args, T=T, use_kernel=False))
    rows, J = args[0].shape
    M, G = args[5].shape[0], k_args[3].shape[0]
    route, warps, smem, _, scratch = kernel.geometry(rows, J, M, T, rows // G)

    def pool_call():
        kernel.sgs_decode(*k_args, T=T)

    call_ms = time_ms(pool_call, 20)
    ms = kernel_ms(pool_call, 20)
    block_ms = kernel_ms(lambda: kernel.sgs_decode(*k_args, T=T,
                                                   route="wide-block"), 5)
    host_med, host_max, pauses = host_gap(pool_call, 50)
    plain_ms = time_ms(lambda: ops.sgs_decode(*args, T=T, use_kernel=False),
                       reps=1)
    bound_ms, bound_by, nbytes, nops = bound(args, out_k, T)
    floor_ms = J * chain / ghz * 1e-6
    log(f"[pool 128] decode rows {rows} J {J} M {M} T {T}: route {route} "
        f"(W {warps}, {smem} B shared memory a block, {scratch} B scratch): "
        f"kernel {ms:.4f} ms/launch on the device, {ms * 1e3 / J:.3f} us per "
        f"step ({call_ms:.4f} ms per call as launched, 20 calls); the "
        f"wide-block route on the same inputs {block_ms:.4f} ms; plain "
        f"{plain_ms:.1f} ms; bound {bound_ms:.5f} ms ({bound_by}; {nbytes} "
        f"B, {nops} ops), latency floor {floor_ms:.4f} ms ({J} chains of "
        f"{chain:.1f} cycles at {ghz:.3f} GHz) ({gpu})")
    pieces = kernel.probe_host(k_args[4], rows, T, M)
    torch.cuda._sleep(1 << 26)
    busy = kernel.probe_host(k_args[4], rows, T, M, reps=20)
    torch.cuda.synchronize()
    log(f"[pool 128] host work of a call: median {host_med:.4f} ms, max "
        f"{host_max:.4f} ms over 50 calls back to back (the device takes "
        f"{ms:.4f}); garbage collector pauses among them: "
        f"{len(pauses)}, {sum(pauses):.3f} ms in all. Microseconds a call of "
        f"each piece of host work a launch repeated before the card's facts "
        f"were read once per device (device idle / behind a busy device): "
        + ", ".join(f"{k} {v:.2f}/{busy[k]:.2f}" for k, v in pieces.items()))
    entry("sgs_decode[wide]", pool_routes["wide"], err, ms, plain_ms,
          bound_ms, bound_by)

    # the wide-block route: J 4096, 8 rows (phase 6d); no path here reaches
    # it, so its launches on the paths are the pool's on that route (0)
    args, T, out_k, plain_ms = block_case
    err = same_outputs(out_k, ops.sgs_decode(*args, T=T, use_kernel=False))
    ms = kernel_ms(lambda: kernel.sgs_decode(*args, T=T), 5)
    bound_ms, bound_by, nbytes, nops = bound(args, out_k, T)
    rows, J = args[0].shape
    log(f"[sgs_decode wide-block] rows {rows} J {J} M {args[5].shape[0]} T "
        f"{T}: kernel {ms:.4f} ms/launch on the device, "
        f"{ms * 1e3 / J:.3f} us per step, plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}), latency floor "
        f"{J * chain / ghz * 1e-6:.4f} ms; launches on the paths "
        f"{pool_routes['wide-block']} ({gpu})")
    entry("sgs_decode[wide-block]", pool_routes["wide-block"], err, ms,
          plain_ms, bound_ms, bound_by)

    empty_ms = kernel_ms(lambda: torch.cuda._sleep(0), 200)
    log(f"[launch floor] an empty kernel (torch.cuda._sleep(0)), back to "
        f"back: {empty_ms:.5f} ms/launch on the device")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("isolated", "shared"):
        args, T = results[f"ising-{name}"]["captured"]
        if args is None:
            fail(f"ising-{name}: no sched_violation call captured")
        B, M, J = args[2].shape
        got = ops.sched_violation(*args, T=T, use_kernel=True)
        want = ops.sched_violation(*args, T=T, use_kernel=False)
        err = close_outputs(f"sched_violation[{name}]", got, want,
                            rtol=2e-5, atol=2e-4)
        if not torch.equal(got, want):
            fail(f"sched_violation[{name}]: kernel differs from its plain "
                 f"version on the captured inputs")
        R, W, C, K, N = sv_kernel.geometry(B, M, T, sms)
        k_args = [x.float().contiguous() for x in args]
        contig_ms = kernel_ms(lambda: sv_kernel.sched_violation(*k_args,
                                                                T=T), 200)
        # the general layout (K = 0) on the same inputs, for the layout
        # choice; these launches are not on the path
        general = sv_kernel.sched_violation(*args, T=T, geom=(R, W, C, 0))
        if not torch.equal(general, got):
            fail(f"sched_violation[{name}]: the general layout differs "
                 f"from the bin-major one")
        general_ms = kernel_ms(lambda: sv_kernel.sched_violation(
            *args, T=T, geom=(R, W, C, 0)), 200)
        log(f"[ising-{name}] sched_violation B {B} J {J} M {M} T {T}: R "
            f"{R} candidates a block, W {W} warps a candidate, C {C} cells "
            f"a lane, layout K {K} (N {N}); on contiguous inputs "
            f"{contig_ms:.5f} ms/launch on the device; the general layout "
            f"(K 0) as passed {general_ms:.5f} ms/launch; dem as the ising "
            f"loop passes it has strides {tuple(args[2].stride())}")
        none = [torch.zeros((B, 0), device=dev), torch.zeros((B, 0),
                device=dev), torch.zeros((B, M, 0), device=dev), args[3]]
        no_task_ms = kernel_ms(lambda: sv_kernel.sched_violation(*none, T=T),
                               200)
        # timed as the ising loop passes the inputs: no copy of dem
        call_ms = time_ms(lambda: sv_kernel.sched_violation(*args, T=T),
                          reps=200)
        ms = kernel_ms(lambda: sv_kernel.sched_violation(*args, T=T), 200)
        plain_ms = time_ms(lambda: ops.sched_violation(*args, T=T,
                                                       use_kernel=False),
                           reps=5)
        bound_ms, bound_by, nbytes, nops = sched_bound(args, T)
        log(f"[ising-{name}] sched_violation as passed: kernel {ms:.5f} "
            f"ms/launch on the device ({call_ms:.4f} ms per call as "
            f"launched), plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}; {nbytes} B, {nops} ops), launch floor: "
            f"{no_task_ms:.5f} ms with no tasks, {empty_ms:.5f} ms empty; "
            f"max abs err {err}")
        check_no_copy(f"sched_violation[{name}]",
                      lambda: sv_kernel.sched_violation(*args, T=T))
        entry(f"sched_violation[{name}]", results[f"ising-{name}"]["launches"],
              err, ms, plain_ms, bound_ms, bound_by)

    # the wide path (phase 6a's grids): B 512, J 10, M 4, T 2048, beside
    # the bin-major path on the same tasks at T 256
    T = 2048
    args = on_card(sched_instance(512, 10, 4, T))
    got = ops.sched_violation(*args, T=T, use_kernel=True)
    want = ops.sched_violation(*args, T=T, use_kernel=False)
    err = close_outputs("sched_violation[wide]", got, want, rtol=2e-5,
                        atol=2e-4)
    if not torch.equal(got, want):
        fail("sched_violation[wide]: kernel differs from its plain version")
    ms = kernel_ms(lambda: sv_kernel.sched_violation(*args, T=T), 200)
    call_ms = time_ms(lambda: sv_kernel.sched_violation(*args, T=T), 200)
    plain_ms = time_ms(lambda: ops.sched_violation(*args, T=T,
                                                   use_kernel=False), reps=5)
    bound_ms, bound_by, nbytes, nops = sched_bound(args, T)
    narrow = [args[0] / 8, args[1] / 8, args[2], args[3]]
    narrow_ms = kernel_ms(lambda: sv_kernel.sched_violation(*narrow, T=256),
                          200)
    live_ms = kernel_ms(lambda: sv_kernel.sched_violation(*wide_args,
                                                          T=2048), 200)
    log(f"[sched_violation wide] B 512 J 10 M 4 T {T} (8192 cells, two "
        f"passes of 4096): kernel {ms:.5f} ms/launch on the device "
        f"({call_ms:.4f} ms per call as launched), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}; {nbytes} B, {nops} ops); the "
        f"same tasks scaled to T 256 on the bin-major path {narrow_ms:.5f} "
        f"ms/launch; phase 6a's live inputs (J "
        f"{wide_args[2].shape[2]}, dem as the ising loop passes it) "
        f"{live_ms:.5f} ms/launch; max abs err {err} ({gpu})")
    entry("sched_violation[wide]", wide_launches, err, ms, plain_ms, bound_ms,
          bound_by)

    # usl_runtime: no path calls it; a grid of 4096 tasks x 256 configurations
    path_launches = usl_kernel.usl_runtime.launches
    rng = np.random.default_rng(0)
    shape = (4096, 256)
    draws = (np.broadcast_to(rng.integers(1, 257, (1, 256)), shape),
             rng.uniform(0, 0.2, shape), rng.uniform(0, 0.01, shape),
             rng.uniform(0.5, 3, shape), rng.uniform(10, 1000, shape))
    # C-contiguous float32 (numpy's cast of the broadcast is column-major),
    # so the wrapper's .contiguous() runs no copy kernel in a timed call
    grid = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in draws]
    got = ops.usl_runtime(*grid, use_kernel=True)
    err = close_outputs("usl_runtime[grid]", got,
                        ops.usl_runtime(*grid, use_kernel=False),
                        rtol=1e-5, atol=1e-5)
    # six copies of the grid's 20 MB of inputs: the five calls between two
    # reads of one copy touch 120 MB with their outputs, against the 50 MB
    # L2, so each call of the rotation reads its inputs from HBM, as the
    # bound counts them
    grids = itertools.cycle([grid] + [[x.clone() for x in grid]
                                      for _ in range(5)])
    call_ms = time_ms(lambda: usl_kernel.usl_runtime(*next(grids)), reps=200)
    ms = kernel_ms(lambda: usl_kernel.usl_runtime(*next(grids)), 200)
    hot_ms = kernel_ms(lambda: usl_kernel.usl_runtime(*grid), 200)
    plain_ms = time_ms(lambda: ops.usl_runtime(*grid, use_kernel=False),
                       reps=50)
    bound_ms, bound_by, nbytes, nops = usl_bound(got.numel())
    check_no_copy("usl_runtime[grid]", lambda: usl_kernel.usl_runtime(*grid))
    log(f"[usl_runtime] grid {shape}, contiguous float32: kernel {ms:.5f} "
        f"ms/launch on the device from HBM, {hot_ms:.5f} ms with the inputs "
        f"in L2 ({call_ms:.4f} ms per call as launched), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; {nbytes} "
        f"B, {nops} ops), {bound_ms / ms:.2f} of the bound; max abs err "
        f"{err}; launches on the paths {path_launches}")
    entry("usl_runtime[grid]", path_launches, err, ms, plain_ms, bound_ms,
          bound_by)

    lap("1-4, 6 and the kernels' numbers")

    # 5. the control plane ---------------------------------------------------
    control_plane(dev, gpu, cfg, icfg)

    lap("5")

    # 7. plan quality against the reference ----------------------------------
    quality(dev, gpu)
    lap("7")

    # 8. the dense, MoE and SSM model families at full width -----------------
    decode_ms, serve_peaks = serve_models(dev, gpu)
    lap("8")

    # 9. training -------------------------------------------------------------
    step_ms = train_models(dev, gpu)
    lap("9")

    # 10. the dry run, its roofline against the card, GPipe ------------------
    dry_step = dryrun_models(dev, gpu, step_ms, decode_ms[TRAIN_ARCH])
    lap("10")

    # 11. the attention family sharded over a (data, model) mesh -------------
    sharded_models(dev, gpu, decode_ms[SHARD_ARCH], dry_step)
    lap("11")

    # 12. MLA, the VLM's groups, RWKV6 and Mamba2 sharded -------------------
    sharded_families(dev, gpu, decode_ms[FAMILY_ARCH],
                     serve_peaks[FAMILY_ARCH])
    lap("12")

    # 13. a mesh whose entries sit on the card and on the CPU ---------------
    mixed_mesh(dev, gpu)
    lap("13")
    log(f"[time] the whole run: {time.monotonic() - laps[0]:.1f} s")

    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
