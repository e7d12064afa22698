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
   with an odd group size at J > 32); ``sched_violation`` on
   the shapes of ``tests/test_kernels.py`` in float32 and bfloat16 (rtol
   2e-5, atol 2e-4; zero at caps 1e9, never negative); ``usl_runtime`` on
   that file's shapes in float32 and bfloat16 (rtol 1e-5, atol 1e-5); and
   small vectorized and ising solves whose plans must not depend on which
   of the two routes ran;
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
   ``sched_violation`` kernel must have run iters + 1 times per solve.

The inputs of one kernel call of each session are captured, checked
against the plain version and timed; ``usl_runtime``, which no path
calls, is timed on a grid of 4096 tasks x 256 configurations.

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and, as the last line, {"ok": true, "device": {...}}. Exits
non-zero without that line when CUDA is not available, when the port's
sources are not beside this script, or when any check fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile {name}]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d} x {e.key[:70]}")


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
    from _decode_cases import (SCHED_SHAPES, USL_SHAPES, kernel_cases,
                               sched_instance, usl_instance)

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

    # 1. build ---------------------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build(*KERNELS)
    log(f"[build] {len(libs)} kernels in {time.monotonic() - t0:.2f} s "
        f"(one nvcc each, in parallel)")
    for name, lib in libs.items():
        log(f"[build] {KERNELS[name][0]} -> {os.path.relpath(lib, ROOT)} "
            f"(nvcc {_build.seconds[name]:.2f} s)")
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"[build] {name}: {line.strip()}")

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

    sched_err = 0.0
    exact = True
    for dtype in (torch.float32, torch.bfloat16):
        for B, J, M, T in SCHED_SHAPES:
            start, dur, dem, caps = on_card(sched_instance(B, J, M, T))
            start, dur, dem = (x.to(dtype) for x in (start, dur, dem))
            got = ops.sched_violation(start, dur, dem, caps, T=T,
                                      use_kernel=True)
            want = ops.sched_violation(start, dur, dem, caps, T=T,
                                       use_kernel=False)
            sched_err = max(sched_err, close_outputs(
                f"sched_violation {(B, J, M, T)} {dtype}", got, want,
                rtol=2e-5, atol=2e-4))
            exact = exact and torch.equal(got, want)
            if (got < 0).any():
                fail(f"sched_violation {(B, J, M, T)}: negative violation")
            free = ops.sched_violation(start, dur, dem,
                                       torch.full_like(caps, 1e9), T=T,
                                       use_kernel=True)
            if (free != 0).any():
                fail(f"sched_violation {(B, J, M, T)}: nonzero violation at "
                     f"caps 1e9")
    torch.cuda.synchronize()
    log(f"[parity] sched_violation on {len(SCHED_SHAPES)} shapes x "
        f"(float32, bfloat16): within rtol 2e-5, atol 2e-4 of the plain "
        f"version (max abs err {sched_err}, bit for bit: {exact}); zero at "
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
        plain_ms = time_ms(lambda: ops.sgs_decode(*args, T=T,
                                                  use_kernel=False), reps=3)
        bound_ms, bound_by, nbytes, nops = bound(args, out_k, T)
        rows, J = args[0].shape
        M, G = args[5].shape[0], k_args[3].shape[0]
        warps, smem, _, _ = kernel.geometry(rows, J, M, T, rows // G)
        log(f"[{name}] decode rows {rows} J {J} M {M} T {T}: kernel "
            f"{ms:.4f} ms/launch on the device, {ms * 1e3 / J:.3f} us per "
            f"step ({call_ms:.4f} ms per call as launched; {warps} rows per "
            f"block, {smem} B shared memory per block), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
            f"{nbytes} B, {nops} ops)")
        entry(f"sgs_decode[{name}]", results[name]["launches"], err, ms,
              plain_ms, bound_ms, bound_by)

    for name in ("isolated", "shared"):
        args, T = results[f"ising-{name}"]["captured"]
        if args is None:
            fail(f"ising-{name}: no sched_violation call captured")
        k_args = [x.float().contiguous() for x in args]
        got = ops.sched_violation(*args, T=T, use_kernel=True)
        want = ops.sched_violation(*args, T=T, use_kernel=False)
        err = close_outputs(f"sched_violation[{name}]", got, want,
                            rtol=2e-5, atol=2e-4)
        call_ms = time_ms(lambda: sv_kernel.sched_violation(*k_args, T=T),
                          reps=200)
        ms = kernel_ms(lambda: sv_kernel.sched_violation(*k_args, T=T),
                       200)
        plain_ms = time_ms(lambda: ops.sched_violation(*args, T=T,
                                                       use_kernel=False),
                           reps=5)
        bound_ms, bound_by, nbytes, nops = sched_bound(args, T)
        B, M, J = args[2].shape
        log(f"[ising-{name}] sched_violation B {B} J {J} M {M} T {T}: "
            f"kernel {ms:.4f} ms/launch on the device ({call_ms:.4f} ms "
            f"per call as launched), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}; {nbytes} B, {nops} ops), max "
            f"abs err {err}")
        entry(f"sched_violation[{name}]", results[f"ising-{name}"]["launches"],
              err, ms, plain_ms, bound_ms, bound_by)

    # usl_runtime: no path calls it; a grid of 4096 tasks x 256 configurations
    path_launches = usl_kernel.usl_runtime.launches
    rng = np.random.default_rng(0)
    shape = (4096, 256)
    grid = on_card([np.asarray(x, np.float32) for x in (
        np.broadcast_to(rng.integers(1, 257, (1, 256)), shape),
        rng.uniform(0, 0.2, shape), rng.uniform(0, 0.01, shape),
        rng.uniform(0.5, 3, shape), rng.uniform(10, 1000, shape))])
    got = ops.usl_runtime(*grid, use_kernel=True)
    err = close_outputs("usl_runtime[grid]", got,
                        ops.usl_runtime(*grid, use_kernel=False),
                        rtol=1e-5, atol=1e-5)
    call_ms = time_ms(lambda: usl_kernel.usl_runtime(*grid), reps=200)
    ms = kernel_ms(lambda: usl_kernel.usl_runtime(*grid), 200)
    plain_ms = time_ms(lambda: ops.usl_runtime(*grid, use_kernel=False),
                       reps=50)
    bound_ms, bound_by, nbytes, nops = usl_bound(got.numel())
    log(f"[usl_runtime] grid {shape}: kernel {ms:.4f} ms/launch on the "
        f"device ({call_ms:.4f} ms per call as launched), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; {nbytes} "
        f"B, {nops} ops), max abs err {err}; launches on the paths "
        f"{path_launches}")
    entry("usl_runtime[grid]", path_launches, err, ms, plain_ms, bound_ms,
          bound_by)

    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
