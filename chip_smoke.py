#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each failing loudly (no phase's failure is caught):

1. build  — compile the port's CUDA kernel (``src/repro_torch/kernels/csrc``)
   from the checkout's sources and print ptxas' register/shared-memory
   report;
2. parity — the kernel against its plain PyTorch version on the card, bit
   for bit: the instances of the decode tests (``tests/_decode_cases.py``:
   the random sweep, the edge cases, grouped G > 1 calls, J above the
   block's thread count), and a small end-to-end solve whose plans must
   not depend on which of the two decodes ran;
3. main path — ``Agora(..., solver="vectorized", vec_cfg=VecConfig())``
   (256 chains, 600 sweeps, 256 time bins) serves an isolated session and
   a shared-capacity session (bucket 16: warm up, then two batches of 16
   DAGs each) and one quickstart ``agora.plan``. Every plan must validate,
   shared batches must have no joint violation, warm traffic must run no
   new signature, and the kernel's launch counter must show each solve
   went through it (iters + 1 launches at least). The decode inputs of one
   sweep of each session are captured, checked against the plain version
   and timed.

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
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sgs_decode.cu"
TPU_KERNEL = "src/repro/kernels/sgs_decode.py:39"

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


def bound(args, out, T):
    """Least time the card needs for one decode of these inputs: each input
    read once, each output written once, over HBM; the simple float32/int
    operations this run's data needs over the float32 peak."""
    import torch
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


class Capture:
    """Wraps ``kernels.ops.sgs_decode`` and keeps a copy of the inputs of
    the ``at``-th call (the decode of one sweep of a live solve)."""

    def __init__(self, ops, at: int):
        self.ops, self.orig, self.at, self.n = ops, ops.sgs_decode, at, 0
        self.args = self.T = None

    def __call__(self, *args, **kw):
        if self.n == self.at:
            self.args, self.T = [a.clone() for a in args], kw["T"]
        self.n += 1
        return self.orig(*args, **kw)

    def __enter__(self):
        self.ops.sgs_decode = self
        return self

    def __exit__(self, *exc):
        self.ops.sgs_decode = self.orig


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
    if not os.path.exists(os.path.join(ROOT, KERNEL_SOURCE)):
        print(f"chip_smoke: {KERNEL_SOURCE} not found beside this script; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    from _decode_cases import kernel_cases

    from repro_torch.cluster.catalog import alibaba_cluster, paper_cluster
    from repro_torch.cluster.workloads import dag1, synth_trace
    from repro_torch.core import dag as tdag
    from repro_torch.core import vectorized as vec
    from repro_torch.core.agora import Agora
    from repro_torch.core.objectives import Goal
    from repro_torch.kernels import ops
    from repro_torch.kernels import sgs_decode as kernel

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(gpu)

    # 1. build ---------------------------------------------------------------
    t0 = time.monotonic()
    lib = kernel.build()
    log(f"[build] {KERNEL_SOURCE} -> {os.path.relpath(lib, ROOT)} in "
        f"{time.monotonic() - t0:.2f} s (nvcc {kernel.build.seconds:.2f} s)")
    report = lib.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {line.strip()}")

    # 2. kernel against its plain version, on the card -----------------------
    def on_card(args):
        return [torch.from_numpy(a).to(dev) for a in args]

    cases = kernel_cases()
    for args, T in cases:
        a = on_card(args)
        same_outputs(ops.sgs_decode(*a, T=T, use_kernel=True),
                     ops.sgs_decode(*a, T=T, use_kernel=False))
    torch.cuda.synchronize()
    log(f"[parity] {len(cases)} decode instances: kernel == plain version")

    # small end-to-end: the kernel route and the plain route give one plan
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
        for x, y in zip(*plans):
            if not (np.array_equal(x.option_idx, y.option_idx)
                    and np.array_equal(x.start, y.start)
                    and np.array_equal(x.finish, y.finish)):
                fail(f"{solve.__name__}: kernel and plain routes disagree")
            if x.energy != y.energy:
                fail(f"{solve.__name__}: energies differ")
    log("[parity] small isolated and shared solves: kernel route == plain "
        "route, plan for plan")

    # 3. the main path at VecConfig() defaults -------------------------------
    cfg = vec.VecConfig()
    per_solve = cfg.iters + 1
    results = {}

    def serve(name, cluster, seeds, shared, release_zero):
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
        agora = Agora(cluster, solver="vectorized", vec_cfg=cfg, device=dev)
        sess = agora.session(shared_capacity=shared, bucket_p=16)
        torch.cuda.synchronize()
        kernel.sgs_decode.launches = 0
        t0 = time.monotonic()
        warm = sess.warmup(template)
        warm_s = time.monotonic() - t0
        traces = sess.stats.trace_count
        steady, captured = [], None
        for i, batch in enumerate(batches):
            t0 = time.monotonic()
            if i == 0:
                with Capture(ops, at=cfg.iters // 2) as cap:
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
        launches = kernel.sgs_decode.launches
        solves = 1 + len(batches)
        if sess.stats.trace_count != traces:
            fail(f"{name}: {sess.stats.trace_count - traces} new signatures "
                 f"after warmup")
        need = solves * (per_solve + (1 if shared else 0))
        if launches < need:
            fail(f"{name}: kernel launched {launches} times, expected at "
                 f"least {need}")
        bs = sess.stats.bucket(16)
        log(f"[{name}] warmup {warm_s:.3f} s ({warm}); steady solves "
            f"{[round(s, 3) for s in steady]} s; bucket 16 warmup_seconds "
            f"{bs.warmup_seconds:.3f} steady_seconds {bs.steady_seconds:.3f}; "
            f"trace_count {sess.stats.trace_count}; kernel launches "
            f"{launches} over {solves} solves")
        results[name] = dict(launches=launches, captured=captured,
                             solve_s=steady, warm_s=warm_s)
        if profile:
            profile_solve(name, sess, batches[-1], steady[-1])

    serve("isolated", alibaba_cluster(), (1, 2), shared=False,
          release_zero=False)
    serve("shared", alibaba_cluster(machines=20), (3, 5), shared=True,
          release_zero=True)

    kernel.sgs_decode.launches = 0
    pc = paper_cluster()
    t0 = time.monotonic()
    plan = Agora(pc, solver="vectorized", vec_cfg=cfg, device=dev).plan(
        [dag1(pc)])
    quick_s = time.monotonic() - t0
    if plan.validate():
        fail(f"quickstart: invalid plan {plan.validate()[:3]}")
    if kernel.sgs_decode.launches < per_solve:
        fail(f"quickstart: kernel launched {kernel.sgs_decode.launches} times")
    log(f"[quickstart] dag1 on paper_cluster: makespan {plan.makespan:.1f} s "
        f"cost ${plan.cost:.2f} in {quick_s:.3f} s; kernel launches "
        f"{kernel.sgs_decode.launches}")

    # kernel numbers at the main path's shapes --------------------------------
    entries = []
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
        ms = time_ms(lambda: kernel.sgs_decode(*k_args, T=T),
                     reps=50 if name == "isolated" else 10)
        plain_ms = time_ms(lambda: ops.sgs_decode(*args, T=T,
                                                  use_kernel=False), reps=3)
        bound_ms, bound_by, nbytes, nops = bound(args, out_k, T)
        rows, J = args[0].shape
        log(f"[{name}] decode rows {rows} J {J} M {args[5].shape[0]} T {T}: "
            f"kernel {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B, {nops} ops)")
        entries.append(dict(
            name=f"sgs_decode[{name}]", route="cuda", source=KERNEL_SOURCE,
            replaces=TPU_KERNEL, launches=results[name]["launches"],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
