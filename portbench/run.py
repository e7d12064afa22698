"""Run one cell of the port's benchmark on this machine's card.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the checks as the last lines of
standard error and one JSON result as the last line of standard output;
exits with another code than 0, printing no result, where there is no
card, where a run loaded JAX or the JAX package, or where anything fails.
Builds and caches stay inside the checkout: the kernels under
``build/repro_torch/`` (the program's fixed place), everything else under
``portbench/.cache/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (the kernel's
    record of it, in clock ticks since boot); this module's import time
    where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        since = (time.clock_gettime(time.CLOCK_BOOTTIME)
                 - ticks / os.sysconf("SC_CLK_TCK"))
        return time.monotonic() - max(since, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_IMPORT


def setup_env(host: dict) -> None:
    """Caches inside the checkout, and the host settings of the cell's
    deployment (its configuration's ``host``), before anything loads the
    math libraries."""
    cache = ROOT / "portbench" / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    threads = host.get("math_threads")
    if threads:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(threads)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: str = "cuda", scale=None,
         drain_s: float = None) -> int:
    """The command. ``device``, ``scale`` and ``drain_s`` are for the CPU
    tests, which run a cell's path on the CPU at a size it holds."""
    t_proc = process_start()
    args = parse(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    with open(ROOT / "portbench" / "configs" / f"{cell['config']}.json") as f:
        setup_env(json.load(f).get("host", {}))
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness, importcheck
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} cards, this "
                  f"machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
    kw = {} if drain_s is None else {"drain_s": drain_s}
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device=device, t_proc=t_proc,
                           scale=scale, root=ROOT, **kw)
    bad = importcheck.forbidden_loaded()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 3
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
