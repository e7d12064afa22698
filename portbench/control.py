"""The controls of ``correct``: what a run has to read as not correct.

``float32``: the reference, put in the program's place, in the precision
below the one the configurations state for times. It plans the same
requests as a run (the DAGs drawn from the seed, in the traffic mix's
batches) with the reference's own planner (each task's option by the
balanced key of the paper's separate-optimisation baseline,
downstream-count priority, serial SGS) holding its times in float32, and
hands its plans to the same check as a run's: ``plan_err`` reads about
1e-7, far over its limit. It needs no card.

The faults (``FAULTS``), planted in the program, run a whole cell on the
card through the harness, and are read against the floor on the plans'
mean gain (``limits.plan_gain_min``):

* ``sa_frozen``: every SA sweep does its work and returns its state
  unchanged;
* ``decode_bf16``: ``sgs_decode``'s floating inputs (demands, priorities,
  capacities) rounded to bfloat16, the precision below its float32.

``none`` runs the program as it is, for the sound readings.

    python portbench/control.py --workload <name> --seeds 1 2 3 \
        --control float32 [--requests N]
    python portbench/control.py --workload <name> --seeds 1 2 3 \
        --control none sa_frozen decode_bf16 --seconds 8

print one JSON line a control and seed. The benchmark's runs do not run
them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                    str(Path(__file__).resolve().parents[1])]

from portbench import gen, harness, reference  # noqa: E402


def balanced_options(g: Dict) -> np.ndarray:
    """Each task's option by 0.5 d / d_min + 0.5 c / c_min over its own
    options (``core/predictor.py:ernest_select``'s balanced key)."""
    out = np.zeros(len(g["default"]), np.int64)
    for j, n in enumerate(g["n_opts"]):
        d, c = g["dur"][j, :n], g["cost"][j, :n]
        out[j] = int(np.argmin(0.5 * d / d.min()
                               + 0.5 * c / max(c.min(), 1e-12)))
    return out


def control_plans(dags: List[Dict], cluster: Dict,
                  dtype=np.float32) -> List[Dict]:
    """The control's plans of DAGs that share the cluster, times in
    ``dtype``."""
    durs, dems, edges, prios, opts = [], [], [], [], []
    off = 0
    for g in dags:
        J = len(g["default"])
        oi = balanced_options(g)
        idx = np.arange(J)
        durs.append(g["dur"][idx, oi])
        dems.append(g["dem"][idx, oi])
        edges.append(np.asarray(g["edges"]).reshape(-1, 2) + off)
        prios.append(reference.downstream_counts(J, g["edges"]))
        opts.append(oi)
        off += J
    start, finish = reference.serial_sgs(
        np.concatenate(durs), np.concatenate(dems), np.concatenate(edges),
        np.concatenate(prios), cluster["caps"], dtype)
    prices = gen.prices_per_sec(cluster)
    out, off = [], 0
    for g, oi in zip(dags, opts):
        J = len(oi)
        s = start[off:off + J].astype(np.float64)
        f = finish[off:off + J].astype(np.float64)
        cost = dtype(reference.plan_cost(g, oi, prices))
        out.append(dict(option_idx=oi, start=s, finish=f,
                        makespan=float(f.max()), cost=float(cost)))
        off += J
    return out


def control_run(workload: str, seed: int, requests: int,
                dtype=np.float32) -> Dict:
    """Plan ``requests`` requests of ``workload`` from ``seed`` as the
    control does and check them as a run's answers are checked."""
    bench = harness.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    cluster = gen.cluster_arrays(config["cluster"])
    dags = gen.dag_arrays(config["dags"], traffic["dags"], cluster, seed)
    order = [k % len(dags) for k in range(requests)]
    size = (traffic["daemon"]["max_batch"]
            if traffic["pool"]["shared_capacity"] else 1)
    groups = [list(range(i, min(i + size, requests)))
              for i in range(0, requests, size)]
    plans: List = [None] * requests
    for grp in groups:
        for i, p in zip(grp, control_plans([dags[order[i]] for i in grp],
                                           cluster, dtype)):
            plans[i] = p
    res = reference.judge([dags[i] for i in order], plans, groups,
                          cluster["caps"], gen.prices_per_sec(cluster),
                          config["goal"]["w"], keys=order)
    limit = config["limits"]["plan_err"]
    return dict(workload=workload, seed=seed, requests=requests,
                dtype=np.dtype(dtype).name, plan_err=res["plan_err"],
                limit=limit, correct=res["plan_err"] <= limit
                and res["mismatched"] == 0 and res["missing"] == 0,
                why=res["why"])


FAULTS = ("sa_frozen", "decode_bf16")


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted (see the module's docstring);
    ``none`` plants nothing."""
    import torch

    from repro_torch.core import vectorized
    from repro_torch.kernels import ops
    saved = []

    def patch(owner, attr, fn):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def bf16(x):
        return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() \
            else x

    if fault == "sa_frozen":
        sweep = vectorized._Shard.sweep
        state = ("opt", "prio", "e", "best_opt", "best_prio", "best_e",
                 "jbest")

        def frozen(self, *a, **k):
            before = {key: getattr(self, key) for key in state}
            accept = sweep(self, *a, **k)
            for key, v in before.items():
                setattr(self, key, v)
            return accept
        patch(vectorized._Shard, "sweep", frozen)
    elif fault == "decode_bf16":
        decode = ops.sgs_decode

        def low(dur, dem, prio, release, pred, caps, *, T, use_kernel=None):
            return decode(dur, bf16(dem), bf16(prio), release, pred,
                          bf16(caps), T=T, use_kernel=use_kernel)
        patch(ops, "sgs_decode", low)
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def fault_run(workload: str, seed: int, seconds: float, fault: str,
              **kw) -> Dict:
    """One run of ``workload`` through the harness with ``fault`` planted:
    its verdict, checks and end-to-end metrics."""
    with planted(fault):
        out = harness.run_cell(workload, seed, seconds, False, **kw)
    line = out["line"]
    return dict(workload=workload, seed=seed, control=fault,
                correct=line["correct"], checks=line["checks"],
                metrics={k: m["value"] for k, m in line["metrics"].items()},
                setup=line["info"]["setup"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", nargs="+", default=["float32"],
                    choices=("float32", "none") + FAULTS)
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    if set(args.control) - {"float32"}:
        from portbench import run
        bench = harness.load_bench()
        cell = next(w for w in bench["workloads"]
                    if w["name"] == args.workload)
        run.setup_env(harness.load_config(cell["config"]).get("host", {}))
    for control in args.control:
        for seed in args.seeds:
            res = (control_run(args.workload, seed, args.requests)
                   if control == "float32" else
                   fault_run(args.workload, seed, args.seconds, control))
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
