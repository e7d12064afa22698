#!/usr/bin/env python3
"""Time the ``sgs_decode`` kernel of two checkouts on one card, in turns.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 tools/decode_ab.py OTHER_CHECKOUT [--rounds 2]

Each round runs OTHER, this checkout, this checkout, OTHER, each in a
fresh process that builds that checkout's kernel into its own
``build/repro_torch/`` and prints the device milliseconds a launch at
three shapes, on inputs drawn from seed 7 by that checkout's
``tests/_decode_cases.py``: the isolated engine's decode (16 groups of 256
rows, J 14), the shared engine's (256 rows, J 224) and a 128-tenant
pool's (256 rows, J 1792, ``wide_instance``). A launch is timed as
``chip_smoke.kernel_ms`` times it: queued behind a spin kernel, so the
events time the device and not the host. Prints one line a run, then the
median of each side, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np, torch
from _decode_cases import grouped_instance, wide_instance
from repro_torch.kernels import sgs_decode as kernel

def device_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 25)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    if a.query():
        sys.exit("the spin ended before the launches were queued")
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

dev = torch.device("cuda:0")
rng = np.random.default_rng(7)
shapes = {"isolated": (grouped_instance(rng, 16, 256, 14, 2, 256)[1], 50),
          "shared": (grouped_instance(rng, 1, 256, 224, 2, 256)[1], 20),
          "pool": (wide_instance(rng, 1, 256, 1792, 2, 256), 5)}
out = {}
for name, (args, reps) in shapes.items():
    args = [torch.from_numpy(a).to(dev) for a in args]
    out[name] = device_ms(lambda: kernel.sgs_decode(*args, T=256), reps)
print(json.dumps(out))
"""


def run(tree: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(tree, "src"), os.path.join(tree, "tests")])
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"decode_ab: {tree} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="root of the checkout to compare")
    parser.add_argument("--rounds", type=int, default=2)
    opts = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(opts.other)
    times = {other: [], here: []}
    for _ in range(opts.rounds):
        for tree in (other, here, here, other):
            t = run(tree)
            times[tree].append(t)
            side = "this" if tree == here else "other"
            print(side, json.dumps(t), flush=True)
    for tree, side in ((other, "other"), (here, "this")):
        med = {k: statistics.median(t[k] for t in times[tree])
               for k in times[tree][0]}
        print(f"median {side}: " + ", ".join(f"{k} {v:.5f} ms"
                                             for k, v in med.items()))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(gpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
