"""Plan quality of the port against the reference, on the CPU.

The port solves the small fixture's cells (``tests/_quality.py``: the
isolated and shared vectorized cells on 4 DAGs at ``VecConfig(chains=16,
iters=60, grid=128)``, solver seeds 0-7) on its production draws, a torch
generator, and is held to the rule against the reference's energies in
``tests/torch_golden/quality_small.json`` (written by
``tests/_quality_reference.py``; tier-1 never regenerates them): every
plan valid, and the port's mean energy over the seeds at most the
reference's mean plus two standard errors of the reference's seed spread.
"""
import importlib
import json
import os

import pytest
import torch

import _quality as q

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_golden", "quality_small.json")


@pytest.fixture
def one_thread():
    """The sweep's tensors are small: one intra-op thread runs it about ten
    times faster than a thread per core beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", sorted(q.SCALES["small"]["seeds"]))
def test_port_quality_holds_the_rule_at_the_small_fixture(cell, one_thread):
    with open(GOLDEN) as f:
        ref = json.load(f)["cells"][cell]
    api = q.modules({m: importlib.import_module(f"repro_torch.{m}")
                     for m in q.MODULES}, device=torch.device("cpu"))
    means, errors = q.sweep(api, cell, "small",
                            seeds=sorted(int(s) for s in ref["seeds"]))
    assert errors == []
    assert all(n == ref["plans_per_seed"] for _, n in means.values())
    holds, mean, bound = q.check({s: m for s, (m, _) in means.items()},
                                 {int(s): m for s, m in ref["seeds"].items()})
    assert holds, (f"{cell}: the port's mean energy {mean!r} over seeds "
                   f"{sorted(means)} is above the reference's bound "
                   f"{bound!r}; per seed {means}")
