"""Plan quality of the port against the reference, on the CPU.

The port solves the small fixture's cells (``tests/_quality.py``: the
isolated and shared vectorized cells on 4 DAGs at ``VecConfig(chains=16,
iters=60, grid=128)``, solver seeds 0-63) on its production draws, a torch
generator, and is held to the two-sample rule against the reference's
energies in ``tests/torch_golden/quality_small.json`` (written by
``tests/_quality_reference.py``; tier-1 never regenerates them): every
plan valid, and the port's mean energy over the seeds at most the
reference's mean plus two standard errors of the difference of the two
means. The port's spread counts as the reference's does: over 256 seeds
of the isolated cell the two means differ by 0.38 standard errors.
"""
import importlib
import json
import os

import numpy as np
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
    holds, gap, tol = q.check_two_sample(
        {s: m for s, (m, _) in means.items()},
        {int(s): m for s, m in ref["seeds"].items()})
    assert holds, (f"{cell}: the port's mean energy over seeds "
                   f"{sorted(means)} is {gap!r} above the reference's, more "
                   f"than two standard errors of the difference {tol!r}; "
                   f"per seed {means}")


def test_two_sample_rule_counts_both_spreads():
    """The CPU rule's bound is two standard errors of the difference of the
    two means: sqrt(var_port / n + var_ref / n), sample variances."""
    port = {0: -0.30, 1: -0.26, 2: -0.28, 3: -0.27}
    ref = {0: -0.29, 1: -0.28, 2: -0.27, 3: -0.30}
    holds, gap, tol = q.check_two_sample(port, ref)
    se2 = (np.var(list(port.values()), ddof=1)
           + np.var(list(ref.values()), ddof=1)) / 4
    assert gap == pytest.approx(0.0075, abs=1e-12)
    assert tol == pytest.approx(2 * np.sqrt(se2), rel=1e-12) and holds
    assert not q.check_two_sample({s: m + 0.1 for s, m in port.items()},
                                  ref)[0]
    with pytest.raises(ValueError, match="seeds"):
        q.check_two_sample({0: -0.3}, ref)
