"""The port's CUDA kernel on the card (marked ``cuda``; each test skips
where ``torch.cuda.is_available()`` is false). Imports no jax, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernel must equal its plain PyTorch version bit-for-bit, and a solve
must return the same plans whichever of the two decodes it runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _decode_cases import kernel_cases
from repro_torch.cluster.catalog import alibaba_cluster
from repro_torch.cluster.workloads import synth_trace
from repro_torch.core import dag as tdag
from repro_torch.core import vectorized as vec
from repro_torch.core.objectives import Goal
from repro_torch.kernels import ops
from repro_torch.kernels import sgs_decode as kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_kernel_matches_plain_exactly(card):
    for args, T in kernel_cases():
        dev = [torch.from_numpy(a).to(card) for a in args]
        n = kernel.sgs_decode.launches
        got = ops.sgs_decode(*dev, T=T)
        assert kernel.sgs_decode.launches == n + 1
        want = ops.sgs_decode(*dev, T=T, use_kernel=False)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_solve_same_plans_either_decode(card, shared):
    cluster = alibaba_cluster(machines=20)
    dags = synth_trace(3, cluster, seed=11)
    for d in dags:
        d.release_time = 0.0
    probs = [tdag.flatten([d], cluster.num_resources) for d in dags]
    cfg = vec.VecConfig(chains=8, iters=40, grid=128, seed=0)
    tape = vec.draw_tape(tdag.pack_problems(probs, cluster.num_resources,
                                            bucket_p=4), cfg, card)
    solve = (vec.vectorized_anneal_shared if shared
             else vec.vectorized_anneal_many)
    plans = []
    for use_kernel in (True, False):
        out = solve(probs, cluster, Goal.balanced(),
                    dataclasses.replace(cfg, use_kernel=use_kernel),
                    bucket_p=4, device=card, tape=tape)
        plans.append(out[0] if shared else out)
    for x, y in zip(*plans):
        np.testing.assert_array_equal(x.option_idx, y.option_idx)
        np.testing.assert_array_equal(x.start, y.start)
        np.testing.assert_array_equal(x.finish, y.finish)
        assert x.energy == y.energy
