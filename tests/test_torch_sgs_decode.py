"""The port's serial-SGS decode against the JAX reference: BIT-FOR-BIT.

``repro_torch.kernels.ref.sgs_decode_ref`` (plain PyTorch, what runs on
the CPU) must equal ``repro.kernels.ref.sgs_decode_ref`` exactly — never
allclose — on random instances (zero-duration slots, zero-demand tasks,
the -1e9 masked-slot priority, ties), on the edge cases, on a property
sweep, and in the grouped (G > 1) form the isolated engine launches. The
CUDA kernel is held to the same plain version on the card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:              # hermetic env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from _decode_cases import SHAPES, edge_cases, grouped_instance, random_instance
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _assert_exact(args, T):
    want = jref.sgs_decode_ref(*[jnp.asarray(a) for a in args], T=T)
    got = tref.sgs_decode_ref(*[torch.from_numpy(a) for a in args], T=T)
    for name, a, b in zip(("start", "finish", "ok"), want, got):
        assert b.dtype == (torch.bool if name == "ok" else torch.int32)
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_ref_matches_jax_exactly():
    rng = np.random.default_rng(7)
    for B, J, M, T in SHAPES:
        _assert_exact(random_instance(rng, B, J, M, T), T)


@pytest.mark.parametrize("case", range(3), ids=["masked", "ties", "late"])
def test_ref_edge_cases(case):
    args, T = edge_cases()[case]
    _assert_exact(args, T)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16), B=st.integers(1, 5), J=st.integers(1, 30),
       M=st.integers(1, 4), T=st.sampled_from([32, 100, 128, 200]))
def test_ref_property(seed, B, J, M, T):
    rng = np.random.default_rng(seed)
    _assert_exact(random_instance(rng, B, J, M, T), T)


@pytest.mark.parametrize("G,rows,J,M,T", [(3, 4, 9, 2, 64), (5, 2, 16, 3, 128)])
def test_grouped_ref_matches_per_group_jax(G, rows, J, M, T):
    """Row b reads group b // rows: one grouped call == G JAX calls."""
    rng = np.random.default_rng(G * 100 + J)
    insts, args = grouped_instance(rng, G, rows, J, M, T)
    got = tref.sgs_decode_ref(*[torch.from_numpy(a) for a in args], T=T)
    for g, inst in enumerate(insts):
        want = jref.sgs_decode_ref(*[jnp.asarray(a) for a in inst], T=T)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(
                np.asarray(a), b[g * rows:(g + 1) * rows].numpy())


def test_ops_dispatch_on_cpu():
    """Auto and False take the plain version on CPU tensors; True raises
    there (no fallback)."""
    args = [torch.from_numpy(a)
            for a in random_instance(np.random.default_rng(3), 2, 5, 2, 32)]
    auto = tops.sgs_decode(*args, T=32)
    plain = tops.sgs_decode(*args, T=32, use_kernel=False)
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        tops.sgs_decode(*args, T=32, use_kernel=True)
