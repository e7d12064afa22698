"""The port's model-serving driver (``repro_torch.launch.serve_model``)
against the reference's (``repro.launch.serve_model``), on the CPU.

For each dense and MoE SMOKE config both packages serve the same batch
from the reference's ``Model.init(seed=0)`` weights (carried across with
``repro_torch.models.convert``): the prompts must be the same draw, and the
greedy tokens the same. Where a row's tokens part, the reference's logit of
its own pick and of the port's pick at that step must lie within the
bfloat16 tolerance of ``tests/_model_cases.py`` (a near-tie that the two
computations' rounding can flip); the test then compares up to that step
and says so in a warning. Any other parting fails. The MoE configs are
served in float32 too, where every token and every expert choice must be
the reference's, and so are the SSM configs (``rwkv6-3b``,
``zamba2-2.7b``) and the VLM and audio backbones
(``llama-3.2-vision-11b``, ``musicgen-large``): the same greedy tokens at
every step.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import importlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve_model import serve as ref_serve
from repro_torch.launch.serve_model import serve

from _model_cases import bf16_tolerance
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)
from _model_reference import (AUDIO, DENSE, MOE, SSM, VLM, port_params,
                              ref_model, ref_params, ref_step, routes,
                              same_routes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, PROMPT, GEN = 2, 8, 8


@pytest.fixture(autouse=True)
def one_thread():
    """SMOKE widths: one intra-op thread runs them as fast as many, and
    leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ref_replay(arch, prompt, toks):
    """The reference's logits (B, GEN, V) at each generation step of its
    serving loop, replayed on its own greedy tokens with the jitted step."""
    _, model = ref_model(arch)
    params = ref_params(arch)
    cache, _ = model.init_cache(B, PROMPT + GEN)
    step = ref_step(arch)
    seq = np.concatenate([prompt, toks], axis=1).astype(np.int32)
    out = []
    for t in range(PROMPT + GEN - 1):
        logits, cache = step(params, cache, {"tokens": jnp.asarray(
            seq[:, t:t + 1])}, t)
        if t >= PROMPT - 1:
            out.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_greedy_tokens_match_reference(arch):
    rcfg, _ = ref_model(arch)
    want = ref_serve(arch, smoke=True, batch=B, prompt_len=PROMPT,
                     gen_tokens=GEN, params=ref_params(arch),
                     quiet=True)["tokens"]
    got = serve(arch, smoke=True, batch=B, prompt_len=PROMPT, gen_tokens=GEN,
                params=port_params(arch), quiet=True, device="cpu")
    # the reference's own draw of its prompt, as its driver makes it
    prompt = np.random.default_rng(0).integers(0, rcfg.vocab_size,
                                               size=(B, PROMPT))
    np.testing.assert_array_equal(got["prompt"], prompt)
    assert got["tokens"].shape == want.shape == (B, GEN)
    logits = ref_replay(arch, prompt, want)
    # the replay on that prompt reproduces the reference's served tokens
    np.testing.assert_array_equal(logits.argmax(-1), want)
    parted = np.flatnonzero((got["tokens"] != want).any(axis=0))
    if not parted.size:
        return
    k = int(parted[0])
    tol = bf16_tolerance(rcfg.num_layers, logits[:, :k + 1])
    for b in np.flatnonzero(got["tokens"][:, k] != want[:, k]):
        gap = logits[b, k, want[b, k]] - logits[b, k, got["tokens"][b, k]]
        assert gap <= tol, (
            f"{arch}: row {b} parts at step {k}: the reference's logit of "
            f"its token {want[b, k]} is {gap!r} above that of the port's "
            f"{got['tokens'][b, k]}, beyond the bfloat16 tolerance {tol!r}")
    warnings.warn(f"{arch}: greedy tokens equal for steps 0-{k - 1}; at step "
                  f"{k} a near-tie within the bfloat16 tolerance {tol:.4g} "
                  f"parts them, compared up to there")


@pytest.mark.parametrize("arch", MOE)
def test_moe_greedy_tokens_match_reference_in_float32(arch, monkeypatch):
    """The MoE family served by both packages with their SMOKE configs in
    float32, where neither side's rounding can swap an expert: the same
    greedy tokens at every step, and the same experts for every token of
    every MoE layer of the run (prefill and decode)."""
    import repro.launch.serve_model as ref_serving
    import repro_torch.launch.serve_model as serving
    for module in (ref_serving, serving):
        monkeypatch.setattr(module, "get_config",
                            lambda a, smoke=False, get=module.get_config:
                            get(a, smoke).replace(dtype="float32"))
    rcfg, _ = ref_model(arch)
    with routes(rcfg.num_experts, rcfg.top_k) as (ref_seen, port_seen):
        want = ref_serve(arch, smoke=True, batch=B, prompt_len=PROMPT,
                         gen_tokens=GEN, params=ref_params(arch),
                         quiet=True)["tokens"]
        got = serve(arch, smoke=True, batch=B, prompt_len=PROMPT,
                    gen_tokens=GEN, params=port_params(arch), quiet=True,
                    device="cpu")["tokens"]
        jax.effects_barrier()
    np.testing.assert_array_equal(got, want)
    same_routes(ref_seen, port_seen)
    assert len(port_seen) == (PROMPT + GEN) * (rcfg.num_layers
                                               - rcfg.first_dense)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_greedy_tokens_match_reference_in_float32(arch, monkeypatch):
    """The SSM family served by both packages with their SMOKE configs in
    float32: the same greedy tokens at every step. The prefill is a
    repeated decode on both sides, so serving runs ``gla_step``."""
    import repro.launch.serve_model as ref_serving
    import repro_torch.launch.serve_model as serving
    for module in (ref_serving, serving):
        monkeypatch.setattr(module, "get_config",
                            lambda a, smoke=False, get=module.get_config:
                            get(a, smoke).replace(dtype="float32"))
    want = ref_serve(arch, smoke=True, batch=B, prompt_len=PROMPT,
                     gen_tokens=GEN, params=ref_params(arch),
                     quiet=True)["tokens"]
    got = serve(arch, smoke=True, batch=B, prompt_len=PROMPT,
                gen_tokens=GEN, params=port_params(arch), quiet=True,
                device="cpu")["tokens"]
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_multimodal_greedy_tokens_match_reference_in_float32(arch,
                                                             monkeypatch):
    """The VLM and audio backbones served by both packages with their SMOKE
    configs in float32: the same greedy tokens at every step. The VLM
    decodes against the zero patch cache on both sides (neither ``serve``
    supplies patches). The audio model's prompt is the reference's numpy
    draw of embeddings, and each generated token is fed as its row of the
    reference's frame table, ``jax.random.normal(PRNGKey(7), (V, d)) *
    0.02``, handed to the port through ``frames`` (torch cannot draw
    threefry's numbers)."""
    import repro.launch.serve_model as ref_serving
    import repro_torch.launch.serve_model as serving
    for module in (ref_serving, serving):
        monkeypatch.setattr(module, "get_config",
                            lambda a, smoke=False, get=module.get_config:
                            get(a, smoke).replace(dtype="float32"))
    rcfg, _ = ref_model(arch)
    frames = None
    if rcfg.embedding_inputs:
        frames = np.array(jax.random.normal(
            jax.random.PRNGKey(7), (rcfg.vocab_size, rcfg.d_model)) * 0.02)
    want = ref_serve(arch, smoke=True, batch=B, prompt_len=PROMPT,
                     gen_tokens=GEN, params=ref_params(arch),
                     quiet=True)["tokens"]
    got = serve(arch, smoke=True, batch=B, prompt_len=PROMPT,
                gen_tokens=GEN, params=port_params(arch), quiet=True,
                device="cpu", frames=frames)
    rng = np.random.default_rng(0)
    prompt = (rng.normal(size=(B, PROMPT, rcfg.d_model)).astype(np.float32)
              * 0.02 if rcfg.embedding_inputs else
              rng.integers(0, rcfg.vocab_size, size=(B, PROMPT)))
    np.testing.assert_array_equal(got["prompt"], prompt)
    assert got["tokens"].shape == (B, GEN)
    np.testing.assert_array_equal(got["tokens"], want)


def test_sampling_is_seeded():
    """At temperature > 0 the tokens come from a torch generator seeded with
    ``seed``: the same seed samples the same tokens."""
    a = serve("smollm-360m", batch=B, prompt_len=4, gen_tokens=6,
              temperature=1.0, seed=3, quiet=True, device="cpu")
    b = serve("smollm-360m", batch=B, prompt_len=4, gen_tokens=6,
              temperature=1.0, seed=3, quiet=True, device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 256


def test_serve_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert serve(batch=1, prompt_len=2, gen_tokens=2,
                     quiet=True)["tokens"].shape == (1, 2)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(batch=1, prompt_len=2, gen_tokens=2, quiet=True)


def test_cli_serves_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_model", "--device",
         "cpu", "--prompt-len", "4", "--tokens", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "smollm-360m: generated 4x4 tokens" in res.stdout


def test_cli_serves_the_moe_family_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for arch in MOE:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_model",
             "--arch", arch, "--device", "cpu", "--prompt-len", "4",
             "--tokens", "4"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert f"{arch}: generated 4x4 tokens" in res.stdout


@pytest.mark.parametrize("arch", SSM)
def test_cli_serves_the_ssm_family_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_model", "--arch",
         arch, "--device", "cpu", "--prompt-len", "4", "--tokens", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"{arch}: generated 4x4 tokens" in res.stdout


@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_cli_serves_the_multimodal_backbones_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_model", "--arch",
         arch, "--device", "cpu", "--prompt-len", "4", "--tokens", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"{arch}: generated 4x4 tokens" in res.stdout


def test_serve_shim_warns_and_reexports():
    import repro_torch.launch.serve as shim
    with pytest.warns(DeprecationWarning, match="serve_model"):
        importlib.reload(shim)
    assert shim.serve is serve
