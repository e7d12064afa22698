"""The port's model under autograd against the reference, on the CPU.

Every arch's SMOKE config in float32; the reference's ``Model.init(seed=0)``
parameters (the VLM's gates set non-zero on both sides,
``_model_reference.gated``: at zero its cross sublayer's matrices would get
exactly zero gradient and the test would hold nothing) carried across with
``repro_torch.models.convert``, and the same seeded numpy batch, some
labels -1, through both packages:

* ``Model.loss`` against the reference's ``model.loss`` within
  ``F32_ATOL``, also under a ``logit_chunk`` override (the chunked loss);
* every gradient leaf of autograd against ``jax.grad`` of the reference's
  loss (unstacked by ``from_reference``) within ``grad_tolerance``,
  relative to the leaf's largest gradient (``tests/_model_cases.py``
  states the rule);
* the remat policies "none", "full" and "dots" give the same loss and
  gradients bit for bit, one arch a block pattern (and the VLM's groups);
* one ``make_train_step`` step against the reference's (params,
  ``OptState``, metrics), ``grad_accum=2`` against the reference's
  ``grad_accum=2`` and against the port's own single-shot step;
* ``train()``: 8 float32 steps from the reference's parameters against the
  reference's ``train()``, loss by loss within ``F32_ATOL``; an injected
  preemption at step 6 and a resume from the step-4 checkpoint give params
  and optimizer state equal bit for bit to the uninterrupted run;
  ``train()`` refuses the models the token pipeline cannot feed.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as ref_make_train_step
from repro.launch.train import train as ref_train
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import convert
from repro_torch.models import layers as ll
from repro_torch.models import transformer
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.tree import flatten, leaves

from _model_cases import (F32_ATOL, first_step_error, grad_error,
                          grad_tolerance)
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)
from _model_reference import gated, ref_model

B, S = 2, 16
F32 = (("dtype", "float32"),)
CHUNKED = F32 + (("logit_chunk", 4),)
# one arch a block pattern, and the VLM's groups
REMAT_ARCHS = ["smollm-360m", "rwkv6-3b", "zamba2-2.7b",
               "llama-3.2-vision-11b"]
CASES = [(a, F32) for a in ARCH_IDS] + [("smollm-360m", CHUNKED)]


@pytest.fixture(autouse=True)
def one_thread():
    """SMOKE widths: one intra-op thread runs them as fast as many, and
    leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def batch_for(cfg, seed=0, masked=True):
    """A seeded numpy batch of (B, S), as ``tests/test_models.py``'s
    ``_batch_for`` draws it: labels, tokens or (audio) embeddings, and
    (VLM) patches; with ``masked``, a few labels -1."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.embedding_inputs:
        batch["embeds"] = (rng.normal(size=(B, S, cfg.d_model))
                           * 0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.cross_attn_every:
        batch["patches"] = (rng.normal(size=(B, cfg.num_patches, cfg.d_model))
                            * 0.02).astype(np.float32)
    if masked:
        batch["labels"][0, :3] = -1
        batch["labels"][1, -2:] = -1
    return batch


def port_model(arch, replace=F32, params=None):
    cfg = get_config(arch, smoke=True).replace(**dict(replace))
    return Model(cfg, device="cpu", params=gated(arch)[1] if params is None
                 else params, trainable=True)


def ref_tree(tree, cfg):
    """A reference tree (params or gradients) as the port's, numpy."""
    return {k: v.numpy() for k, v in flatten(convert.from_reference(
        jax.tree.map(np.asarray, tree), cfg.num_layers))}


@functools.lru_cache(maxsize=None)
def reference(arch, replace):
    """The reference's (loss, metrics, gradients as the port's flat
    tree) of ``batch_for`` under the gated parameters."""
    rcfg, rmodel = ref_model(arch, replace)
    jb = {k: jnp.asarray(v) for k, v in batch_for(rcfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(gated(arch)[0], jb)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            ref_tree(grads, rcfg))


def port_loss_and_grads(model, batch):
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves(model.params()))
    names = [k for k, _ in flatten(model.params())]
    return loss, metrics, dict(zip(names, grads))


@pytest.mark.parametrize("arch,replace", CASES,
                         ids=[a + ("-chunked" if r == CHUNKED else "")
                              for a, r in CASES])
def test_loss_matches_reference(arch, replace):
    model = port_model(arch, replace)
    with torch.no_grad():
        loss, metrics = model.loss(batch_for(model.cfg))
    want, want_metrics, _ = reference(arch, replace)
    assert abs(float(loss) - want) <= F32_ATOL, (float(loss), want)
    for k in ("ce", "aux"):
        assert abs(float(metrics[k]) - want_metrics[k]) <= F32_ATOL, k
    assert float(metrics["tokens"]) == want_metrics["tokens"] == B * S - 5


@pytest.mark.parametrize("arch,replace", CASES,
                         ids=[a + ("-chunked" if r == CHUNKED else "")
                              for a, r in CASES])
def test_gradients_match_reference(arch, replace):
    model = port_model(arch, replace)
    _, _, grads = port_loss_and_grads(model, batch_for(model.cfg))
    _, _, want = reference(arch, replace)
    assert sorted(grads) == sorted(want)
    tol = grad_tolerance(model.cfg.num_layers)
    errors = {k: grad_error(g.numpy(), want[k]) for k, g in grads.items()}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= tol, (worst, errors[worst], tol)
    if model.cross:
        # the gates are set: the cross sublayer's matrices learn
        assert float(grads["cross/0/cross/wk"].abs().max()) > 0


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_agree_bit_for_bit(arch, monkeypatch):
    """At the SMOKE config's own dtype (bfloat16 at every use): "full" and
    "dots" recompute, "none" keeps; the numbers do not move. "full" saves
    fewer tensors for the backward than "none", and "dots" keeps products
    with no batch dimensions."""
    kept = []

    def save_dots(ctx, op, *args, **kwargs):
        policy = save_dots.orig(ctx, op, *args, **kwargs)
        kept.append(policy.name)
        return policy

    save_dots.orig = transformer._save_dots
    monkeypatch.setattr(transformer, "_save_dots", save_dots)
    cfg = get_config(arch, smoke=True)
    batch = batch_for(cfg)
    out, saved = {}, {}
    for policy in ("none", "full", "dots"):
        model = port_model(arch, (("remat", policy),), gated(arch)[1])
        count = []

        def pack(t):
            count.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves(model.params()))
        out[policy], saved[policy] = (loss, grads), sum(count)
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for a, b in zip(out[policy][1], out["none"][1]):
            assert torch.equal(a, b), policy
    assert saved["full"] < saved["none"], saved
    assert "MUST_SAVE" in kept and "PREFER_RECOMPUTE" in kept


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_matches_reference_past_exp_overflow(dtype):
    """``silu``'s gradient is ``lax.logistic``'s, finite where exp(-x)
    overflows (x < -88): autograd of 1 / (1 + exp(-x)) gives 0 * inf
    there."""
    x = np.array([-200.0, -100.0, -89.0, -10.0, -0.5, 0.0, 0.5, 3.0, 100.0],
                 np.float32)
    want = np.asarray(jax.grad(lambda v: jax.nn.silu(v).sum())(
        jnp.asarray(x, dtype)), np.float32)
    t = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    ll.silu(t).sum().backward()
    got = t.grad.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def check_step(port_params, port_opt, ref_params, ref_opt, old, cfg, lr):
    """The port's params and ``OptState`` after a step against the
    reference's: the moments are linear in the gradient (mu) and its
    square (nu), so within ``grad_tolerance`` of each leaf's largest (twice
    it for nu); the params within ``first_step_error``'s bound."""
    tol = grad_tolerance(cfg.num_layers)
    assert int(port_opt.step) == int(ref_opt.step) == 1
    mu, nu = ref_tree(ref_opt.mu, cfg), ref_tree(ref_opt.nu, cfg)
    for k, m in flatten(port_opt.mu):
        assert grad_error(m.numpy(), mu[k]) <= tol, k
    for k, v in flatten(port_opt.nu):
        assert grad_error(v.numpy(), nu[k]) <= 2 * tol, k
    want = ref_tree(ref_params, cfg)
    for k, p in flatten(port_params):
        # mu = (1 - b1) g at step 1
        err = first_step_error(p.detach().numpy(), want[k], old[k],
                               mu[k] / 0.1, lr, tol)
        assert err <= 1.0, (k, err)


def test_train_step_matches_reference():
    arch = "smollm-360m"
    rcfg, rmodel = ref_model(arch, F32)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = batch_for(rcfg)
    ref_params, ref_opt, ref_m = jax.jit(ref_make_train_step(
        rmodel, ref_adamw.AdamWConfig(**ocfg)))(
        gated(arch)[0], ref_adamw.init(gated(arch)[0],
                                       ref_adamw.AdamWConfig(**ocfg)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(arch)
    old = {k: p.detach().clone().numpy() for k, p in flatten(model.params())}
    opt_cfg = adamw.AdamWConfig(**ocfg)
    state, m = make_train_step(model, opt_cfg)(
        adamw.init(model.params(), opt_cfg), batch)
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert abs(float(m[k]) - float(ref_m[k])) <= F32_ATOL * max(
            1.0, abs(float(ref_m[k]))), k
    assert float(m["lr"]) == float(ref_m["lr"])
    assert float(m["tokens"]) == float(ref_m["tokens"])
    check_step(model.params(), state, ref_params, ref_opt, old, rcfg,
               float(ref_m["lr"]))


def test_grad_accum_matches_reference_and_single_shot():
    """``grad_accum=2`` against the reference's ``grad_accum=2``, and
    against the port's single-shot step, unmasked labels (equal token
    counts in the microbatches): the loss within rtol 1e-5, the params
    within rtol and atol 2e-5 (``tests/test_compressed.py``'s property)."""
    arch = "smollm-360m"
    rcfg, rmodel = ref_model(arch, F32)
    ocfg = dict(lr=1e-3, total_steps=10)
    batch = batch_for(rcfg, seed=1, masked=False)
    ref_params, ref_opt, ref_m = jax.jit(ref_make_train_step(
        rmodel, ref_adamw.AdamWConfig(**ocfg), grad_accum=2))(
        gated(arch)[0], ref_adamw.init(gated(arch)[0],
                                       ref_adamw.AdamWConfig(**ocfg)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    opt_cfg = adamw.AdamWConfig(**ocfg)
    got = {}
    for accum in (1, 2):
        model = port_model(arch)
        old = {k: p.detach().clone().numpy()
               for k, p in flatten(model.params())}
        state, m = make_train_step(model, opt_cfg, grad_accum=accum)(
            adamw.init(model.params(), opt_cfg), batch)
        got[accum] = (model.params(), m)
        if accum == 2:
            assert sorted(m) == ["grad_norm", "loss", "lr"]
            assert abs(float(m["loss"]) - float(ref_m["loss"])) <= F32_ATOL
            check_step(model.params(), state, ref_params, ref_opt, old, rcfg,
                       float(ref_m["lr"]))
    np.testing.assert_allclose(float(got[2][1]["loss"]),
                               float(got[1][1]["loss"]), rtol=1e-5)
    for a, b in zip(leaves(got[1][0]), leaves(got[2][0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=2e-5)


TRAIN = dict(arch="smollm-360m", smoke=True, steps=8, batch=2, seq=16,
             lr=1e-3, ckpt_every=4, seed=5, quiet=True,
             config_overrides={"dtype": "float32"})


@functools.lru_cache(maxsize=None)
def reference_start():
    """The reference's ``Model.init(seed=5)`` of the trainer's config, as
    the port's tree."""
    from repro.models.transformer import Model as RefModel
    rcfg, _ = ref_model("smollm-360m", F32)
    return convert.from_reference(
        jax.tree.map(np.asarray, RefModel(rcfg).init(seed=TRAIN["seed"])),
        rcfg.num_layers)


def test_trainer_loss_curve_matches_reference():
    """8 steps in float32 (the warmup of 5 steps, then cosine) from the
    same parameters and the same batches: every step's loss within
    ``F32_ATOL`` of the reference's."""
    want = ref_train(**TRAIN)["losses"]
    got = train(device="cpu", params=reference_start(), **TRAIN)
    assert got["steps_run"] == 8
    assert all(np.isfinite(got["grad_norms"]))
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=F32_ATOL)


def test_trainer_restart_is_exact(tmp_path):
    """Kill training at step 6 (injected preemption), restart from the
    step-4 checkpoint: params and optimizer state equal bit for bit to an
    uninterrupted run (``tests/test_substrates.py``'s property)."""
    kw = dict(TRAIN, device="cpu", params=reference_start())
    ref = train(**kw)
    ckpt_dir = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="preemption"):
        train(ckpt_dir=ckpt_dir, die_at_step=6, **kw)
    out = train(ckpt_dir=ckpt_dir, **kw)
    assert out["steps_run"] == 4
    assert out["checkpoints"][0]["op"] == "restore"
    assert out["checkpoints"][0]["step"] == 4
    for tree in ("params", "opt_state"):
        for a, b in zip(leaves(ref[tree]), leaves(out[tree])):
            assert torch.equal(a, b), tree
    assert out["losses"] == ref["losses"][4:]


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b"])
def test_trainer_refuses_models_the_pipeline_cannot_feed(arch):
    with pytest.raises(ValueError, match="tokens only"):
        train(arch=arch, steps=1, device="cpu", quiet=True)


def test_prefill_and_serve_steps_match_reference():
    """``make_prefill_step`` (the last position's logits) and
    ``make_serve_step`` (one decode step's) against the reference's, float32
    within ``F32_ATOL``."""
    from repro.launch.steps import make_prefill_step as ref_prefill_step
    from repro.launch.steps import make_serve_step as ref_serve_step
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    arch = "smollm-360m"
    rcfg, rmodel = ref_model(arch, F32)
    tokens = batch_for(rcfg)["tokens"]
    model = Model(get_config(arch, smoke=True).replace(dtype="float32"),
                  device="cpu", params=gated(arch)[1])
    got = make_prefill_step(model)({"tokens": tokens})
    want = ref_prefill_step(rmodel)(gated(arch)[0],
                                    {"tokens": jnp.asarray(tokens)})
    assert tuple(got.shape) == (B, rcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    cache = model.init_cache(B, S)
    rcache, _ = rmodel.init_cache(B, S)
    for t in range(3):
        step = {"tokens": tokens[:, t:t + 1]}
        got, cache = make_serve_step(model)(cache, step, t)
        want, rcache = ref_serve_step(rmodel)(
            gated(arch)[0], rcache, {"tokens": jnp.asarray(step["tokens"])},
            t)
        assert tuple(got.shape) == (B, rcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_ATOL)
