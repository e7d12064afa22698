"""The train, prefill and serve steps (PyTorch port of
``repro/launch/steps.py``).

The reference's steps are pure functions of (params, state, batch) that it
jits; here the model owns its parameters, so a train step takes the
optimizer state and a batch, updates the model's parameters in place and
returns the new state. The dry run's pieces (``abstract_opt_state``,
``sharding_of``, ``StepBundle``) wait for the model meshes.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.tree import leaves, map_tree


def _on(model: Model, batch):
    return {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    grad_accum: int = 1):
    """``train_step(opt_state, batch) -> (opt_state, metrics)`` for a model
    built with ``trainable=True``: the loss's gradient with respect to
    every parameter (autograd), then ``adamw.update``. ``grad_accum > 1``
    splits the batch into that many microbatches and sums each one's
    gradient divided by ``grad_accum`` in float32, and its loss so; the
    single-shot step's when the microbatches hold equal numbers of
    unmasked labels. The metrics (device tensors) are ``loss``,
    ``grad_norm`` (before clipping) and ``lr``, and with ``grad_accum ==
    1`` also the loss's ``ce``, ``aux`` and ``tokens``."""
    if not model.trainable:
        raise ValueError("make_train_step needs a model built with "
                         "trainable=True")
    params = model.params()
    weights = leaves(params)

    def train_step(opt_state, batch):
        batch = _on(model, batch)
        if grad_accum == 1:
            loss, metrics = model.loss(batch)
            grads = torch.autograd.grad(loss, weights)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % grad_accum:
                raise ValueError(f"a batch of {B} does not split into "
                                 f"{grad_accum} microbatches")
            micro = {k: v.reshape(grad_accum, B // grad_accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros(w.shape, dtype=torch.float32,
                                 device=w.device) for w in weights]
            loss = torch.zeros((), device=model.device)
            for i in range(grad_accum):
                l, _ = model.loss({k: v[i] for k, v in micro.items()})
                g = torch.autograd.grad(l, weights)
                grads = [a + b.float() / grad_accum
                         for a, b in zip(grads, g)]
                loss = loss + l.detach() / grad_accum
            metrics = {}
        it = iter(grads)
        _, opt_state, opt_metrics = adamw.update(
            params, map_tree(lambda _: next(it), params), opt_state, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, loss=loss.detach(), **opt_metrics)
    return train_step


def make_prefill_step(model: Model):
    """``prefill_step(batch)``: the next-token logits (B, V) of the batch's
    last position."""
    def prefill_step(batch):
        logits, _aux = model(batch)
        return logits[:, -1]
    return prefill_step


def make_serve_step(model: Model):
    """``serve_step(cache, batch, cache_index) -> (logits (B, V), cache)``:
    one decode step, the cache written in place."""
    def serve_step(cache, batch, cache_index):
        logits, cache = model.decode_step(cache, batch, cache_index)
        return logits[:, 0], cache
    return serve_step
