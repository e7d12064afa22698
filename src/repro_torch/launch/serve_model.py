"""Batched serving driver (PyTorch port of ``repro.launch.serve_model``):
prefill a prompt batch, then decode with the explicit KV/state cache. Every
architecture of ``repro_torch.configs``: the dense and MoE families
(``olmoe-1b-7b``, and ``deepseek-v2-lite-16b`` with its compressed MLA
cache), the SSM family (``rwkv6-3b``'s shifts and wkv state,
``zamba2-2.7b``'s conv and SSM states beside its shared attention block's
KV cache: the prefill is a repeated decode, as the reference's, so serving
runs ``models/gla.py:gla_step``), the VLM backbone
(``llama-3.2-vision-11b``, served against its patch cache as
``init_cache`` leaves it, all zeros: the reference's ``serve`` supplies no
patches either, ``repro/launch/serve_model.py``) and the audio backbone
(``musicgen-large``, fed embeddings: the prompt frames drawn as the
reference draws them, each generated token fed as its row of a frame
table). Runs on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch smollm-360m --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch olmoe-1b-7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch rwkv6-3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch llama-3.2-vision-11b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch musicgen-large --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model


def frame_table(cfg, device) -> torch.Tensor:
    """The audio stub's frame embeddings, one row a codec token: (V, d)
    float32 normal draws x 0.02 from a torch generator seeded with 7 on
    ``device``. The reference draws ``jax.random.normal(PRNGKey(7), (V,
    d)) * 0.02``, which torch cannot reproduce: the same kind of draw,
    other numbers."""
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    return torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                       dtype=torch.float32, device=device) * 0.02


def serve(arch: str = "smollm-360m", smoke: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_tokens: int = 32, seed: int = 0,
          temperature: float = 0.0, params=None, quiet: bool = False,
          device="cuda", frames=None, mesh=None):
    """Serve one batch: ``prompt_len`` prefill steps of the prompt drawn from
    ``np.random.default_rng(seed)`` as the reference draws it (tokens, or
    for a model fed embeddings (batch, prompt_len, d) float32 normal draws
    x 0.02), then ``gen_tokens`` tokens, greedy, or sampled at
    ``temperature > 0`` from a torch generator seeded with ``seed``; a
    model fed embeddings is fed each generated token as its row of
    ``frames`` ((V, d) float32; ``frame_table`` unless given). ``params``:
    the parameter tree ``Model`` takes (``models/convert.from_reference``
    carries the reference's across); without it the weights are drawn
    from ``seed``. The VLM decodes against the zero patch cache of
    ``Model.init_cache``, as the reference's ``serve`` does. Returns
    {"tokens": (batch, gen_tokens) int array, "seconds": wall time of
    prefill and decode, "prompt": the prompt fed, (batch, prompt_len) int
    or (batch, prompt_len, d) float32 array}.

    ``mesh`` (a ``launch/mesh.py:DeviceMesh`` on ("data", "model"), and
    "pod" where present): the model runs sharded over it, on the device
    of its first entry (``device`` is then not read). The reference
    defaults to ``make_mesh_for(len(jax.devices()), 1)``; the port keeps
    None, one device, which is that default on one card."""
    dev = resolve_device(device if mesh is None else
                         mesh.devices.flat[0])
    cfg = get_config(arch, smoke=smoke)
    model = Model(cfg, seed=seed, device=dev, params=params, mesh=mesh)
    S_max = prompt_len + gen_tokens
    cache = model.init_cache(batch, S_max)

    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        drawn = rng.normal(size=(batch, prompt_len, cfg.d_model)).astype(
            np.float32) * 0.02
        prompt = torch.as_tensor(drawn, device=dev)
        table = (frame_table(cfg, dev) if frames is None else
                 torch.as_tensor(frames, dtype=torch.float32, device=dev))

        def feed(t):
            return {"embeds": prompt[:, t:t + 1]}

        def feed_token(nxt):
            return {"embeds": table[nxt][:, None]}
    else:
        drawn = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
        prompt = torch.as_tensor(drawn, dtype=torch.int32, device=dev)

        def feed(t):
            return {"tokens": prompt[:, t:t + 1]}

        def feed_token(nxt):
            return {"tokens": nxt[:, None].to(torch.int32)}

    # prefill via repeated decode, as the reference does
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    logits = None
    for t in range(prompt_len):
        logits, cache = model.decode_step(cache, feed(t), t)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out_tokens = []
    for t in range(prompt_len, S_max):
        if temperature > 0:
            probs = torch.softmax(logits[:, 0].float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(logits[:, 0], dim=-1)
        out_tokens.append(nxt.cpu().numpy())
        logits, cache = model.decode_step(cache, feed_token(nxt), t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    toks = np.stack(out_tokens, 1)
    if not quiet:
        print(f"{arch}: generated {batch}x{gen_tokens} tokens in {dt:.2f}s "
              f"({batch * (S_max) / dt:.1f} tok/s incl. prefill)")
        print("sample:", toks[0][:16])
    return {"tokens": toks, "seconds": dt, "prompt": drawn}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    serve(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen_tokens=args.tokens, temperature=args.temperature,
          device=args.device)


if __name__ == "__main__":
    main()
