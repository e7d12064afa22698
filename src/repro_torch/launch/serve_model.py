"""Batched serving driver (PyTorch port of ``repro.launch.serve_model``):
prefill a prompt batch, then decode with the explicit KV/state cache. The
dense and MoE families (``olmoe-1b-7b``, and ``deepseek-v2-lite-16b`` with
its compressed MLA cache) and the SSM family (``rwkv6-3b``'s shifts and
wkv state, ``zamba2-2.7b``'s conv and SSM states beside its shared
attention block's KV cache: the prefill is a repeated decode, as the
reference's, so serving runs ``models/gla.py:gla_step``);
``models/transformer.py`` names the ROADMAP item the VLM and audio models
wait for. Runs on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch smollm-360m --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch olmoe-1b-7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_model --arch rwkv6-3b --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model


def serve(arch: str = "smollm-360m", smoke: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_tokens: int = 32, seed: int = 0,
          temperature: float = 0.0, params=None, quiet: bool = False,
          device="cuda"):
    """Serve one batch: ``prompt_len`` prefill steps of the prompt drawn from
    ``np.random.default_rng(seed)`` as the reference draws it, then
    ``gen_tokens`` tokens, greedy, or sampled at ``temperature > 0`` from a
    torch generator seeded with ``seed``. ``params``: the parameter tree
    ``Model`` takes (``models/convert.from_reference`` carries the
    reference's across); without it the weights are drawn from ``seed``.
    Returns {"tokens": (batch, gen_tokens) int array, "seconds": wall time
    of prefill and decode, "prompt": (batch, prompt_len) int array}."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = Model(cfg, seed=seed, device=dev, params=params)
    S_max = prompt_len + gen_tokens
    cache = model.init_cache(batch, S_max)

    rng = np.random.default_rng(seed)
    drawn = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    prompt = torch.as_tensor(drawn, dtype=torch.int32, device=dev)

    # prefill via repeated decode, as the reference does
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    logits = None
    for t in range(prompt_len):
        logits, cache = model.decode_step(cache, {"tokens": prompt[:, t:t + 1]},
                                          t)
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
        logits, cache = model.decode_step(
            cache, {"tokens": nxt[:, None].to(torch.int32)}, t)
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
