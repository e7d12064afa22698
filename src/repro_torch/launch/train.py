"""End-to-end training (PyTorch port of ``repro/launch/train.py``).

Trains on the card unless asked for the CPU (``device="cpu"``,
``--device cpu``). Checkpoint and restart with exact resume (parameters,
optimizer state, the data pipeline's step), background saves, and an
injected preemption for the fault-tolerance tests. On the card the steps
run with ``torch.use_deterministic_algorithms``: the gathers' backward (the
embedding's, the MoE combine's) would otherwise add with atomics in an
order that changes from run to run, and a resumed run would part from an
uninterrupted one in the last bits.

The data pipeline yields tokens only, as the reference's does, so the
models fed embeddings (``musicgen-large``) or patches besides tokens (the
VLM) cannot take ``train``: it raises ``ValueError`` for them. Both take
``make_train_step`` with batches of their own.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --device cpu --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  python -m repro_torch.launch.train --arch smollm-360m --full --seq 2048
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import param_count
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.tree import leaves


@contextlib.contextmanager
def deterministic(device: torch.device):
    """On the card, ``torch.use_deterministic_algorithms(True)`` while the
    block runs (the caller's setting restored after): the same inputs give
    the same bits in every run. torch asks for ``CUBLAS_WORKSPACE_CONFIG``
    in that mode; on the one stream the steps use, cuBLAS's results do not
    depend on it. Elsewhere nothing changes."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def train(arch: str = "smollm-360m", smoke: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 128, lr: float = 1e-3,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          resume: bool = True, seed: int = 0, device=None,
          log_every: int = 10, die_at_step: Optional[int] = None,
          config_overrides: Optional[dict] = None, quiet: bool = False,
          params=None, mesh=None):
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens from the seeded
    synthetic corpus, AdamW at ``lr`` (warmup ``max(steps // 20, 5)``,
    cosine to ``steps``). The weights are drawn from ``seed`` on
    ``device``, or copied from ``params`` (the tree ``Model`` takes; the
    tests pass the reference's, carried across). With ``ckpt_dir`` it
    resumes from the latest checkpoint there (``resume``), saves in the
    background every ``ckpt_every`` steps and once more, blocking, at the
    end. ``die_at_step`` raises ``RuntimeError`` before that step, once a
    save in flight has landed. Returns {"final_loss", "losses",
    "grad_norms" (before clipping), "steps_run", "params" (the model's
    tree), "opt_state", "checkpoints" (the ``Checkpointer.log``, empty
    without ``ckpt_dir``)}.

    ``mesh`` (a ``launch/mesh.py:DeviceMesh`` on ("data", "model"), and
    "pod" where present): the model runs sharded over it, on the device
    of its first entry (``device`` is then not read), and the step
    differentiates the sharded loss. The reference defaults to
    ``make_mesh_for(len(jax.devices()), 1)``; the port keeps None, one
    device, which is that default on one card."""
    dev = resolve_device(device if mesh is None else mesh.devices.flat[0])
    cfg = get_config(arch, smoke=smoke)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    if cfg.embedding_inputs or cfg.cross_attn_every:
        raise ValueError(
            f"{arch}: the token pipeline yields tokens only, and this model "
            f"is fed {'embeddings' if cfg.embedding_inputs else 'patches'}; "
            f"train it through launch.steps.make_train_step")
    model = Model(cfg, seed=seed, device=dev, params=params, trainable=True,
                  mesh=mesh)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                                total_steps=steps)
    step_fn = make_train_step(model, opt_cfg)

    weights = model.params()
    opt_state = adamw.init(weights, opt_cfg)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=seed)).start()
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    losses, grad_norms = [], []
    try:
        start_step = 0
        if ckpt and resume and ckpt.latest_step() is not None:
            start_step, trees, extra = ckpt.restore(
                {"params": weights, "opt": opt_state})
            with torch.no_grad():
                for w, r in zip(leaves(weights), leaves(trees["params"])):
                    w.copy_(r)
            opt_state = trees["opt"]
            data.load_state_dict(extra["data"])
            if not quiet:
                print(f"resumed from step {start_step}")

        if not quiet:
            print(f"{arch}: {param_count(weights) / 1e6:.1f}M params, "
                  f"{batch}x{seq} tokens/step on {dev}")
        t0 = time.monotonic()
        with deterministic(dev):
            for s in range(start_step, steps):
                if die_at_step is not None and s == die_at_step:
                    raise RuntimeError(f"injected preemption at step {s}")
                opt_state, metrics = step_fn(opt_state, next(data))
                losses.append(float(metrics["loss"]))
                grad_norms.append(float(metrics["grad_norm"]))
                if not quiet and (s % log_every == 0 or s == steps - 1):
                    print(f"step {s:5d}  loss {losses[-1]:.4f}  "
                          f"gnorm {grad_norms[-1]:.3f}  "
                          f"lr {float(metrics['lr']):.2e}  "
                          f"({time.monotonic() - t0:.1f}s)")
                if ckpt and (s + 1) % ckpt_every == 0:
                    ckpt.save(s + 1, {"params": weights, "opt": opt_state},
                              extra={"data": data.state_dict()},
                              blocking=False)
        if ckpt:
            ckpt.wait()
            ckpt.save(steps, {"params": weights, "opt": opt_state},
                      extra={"data": data.state_dict()})
    finally:
        data.stop()
        if ckpt:
            ckpt.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "grad_norms": grad_norms,
            "steps_run": len(losses), "params": weights,
            "opt_state": opt_state, "checkpoints": ckpt.log if ckpt else []}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = train(arch=args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                seed=args.seed, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
