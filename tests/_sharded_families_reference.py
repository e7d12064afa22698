"""The reference's numbers on a (2, 4) mesh for MLA, the VLM's
cross-attention groups, RWKV6 and Mamba2, for
``tests/test_torch_sharded_families.py``: run as a script in a subprocess
with 8 placeholder devices (``--xla_force_host_platform_device_count=8``,
as ``tests/_sharded_reference.py`` runs), so the calling process keeps one
device. Writes one ``.npz`` to the path it is given.

Each case is an arch's SMOKE config in float32 on the (2, 4) mesh, batch
4 x 16 from ``np.random.default_rng(0)`` (tokens, then labels, then for
the VLM patches (B, num_patches, d) x 0.02), weights from
``Model.init(seed)``:

* ``deepseek-2x4``: ``deepseek-v2-lite-16b`` at ``capacity_factor=1.0``,
  seed 1; ``deepseek-2x4-sp`` the same with ``moe_sp_dispatch``;
* ``rwkv6-2x4``: ``rwkv6-3b``, seed 2;
* ``zamba2-2x4``: ``zamba2-2.7b``, seed 3;
* ``vlm-2x4``: ``llama-3.2-vision-11b``, seed 4, its gates set to 0.5 +
  ``np.random.default_rng(4).random(G)`` (as
  ``tests/_model_reference.py:gated`` sets them; drawn, they are zero).

Records: the loss and aux of ``jax.jit(model.loss)``, the logits of
``model.forward``, the gradient of the loss, and the logits of 4
``decode_step``s over the batch's first 4 tokens (deepseek's with
``mla_absorb`` True and False; the VLM's over a patch cache filled with
each group's projection of the patches, as
``tests/test_torch_multimodal.py:patch_kv`` fills it).

Keys: ``{case}/loss``, ``{case}/aux``, ``{case}/logits``,
``{case}/decode`` (deepseek also ``{case}/decode-expanded``),
``{case}/grad/{path}``, ``{case}/params/{path}``; the path of a leaf is
its keys joined by "/".
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from repro.compat import make_mesh  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models.transformer import Model  # noqa: E402

B, S, DECODE = 4, 16, 4
SHAPE = (2, 4)
MOE = dict(dtype="float32", capacity_factor=1.0)
# case: (arch, config changes, seed)
CASES = {
    "deepseek-2x4": ("deepseek-v2-lite-16b", MOE, 1),
    "deepseek-2x4-sp": ("deepseek-v2-lite-16b",
                        dict(MOE, moe_sp_dispatch=True), 1),
    "rwkv6-2x4": ("rwkv6-3b", dict(dtype="float32"), 2),
    "zamba2-2x4": ("zamba2-2.7b", dict(dtype="float32"), 3),
    "vlm-2x4": ("llama-3.2-vision-11b", dict(dtype="float32"), 4),
}


def batch_for(cfg):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.cross_attn_every:
        out["patches"] = (rng.normal(size=(B, cfg.num_patches, cfg.d_model))
                          * 0.02).astype(np.float32)
    return out


def gates(G):
    return 0.5 + np.random.default_rng(4).random(G).astype(np.float32)


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)
    return out


def patch_kv(cfg, params, patches):
    """Each group's k and v of ``patches`` (G, B, P, KH, Dh)."""
    dt = cfg.cdtype
    p = jnp.asarray(patches).astype(dt)
    return {n: jnp.stack([jnp.einsum("bpd,dhk->bphk", p, w.astype(dt))
                          for w in params["cross"][f"w{n}"]])
            for n in ("k", "v")}


def decode(model, params, batch, cfg):
    cache, specs = model.init_cache(B, S)
    # placed as the step's output is, so that the step compiles once
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(model.mesh, s)), cache,
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    if cfg.cross_attn_every:
        cache["cross_groups"]["cross_kv"] = patch_kv(cfg, params,
                                                     batch["patches"])
    step = jax.jit(model.decode_step)
    out = []
    for t in range(DECODE):
        lg, cache = step(params, cache, {"tokens": batch["tokens"][
            :, t:t + 1].astype(jnp.int32)}, t)
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, 1)


def main(out_path):
    res = {}
    mesh = make_mesh(SHAPE, ("data", "model"))
    for case, (arch, changes, seed) in CASES.items():
        cfg = get_config(arch, smoke=True).replace(**changes)
        model = Model(cfg, mesh=mesh)
        params = model.init(seed=seed)
        if cfg.cross_attn_every:
            cross = params["cross"]
            params = {**params, "cross": {
                **cross, "gate": jnp.asarray(gates(cross["gate"].shape[0]))}}
        res.update(flat(params, f"{case}/params"))
        batch = {k: jnp.asarray(v) for k, v in batch_for(cfg).items()}

        def loss_and_logits(p, batch, model=model):
            loss, metrics = model.loss(p, batch)
            return loss, (metrics["aux"], model.forward(p, batch)[0])

        (loss, (aux, logits)), grads = jax.jit(jax.value_and_grad(
            loss_and_logits, has_aux=True))(params, batch)
        res[f"{case}/loss"] = np.float64(loss)
        res[f"{case}/aux"] = np.float64(aux)
        res[f"{case}/logits"] = np.asarray(logits, np.float32)
        res.update(flat(grads, f"{case}/grad"))
        res[f"{case}/decode"] = decode(model, params, batch, cfg)
        if cfg.mla and not cfg.moe_sp_dispatch:
            expanded = Model(cfg.replace(mla_absorb=False), mesh=mesh)
            res[f"{case}/decode-expanded"] = decode(expanded, params, batch,
                                                    cfg)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
