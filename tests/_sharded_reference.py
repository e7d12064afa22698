"""The reference's numbers on (data, model) meshes, for
``tests/test_torch_sharded.py``: run as a script in a subprocess with 8
placeholder devices (``--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs the reference), so the calling process
keeps one device. Writes one ``.npz`` to the path it is given:

* ``olmoe-1b-7b`` SMOKE in float32 at ``capacity_factor=1.0``, batch 4 x 16
  from ``np.random.default_rng(0)``, ``Model.init(seed=1)``, on meshes (1,
  1), (2, 1), (1, 4), (2, 4) and (2, 4) with ``moe_sp_dispatch``: the loss
  and aux of ``jax.jit(model.loss)``, the logits of ``model.forward``, the
  gradient of the loss; on (2, 4) the logits of 4 ``decode_step``s over
  the batch's first 4 tokens;
* ``yi-6b`` SMOKE with ``seq_parallel`` and ``fast_norm``, and
  ``smollm-360m`` SMOKE (15 heads over 5 kv heads at full width, 3 over 1
  here: attention replicated, the cache sharded by position), each on (2,
  4), the same records; ``smollm-360m``'s 4 decode steps too;
* ``olmoe-1b-7b``'s greedy tokens from the reference's ``serve`` on (2, 4)
  in float32 (batch 4, prompt 8, 8 tokens);
* each arch's parameters, for the port to carry across.

Keys: ``{case}/loss``, ``{case}/aux``, ``{case}/logits``, ``{case}/decode``,
``{case}/grad/{path}``, ``{arch}/params/{path}``, ``serve/tokens``; the
path of a leaf is its keys joined by "/".
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compat import make_mesh  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models.transformer import Model  # noqa: E402

B, S, DECODE = 4, 16, 4
MOE = dict(dtype="float32", capacity_factor=1.0)
# (case, arch, config changes, mesh shape)
CASES = [
    ("olmoe-1x1", "olmoe-1b-7b", MOE, (1, 1)),
    ("olmoe-2x1", "olmoe-1b-7b", MOE, (2, 1)),
    ("olmoe-1x4", "olmoe-1b-7b", MOE, (1, 4)),
    ("olmoe-2x4", "olmoe-1b-7b", MOE, (2, 4)),
    ("olmoe-2x4-sp", "olmoe-1b-7b", dict(MOE, moe_sp_dispatch=True), (2, 4)),
    ("yi-2x4-sp", "yi-6b", dict(dtype="float32", seq_parallel=True,
                                fast_norm=True), (2, 4)),
    ("smollm-2x4", "smollm-360m", dict(dtype="float32"), (2, 4)),
]
DECODED = ("olmoe-2x4", "smollm-2x4")
SEEDS = {"olmoe-1b-7b": 1, "yi-6b": 2, "smollm-360m": 0}


def batch_for(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (B, S)),
            "labels": rng.integers(0, vocab, (B, S))}


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)
    return out


def main(out_path):
    res, params = {}, {}
    for case, arch, changes, shape in CASES:
        cfg = get_config(arch, smoke=True).replace(**changes)
        model = Model(cfg, mesh=make_mesh(shape, ("data", "model")))
        if arch not in params:
            params[arch] = model.init(seed=SEEDS[arch])
            res.update(flat(params[arch], f"{arch}/params"))
        p = params[arch]
        batch = {k: jnp.asarray(v) for k, v in
                 batch_for(cfg.vocab_size).items()}

        def loss_and_logits(p, batch, model=model):
            loss, metrics = model.loss(p, batch)
            return loss, (metrics["aux"], model.forward(p, batch)[0])

        (loss, (aux, logits)), grads = jax.jit(jax.value_and_grad(
            loss_and_logits, has_aux=True))(p, batch)
        res[f"{case}/loss"] = np.float64(loss)
        res[f"{case}/aux"] = np.float64(aux)
        res[f"{case}/logits"] = np.asarray(logits, np.float32)
        res.update(flat(grads, f"{case}/grad"))
        if case in DECODED:
            cache, _ = model.init_cache(B, S)
            step = jax.jit(model.decode_step)
            out = []
            for t in range(DECODE):
                lg, cache = step(p, cache, {"tokens": batch["tokens"][
                    :, t:t + 1].astype(jnp.int32)}, t)
                out.append(np.asarray(lg[:, 0], np.float32))
            res[f"{case}/decode"] = np.stack(out, 1)

    import repro.launch.serve_model as serving
    get = serving.get_config
    serving.get_config = lambda a, smoke=False: get(a, smoke).replace(
        dtype="float32")
    res["serve/tokens"] = serving.serve(
        "olmoe-1b-7b", smoke=True, batch=4, prompt_len=8, gen_tokens=8,
        mesh=make_mesh((2, 4), ("data", "model")),
        params=params["olmoe-1b-7b"], quiet=True)["tokens"]
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
