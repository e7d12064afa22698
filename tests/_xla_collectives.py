"""The reference's collective bytes on a (2, 4) mesh, read off XLA's
compiled HLO two ways, for ``tests/test_torch_dryrun_sharded.py``'s
comparison (``PERF.md``): run as a script, with 8 placeholder devices
(``--xla_force_host_platform_device_count=8``, as
``tests/_sharded_reference.py`` runs), so a calling process keeps one
device:

    PYTHONPATH=src python tests/_xla_collectives.py

For ``yi-6b`` and ``olmoe-1b-7b`` SMOKE in float32, ``scan_layers=False``,
batch 4 x 16 from ``np.random.default_rng(0)``, ``Model.init(seed=0)``,
the loss and its gradient (``jax.value_and_grad``) and the loss alone,
it prints, by kind and times the 8 chips, the reference's own count
(``repro.roofline.parse_collective_bytes``, which takes one shape of a
collective whose output is a tuple) and the count of every shape of each
collective's output. XLA combines collectives into tuple-shaped ones,
so the two differ.
"""
import os
import re
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import roofline as rl  # noqa: E402
from repro.compat import make_mesh  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models.transformer import Model  # noqa: E402

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
CHIPS = 8


def every_shape(hlo: str) -> dict:
    """The bytes of every shape of each collective's output, by kind."""
    out = {}
    for line in hlo.splitlines():
        for kind in KINDS:
            if re.search(rf"\b{kind}(-start)?\(", line) and \
                    f"{kind}-done" not in line:
                head = line.split("=", 1)[1].split(kind)[0]
                shapes = rl._SHAPE_RE.findall(head)
                out[kind] = out.get(kind, 0) + CHIPS * sum(
                    rl._shape_bytes(d, s) for d, s in shapes)
                break
    return out


def main():
    for arch in ("yi-6b", "olmoe-1b-7b"):
        cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                                   scan_layers=False)
        model = Model(cfg, mesh=make_mesh((2, 4), ("data", "model")))
        params = model.init(seed=0)
        rng = np.random.default_rng(0)
        batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 16)))
                 for k in ("tokens", "labels")}
        steps = {"loss and gradient": jax.value_and_grad(
                     lambda p, b: model.loss(p, b)[0]),
                 "loss": lambda p, b: model.loss(p, b)[0]}
        for name, fn in steps.items():
            hlo = jax.jit(fn).lower(params, batch).compile().as_text()
            parsed = {k: CHIPS * v for k, v in
                      rl.parse_collective_bytes(hlo).items() if v}
            print(f"{arch} {name}: parse_collective_bytes {parsed}; every "
                  f"shape {every_shape(hlo)}")


if __name__ == "__main__":
    sys.exit(main())
