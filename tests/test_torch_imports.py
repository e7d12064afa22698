"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_package_has_the_slice_modules():
    mods = set(_all_modules())
    for name in ("device", "kernels.ref", "kernels.ops", "kernels._build",
                 "kernels.sgs_decode", "kernels.sched_violation",
                 "kernels.usl_runtime", "core.vectorized", "core.ising",
                 "core.session", "core.agora", "cluster.workloads",
                 "obs.sink", "flow.chaos", "flow.executor", "flow.streaming",
                 "flow.daemon", "launch.serve_planner", "launch.obs_report",
                 "launch.mesh", "core.predictor", "models.common",
                 "models.layers", "models.transformer", "models.convert",
                 "models.moe", "models.gla", "models.ssm",
                 "configs", "configs.smollm_360m", "launch.serve_model",
                 "launch.serve"):
        assert "repro_torch." + name in mods


def test_port_imports_no_jax_and_no_reference():
    """Every port module imports with jax blocked, and no ``repro`` or
    ``repro.*`` module gets loaded."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_all_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'jax' and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_no_jax_and_no_reference():
    """``chip_smoke.py`` and the test cases it reads import neither jax nor
    anything of ``repro``, at any depth of the file."""
    import ast
    for path in ("chip_smoke.py", os.path.join("tests", "_decode_cases.py"),
                 os.path.join("tests", "_quality.py"),
                 os.path.join("tests", "_model_cases.py")):
        with open(os.path.join(ROOT, path)) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        bad = [m for m in names if m.split(".")[0] in ("jax", "repro")]
        assert not bad, (path, bad)
        if path == "chip_smoke.py":      # the walk reaches main()'s imports
            assert "repro_torch.core.agora" in names


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda():
    """``Agora``, ``agora.session`` and the solver functions run on the card
    unless the caller passes ``device="cpu"``; without a card they raise."""
    from repro_torch.cluster.catalog import paper_cluster
    from repro_torch.cluster.workloads import dag1
    from repro_torch.core.agora import Agora
    from repro_torch.core.dag import flatten
    from repro_torch.core.ising import IsingConfig, ising_anneal
    from repro_torch.core.objectives import Goal
    from repro_torch.core.vectorized import VecConfig, vectorized_anneal_many

    cluster = paper_cluster()
    agora = Agora(cluster, solver="vectorized", device="cpu")
    assert agora.session().device == torch.device("cpu")
    if torch.cuda.is_available():
        assert Agora(cluster).device.type == "cuda"
        assert agora.session(device="cuda").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Agora(cluster)
    with pytest.raises(RuntimeError, match="CUDA"):
        agora.session(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        vectorized_anneal_many([flatten([dag1(cluster)], 2)], cluster,
                               Goal.balanced(), VecConfig(chains=2, iters=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        ising_anneal(flatten([dag1(cluster)], 2), cluster, Goal.balanced(),
                     IsingConfig(chains=2, iters=1))


def test_use_kernel_true_on_cpu_tensors_raises():
    z = torch.zeros
    args = (z((1, 2), dtype=torch.int32), z((1, 2, 1)), z((1, 2)),
            z(2, dtype=torch.int32), z((2, 2), dtype=torch.bool), z(1))
    with pytest.raises(ValueError, match="CUDA"):
        ops.sgs_decode(*args, T=8, use_kernel=True)
