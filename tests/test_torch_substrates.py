"""The port's training substrates against the reference, on the CPU: the
token pipeline (the reference's own file: its batches bit for bit),
``Checkpointer`` (exact round trips, background saves with garbage
collection, ``latest_step``, atomic renames), AdamW (``update`` over 12
steps through warmup into the cosine, the clip active and not, within a
few ulps; ``compress_int8`` bit for bit), the int8 ring over K = 8
in-process replicas (bit for bit with the reference's ``shard_map`` ring on
8 placeholder devices, run once in a subprocess), and the trainer's CLI.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.train import train
from repro_torch.optim import adamw, compressed
from repro_torch.tree import flatten, leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref_batches(cfg_kw, steps, start=0):
    ref = ref_pipeline.TokenPipeline(ref_pipeline.DataConfig(**cfg_kw))
    ref.load_state_dict({"step": start})
    return [next(ref) for _ in range(steps)]


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

DATA = dict(vocab_size=128, seq_len=32, global_batch=4, seed=9)


def test_pipeline_batches_equal_the_reference():
    pipe = TokenPipeline(DataConfig(**DATA))
    same_batches([next(pipe) for _ in range(6)], ref_batches(DATA, 6))


def test_prefetched_batches_equal_the_reference():
    pipe = TokenPipeline(DataConfig(**DATA)).start()
    try:
        got = [next(pipe) for _ in range(5)]
    finally:
        pipe.stop()
    same_batches(got, ref_batches(DATA, 5))


def test_resumed_pipeline_equals_the_reference():
    pipe = TokenPipeline(DataConfig(**DATA)).start()
    try:
        pipe.load_state_dict({"step": 3})
        got = [next(pipe) for _ in range(3)]
        assert pipe.state_dict() == {"step": 6}
    finally:
        pipe.stop()
    same_batches(got, ref_batches(DATA, 3, start=3))


def test_host_sharded_pipeline_equals_the_reference():
    for host in (0, 1):
        kw = dict(DATA, num_hosts=2, host_id=host)
        pipe = TokenPipeline(DataConfig(**kw))
        got = [next(pipe) for _ in range(2)]
        same_batches(got, ref_batches(kw, 2))
        full = ref_batches(DATA, 2)
        for g, f in zip(got, full):
            np.testing.assert_array_equal(g["tokens"],
                                          f["tokens"][2 * host:2 * host + 2])


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32) + seed,
                  "d": [torch.randn(2, generator=g),
                        torch.randn(3, generator=g).to(torch.bfloat16)]},
            "opt": adamw.OptState(torch.tensor(seed, dtype=torch.int32),
                                  {"m": torch.randn(2, generator=g)},
                                  {"m": torch.randn(2, generator=g)},
                                  {"m": torch.zeros(())})}


def same_trees(got, want):
    assert [k for k, _ in flatten(got)] == [k for k, _ in flatten(want)]
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip_exact(tmp_path):
    """float32, bfloat16 and int32 leaves in nested dicts, lists and a
    named tuple come back bit for bit, in the template's dtypes."""
    ck = Checkpointer(str(tmp_path))
    t = _tree(0)
    ck.save(7, {"params": t}, extra={"data": {"step": 7}})
    step, trees, extra = ck.restore({"params": _tree(1)})
    assert step == 7 and extra == {"data": {"step": 7}}
    same_trees(trees["params"], t)
    assert isinstance(trees["params"]["opt"], adamw.OptState)
    with np.load(os.path.join(str(tmp_path), "step_0000000007",
                              "params.npz")) as z:
        assert "b/d/1" in z.files and "opt/mu/m" in z.files
        assert z["b/d/1"].dtype == np.float32      # bfloat16 upcast
    assert [e["op"] for e in ck.log] == ["save", "restore"]
    assert ck.log[0]["bytes"] == ck.log[1]["bytes"] > 0


def test_checkpoint_async_saves_and_gc(tmp_path):
    """Background saves copy the tree before returning: a tree changed
    afterwards does not reach the disk. ``keep=2`` leaves the newest two."""
    ck = Checkpointer(str(tmp_path), keep=2)
    trees = {s: _tree(s) for s in (1, 2, 3, 4)}
    for s, t in trees.items():
        ck.save(s, {"p": t}, blocking=False)
        t["a"].add_(100.0)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    _, got, _ = ck.restore({"p": _tree(0)}, step=3)
    same_trees(got["p"], _tree(3))


def test_latest_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"p": _tree(0)})
    for s in (5, 12, 9):
        ck.save(s, {"p": _tree(s)})
    assert ck.latest_step() == 12
    step, got, _ = ck.restore({"p": _tree(0)})
    assert step == 12
    same_trees(got["p"], _tree(12))


def test_partial_checkpoint_is_invisible(tmp_path):
    """A ``.tmp_*`` directory (a save cut off before its rename) is never
    a step."""
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"p": _tree(3)})
    os.makedirs(os.path.join(str(tmp_path), ".tmp_cut_off"))
    with open(os.path.join(str(tmp_path), ".tmp_cut_off", "p.npz"), "w"):
        pass
    assert ck.all_steps() == [3]
    assert ck.latest_step() == 3


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SHAPES = {"w": (8, 16), "b": (16,), "blocks": [{"k": (4, 4, 3)},
                                               {"k": (4, 4, 3)}], "s": ()}
# a few float32 ulps: jnp and torch compute b ** step and cos with their
# own approximations, and sum the global norm in other orders
ULPS = 8 * float(np.finfo(np.float32).eps)


def _draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_draw(rng, v, scale) for v in shapes]
    return np.asarray(rng.normal(size=shapes) * scale, np.float32)


def _port(tree):
    return jax.tree.map(torch.as_tensor, tree)


@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (0.01, False)])
def test_adamw_update_matches_reference(grad_scale, clipped):
    """12 steps, warmup 4 then the cosine to step 12, on a seeded tree of
    mixed shapes, each step's gradients drawn anew: params, moments, step
    and metrics within a few ulps of the reference's."""
    rng = np.random.default_rng(0)
    start = _draw(rng, SHAPES)
    cfg = dict(lr=1e-2, warmup_steps=4, total_steps=12)
    rp = jax.tree.map(jnp.asarray, start)
    rs = ref_adamw.init(rp, ref_adamw.AdamWConfig(**cfg))
    pp = _port(jax.tree.map(np.copy, start))
    ps = adamw.init(pp, adamw.AdamWConfig(**cfg))
    lrs = []
    for _ in range(12):
        g = _draw(rng, SHAPES, grad_scale)
        rp, rs, rm = ref_adamw.update(rp, jax.tree.map(jnp.asarray, g), rs,
                                      ref_adamw.AdamWConfig(**cfg))
        pp, ps, pm = adamw.update(pp, _port(g), ps, adamw.AdamWConfig(**cfg))
        assert (float(rm["grad_norm"]) > 1.0) == clipped
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=ULPS)
        lrs.append(float(pm["lr"]))
    assert int(ps.step) == int(rs.step) == 12
    assert max(lrs) == lrs[3] and lrs[-1] < lrs[4]   # warmup, then cosine
    for got, want in ((pp, rp), (ps.mu, rs.mu), (ps.nu, rs.nu)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ULPS,
                                       atol=ULPS * float(np.abs(b).max()))
    assert [tuple(e.shape) for e in jax.tree.leaves(ps.err)] == \
        [()] * len(jax.tree.leaves(pp))


def test_grad_norm_is_reported_before_clipping():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0,
                            warmup_steps=0, total_steps=10)
    params = {"x": torch.zeros(3)}
    state = adamw.init(params, cfg)
    params, _, metrics = adamw.update(
        params, {"x": torch.tensor([1e6, 0.0, 0.0])}, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5
    assert float(params["x"].abs().max()) <= 1.0 + 1e-6


def test_compress_int8_is_bit_for_bit():
    """Four rounds of error feedback, each round's (q, scale, err) equal to
    the reference's; the dequantized sum converges to 4 g."""
    g = (np.random.default_rng(0).normal(size=(256,)) * 3).astype(np.float32)
    err_r, err_p = jnp.zeros_like(g), torch.zeros(256)
    total = torch.zeros(256)
    for _ in range(4):
        qr, sr, err_r = ref_adamw.compress_int8(jnp.asarray(g), err_r)
        qp, sp, err_p = adamw.compress_int8(torch.from_numpy(g), err_p)
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
        assert qp.dtype == torch.int8
        assert float(sp) == float(sr)
        np.testing.assert_array_equal(err_p.numpy(), np.asarray(err_r))
        total += qp.float() * sp
    rel = float((total - 4 * torch.from_numpy(g)).norm()
                / (4 * torch.from_numpy(g)).norm())
    assert rel < 0.02


# ---------------------------------------------------------------------------
# the int8 ring
# ---------------------------------------------------------------------------

K = 8
# (rows a replica x the rest): the reference shards the leading axis over
# its 8 devices; odd sizes pad the last chunk
RING_INPUTS = {"1000": (K, 1000), "odd-37": (K, 37), "3d": (2 * K, 3, 5),
               "wide-range": (K, 512)}
EF_STEPS = 8

RING_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.optim.compressed import (compressed_reduce,
                                        ring_allreduce_int8)

    mesh = make_mesh((8,), ("dp",))
    inputs = dict(np.load(sys.argv[1]))
    ring = jax.jit(shard_map(lambda x: ring_allreduce_int8(x, "dp"),
                             mesh=mesh, in_specs=P("dp"), out_specs=P("dp")))

    def step(x, e):
        v, e = compressed_reduce({"w": x}, {"w": e}, "dp")
        return v["w"], e["w"]

    ef = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("dp"), P("dp")),
                           out_specs=(P("dp"), P("dp"))))
    out = {}
    for name, x in inputs.items():
        out[name] = np.asarray(ring(jnp.asarray(x)))
        err = jnp.zeros_like(jnp.asarray(x))
        for t in range(%d):
            v, err = ef(jnp.asarray(x), err)
            out[f"{name}/ef{t}"] = np.asarray(v)
        out[f"{name}/err"] = np.asarray(err)
    np.savez(sys.argv[2], **out)
""" % EF_STEPS)


def ring_input(name):
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=RING_INPUTS[name]).astype(np.float32)
    if name == "wide-range":
        x *= np.float32(10.0) ** rng.integers(-6, 4, size=x.shape)
    return x


@pytest.fixture(scope="module")
def reference_ring(tmp_path_factory):
    """The reference's ring and error-feedback reduces of every input, one
    subprocess (8 placeholder devices) for them all."""
    d = tmp_path_factory.mktemp("ring")
    np.savez(d / "in.npz", **{n: ring_input(n) for n in RING_INPUTS})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", RING_SCRIPT,
                          str(d / "in.npz"), str(d / "out.npz")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


def replicas(x):
    return [torch.from_numpy(part) for part in np.split(x, K)]


@pytest.mark.parametrize("name", sorted(RING_INPUTS))
def test_ring_is_bit_for_bit_with_the_reference(name, reference_ring):
    """Each replica's result equals the reference's on its device, bit for
    bit. ``compressed_reduce`` over K error-feedback steps against the
    reference's: XLA compiles that program with other fused multiply-adds
    than the ring alone, which moves a chunk's sums by an ulp and can move
    a quantized value by one step, so its values and final residuals are
    held within one quantization step of the largest (max |x| / 127)."""
    x = ring_input(name)
    got = compressed.ring_allreduce_int8(replicas(x))
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  reference_ring[name])
    err = [compressed.init_error_feedback({"w": r})
           for r in replicas(x)]
    for t in range(EF_STEPS):
        vals, err = compressed.compressed_reduce(
            [{"w": r} for r in replicas(x)], err)
        want = reference_ring[f"{name}/ef{t}"]
        np.testing.assert_allclose(torch.cat([v["w"] for v in vals]).numpy(),
                                   want, rtol=0,
                                   atol=np.abs(want).max() / 127)
    want = reference_ring[f"{name}/err"]
    np.testing.assert_allclose(torch.cat([e["w"] for e in err]).numpy(),
                               want, rtol=0, atol=np.abs(x).max() / 127)


def test_ring_replicas_are_identical_and_close_to_the_mean():
    x = ring_input("1000")
    got = compressed.ring_allreduce_int8(replicas(x))
    assert all(torch.equal(g, got[0]) for g in got)
    exact = torch.from_numpy(x).mean(0)
    rel = float((got[0][0] - exact).norm() / exact.norm())
    assert rel < 0.02


def test_ring_error_feedback_is_no_worse_than_one_shot():
    x = ring_input("1000")
    exact = torch.from_numpy(x).reshape(K, 1, -1).mean(0)
    one = compressed.ring_allreduce_int8(replicas(x))[0]
    rel = float((one - exact).norm() / exact.norm())
    err = [compressed.init_error_feedback(r) for r in replicas(x)]
    acc = torch.zeros_like(exact)
    for _ in range(EF_STEPS):
        vals, err = compressed.compressed_reduce(replicas(x), err)
        acc += vals[0]
    ef_rel = float((acc / EF_STEPS - exact).norm() / exact.norm())
    assert ef_rel <= rel + 1e-6, (ef_rel, rel)


# ---------------------------------------------------------------------------
# the trainer's entry points
# ---------------------------------------------------------------------------


def test_train_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "smollm-360m", "--device", "cpu",
                          "--steps", "3"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "final loss:" in res.stdout


def test_train_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(steps=1, quiet=True)
