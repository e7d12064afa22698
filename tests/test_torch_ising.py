"""The port's Ising engine against the JAX reference, on replayed draws.

torch cannot reproduce ``jax.random``'s streams, so the port takes every
random number of a solve from one ``IsingTape``. Here the tape is built
with ``jax.random`` on the reference's own keys, following
``repro.core.ising.ising_anneal`` (``split(PRNGKey(seed), 3)``: the initial
options, the start noise, then ``fold_in(key, it)`` -> ``split(6)`` per
step of ``_ising_scan``), and handed to the port. The port must then
return the reference's plans exactly (option_idx, start, finish); the
final per-chain best energies agree within rtol 1e-6 plus one float32 ulp
at 1.0 (float32 sums whose reduction order may differ between XLA and
torch).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import catalog as jcat
from repro.cluster import workloads as jwl
from repro.core import dag as jdag
from repro.core import ising as jising
from repro.core.objectives import Goal as JGoal
from repro_torch.cluster import catalog as tcat
from repro_torch.cluster import workloads as twl
from repro_torch.core import dag as tdag
from repro_torch.core import ising as tising
from repro_torch.core.agora import Agora
from repro_torch.core.objectives import Goal as TGoal
from repro_torch.core.session import PlanRequest

CPU = torch.device("cpu")
CFG_ARGS = dict(chains=16, iters=60)


def jax_ising_tape(problem, cfg):
    """The reference's draws for ``problem`` (a JAX-package FlatProblem),
    as the numpy arrays of a port ``IsingTape``."""
    B, J, T = cfg.chains, problem.num_tasks, cfg.grid
    n_opts = jnp.asarray(problem.option_arrays()[3], jnp.int32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)

    def step(it):
        ks = jax.random.split(jax.random.fold_in(k3, it), 6)
        j = jax.random.randint(ks[0], (B,), 0, J)
        return (j, jax.random.uniform(ks[1], (B,)),
                jax.random.randint(ks[2], (B,), 0, jnp.take(n_opts, j)),
                jax.random.uniform(ks[3], (B,), minval=0.0,
                                   maxval=float(T - 1)),
                jax.random.uniform(ks[4], (B,)))

    steps = jax.vmap(step)(jnp.arange(cfg.iters))
    out = dict(rnd=jax.random.randint(k1, (B, J), 0, 1_000_000) % n_opts,
               noise=jax.random.uniform(k2, (B, J)))
    out.update(zip(("j", "kind", "new_o", "rand_t", "u"), steps))
    return {k: np.asarray(v) for k, v in out.items()}


def _dag1(pkg_cat, pkg_wl):
    c = pkg_cat.paper_cluster()
    return c, [pkg_wl.dag1(c)]


def _synth(pkg_cat, pkg_wl):
    c = pkg_cat.alibaba_cluster(machines=20)
    return c, pkg_wl.synth_trace(3, c, seed=1)[:1]


def _edgeless(pkg_cat, pkg_wl):
    c, dags = _synth(pkg_cat, pkg_wl)
    d = dags[0]
    return c, [type(d)(d.name, d.tasks, [], d.release_time)]


def _problem(build, jax_side):
    cat, wl, dag = (jcat, jwl, jdag) if jax_side else (tcat, twl, tdag)
    cluster, dags = build(cat, wl)
    return cluster, dag.flatten(dags, cluster.num_resources)


def _spy(monkeypatch, module, name):
    """Record the final state the annealing loop returns."""
    seen = {}
    orig = getattr(module, name)

    def spy(*args, **kw):
        seen["state"] = orig(*args, **kw)
        return seen["state"]

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("build", [_dag1, _synth, _edgeless],
                         ids=["dag1", "synth_trace", "edge-less"])
def test_ising_matches_reference(monkeypatch, build, seed):
    jc, jprob = _problem(build, jax_side=True)
    tc, tprob = _problem(build, jax_side=False)
    if build is _edgeless:
        assert jprob.edges == tprob.edges == []
    jcfg = jising.IsingConfig(seed=seed, **CFG_ARGS)
    tcfg = tising.IsingConfig(seed=seed, **CFG_ARGS)
    jseen = _spy(monkeypatch, jising, "_ising_scan")
    tseen = _spy(monkeypatch, tising, "_ising_loop")
    want = jising.ising_anneal(jprob, jc, JGoal.balanced(), jcfg)
    tape = tising.IsingTape.from_numpy(jax_ising_tape(jprob, jcfg),
                                       device=CPU)
    got = tising.ising_anneal(tprob, tc, TGoal.balanced(), tcfg,
                              device=CPU, tape=tape)
    np.testing.assert_array_equal(got.option_idx, want.option_idx)
    np.testing.assert_array_equal(got.start, want.start)
    np.testing.assert_array_equal(got.finish, want.finish)
    assert got.solver == want.solver == "agora-ising"
    for k in ("best_opt", "opt"):
        np.testing.assert_array_equal(tseen["state"][k].numpy(),
                                      np.asarray(jseen["state"][k]),
                                      err_msg=k)
    np.testing.assert_allclose(tseen["state"]["best_e"].numpy(),
                               np.asarray(jseen["state"]["best_e"]),
                               rtol=1e-6, atol=1.2e-7)
    # the float32 temperature cooled step by step, as the reference's
    np.testing.assert_array_equal(tseen["state"]["T"].numpy(),
                                  np.asarray(jseen["state"]["T"]))


def test_production_tape_is_seeded_and_in_range():
    _, prob = _problem(_synth, jax_side=False)
    n_opts = prob.option_arrays()[3]
    cfg = tising.IsingConfig(chains=8, iters=30, seed=4)
    a = tising.ising_tape(n_opts, cfg, CPU)
    b = tising.ising_tape(n_opts, cfg, CPU)
    for k in tising.IsingTape._DTYPES:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    a.check(8, prob.num_tasks, 30)
    bound = torch.as_tensor(n_opts)
    assert ((a.rnd >= 0) & (a.rnd < bound)).all()
    assert ((a.new_o >= 0) & (a.new_o < bound[a.j])).all()
    assert ((a.rand_t >= 0) & (a.rand_t < cfg.grid - 1)).all()
    with pytest.raises(ValueError, match="tape"):
        a.check(8, prob.num_tasks, 31)


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_session_serves_valid_ising_plans(monkeypatch, shared):
    """``Agora(solver="ising")`` through the session front door. The
    session solves at ``IsingConfig()`` defaults (512 chains x 1500 steps,
    seconds per solve on the CPU); here the defaults shrink to a CPU size,
    and the path is the same."""
    monkeypatch.setattr(tising, "IsingConfig",
                        functools.partial(tising.IsingConfig, **CFG_ARGS))
    cluster = tcat.alibaba_cluster(machines=20)
    dags = twl.synth_trace(2, cluster, seed=5)
    agora = Agora(cluster, solver="ising", device="cpu")
    sess = agora.session(shared_capacity=shared, bucket_p=2)
    res = sess.plan([PlanRequest(dag=d) for d in dags])
    assert len(res) == len(dags)
    for r in res:
        assert r.validate() == []
        assert r.plan.solution.solver.startswith("agora-ising")
        if shared:
            assert r.plan.joint_errors == []
