"""The PyTorch port's SA engines against the JAX reference, on replayed draws.

torch cannot reproduce ``jax.random``'s threefry streams, so the port takes
every random number of a solve from one draw tape. Here the tape is built
with ``jax.random`` on the reference's own keys, following
``repro.core.vectorized._init_chains`` and the per-sweep
``fold_in(key, it)`` -> ``split(6)`` schedule of ``_sa_scan`` /
``_sa_scan_shared``, and handed to the port. The port must then return the
reference's plans exactly (option_idx, start, finish), bucketed and
unbucketed, with chain energies within rtol 1e-6 (the energies are float32
sums whose reduction order may differ between XLA and torch).

Inside the port, bit-for-bit: bucketed == unbucketed, shared over disjoint
capacities == isolated, telemetry on == telemetry off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.catalog import alibaba_cluster
from repro.cluster.workloads import synth_trace
from repro.core import dag as jdag
from repro.core.annealer import reference_point
from repro.core import vectorized as jvec
from repro.core.objectives import Goal
from repro_torch.cluster.catalog import Cluster as TCluster
from repro_torch.cluster.catalog import InstanceType as TInstanceType
from repro_torch.cluster.catalog import alibaba_cluster as t_alibaba_cluster
from repro_torch.cluster.workloads import synth_trace as t_synth_trace
from repro_torch.core import dag as tdag
from repro_torch.core import vectorized as tvec
from repro_torch.core.objectives import Goal as TGoal

CPU = torch.device("cpu")
CFG_ARGS = dict(chains=8, iters=40, grid=128, seed=0)
JCFG = jvec.VecConfig(**CFG_ARGS)
TCFG = tvec.VecConfig(**CFG_ARGS)


def _erf_inv_normal(key, shape):
    """``jax.random.normal(key, shape)`` before its factor sqrt(2): the
    erf_inv of the same uniform draw (``jax.random._normal_real``)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return jax.lax.erf_inv(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))


def jax_tape(packed, cfg):
    """The reference's draws for ``packed`` (a JAX-package PackedProblems),
    as the numpy arrays of a port ``DrawTape``."""
    P_n, J = packed.task_mask.shape
    B = cfg.chains
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    n_opts = jnp.asarray(packed.n_opts, jnp.int32)

    def sweeps(pkey, n_mut, n_opts_p):
        def one(it):
            ks = jax.random.split(jax.random.fold_in(pkey, it), 6)
            j_opt = jax.random.randint(ks[0], (B,), 0, n_mut)
            new_o = jax.random.randint(ks[1], (B,), 0,
                                       jnp.take(n_opts_p, j_opt))
            j_pr = jax.random.randint(ks[2], (B,), 0, n_mut)
            return (j_opt, new_o, j_pr, _erf_inv_normal(ks[3], (B,)),
                    jax.random.uniform(ks[4], (B,)))
        return jax.vmap(one)(jnp.arange(cfg.iters))

    parts = {k: [] for k in ("rand_opt", "prio0", "j_opt", "new_o", "j_pr",
                             "jitter", "u")}
    for p in range(P_n):
        parts["rand_opt"].append(jax.random.randint(
            jax.random.fold_in(k2, p), (B, J), 0, 1_000_000))
        parts["prio0"].append(jax.random.normal(jax.random.fold_in(k3, p),
                                                (B, J)))
        n_mut = jnp.maximum(jnp.int32(packed.num_tasks[p]), 1)
        out = sweeps(jax.random.fold_in(k1, p), n_mut, n_opts[p])
        for k, v in zip(("j_opt", "new_o", "j_pr", "jitter", "u"), out):
            parts[k].append(v)
    return {k: np.stack([np.asarray(x) for x in v],
                        axis=0 if k in ("rand_opt", "prio0") else 1)
            for k, v in parts.items()}


def _problems():
    """tests/test_sgs_decode.py's instances, built in both packages."""
    jc, tc = alibaba_cluster(machines=20), t_alibaba_cluster(machines=20)
    jd, td = synth_trace(3, jc, seed=11), t_synth_trace(3, tc, seed=11)
    for d in jd + td:
        d.release_time = 0.0
    return (jc, [jdag.flatten([d], jc.num_resources) for d in jd],
            tc, [tdag.flatten([d], tc.num_resources) for d in td])


def _tape(jprobs, M, bucket, shared=False):
    packed = jdag.pack_problems(jprobs, M, shared_capacity=shared,
                                bucket_p=bucket)
    return tvec.DrawTape.from_numpy(jax_tape(packed, JCFG), device=CPU)


def _assert_same_plans(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.option_idx, y.option_idx)
        np.testing.assert_array_equal(x.start, y.start)
        np.testing.assert_array_equal(x.finish, y.finish)


@pytest.mark.parametrize("bucket", [None, 4], ids=["unbucketed", "bucket4"])
def test_isolated_plans_match_reference(bucket):
    jc, jprobs, tc, tprobs = _problems()
    ref = jvec.vectorized_anneal_many(jprobs, jc, Goal.balanced(), JCFG,
                                      bucket_p=bucket)
    port = tvec.vectorized_anneal_many(
        tprobs, tc, TGoal.balanced(), TCFG, bucket_p=bucket, device=CPU,
        tape=_tape(jprobs, jc.num_resources, bucket))
    _assert_same_plans(ref, port)


@pytest.mark.parametrize("bucket", [None, 4], ids=["unbucketed", "bucket4"])
def test_shared_plans_match_reference(bucket):
    jc, jprobs, tc, tprobs = _problems()
    ref, ref_err = jvec.vectorized_anneal_shared(jprobs, jc, Goal.balanced(),
                                                 JCFG, bucket_p=bucket)
    port, port_err = tvec.vectorized_anneal_shared(
        tprobs, tc, TGoal.balanced(), TCFG, bucket_p=bucket, device=CPU,
        tape=_tape(jprobs, jc.num_resources, bucket, shared=True))
    assert ref_err == port_err == []
    _assert_same_plans(ref, port)


def _leaves(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if k != "T"}


def _f32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _reference_inputs(shared):
    """The reference's packed batch (bucket 4), padded objective arrays,
    initial chains and keys, and the port's initial chains from the
    replayed tape; asserts the two packages start from the same state."""
    jc, jprobs, _, tprobs = _problems()
    M = jc.num_resources
    packed = jdag.pack_problems(jprobs, M, shared_capacity=shared, bucket_p=4)
    refs = [reference_point(p, jc) for p in jprobs]
    ref_M, ref_C = jvec._pad_refs(np.asarray([r[0] for r in refs]),
                                  np.asarray([r[1] for r in refs]), 4)
    goal_w, dl, dl_w = jvec._goal_arrays([Goal.balanced()] * 3, 4)
    opt0, prio0, pkeys = jvec._init_chains(packed, JCFG)
    tape = tvec.DrawTape.from_numpy(jax_tape(packed, JCFG), device=CPU)
    tpacked = tdag.pack_problems(tprobs, M, shared_capacity=shared,
                                 bucket_p=4)
    topt0, tprio0 = tvec._init_chains(tpacked, TCFG, tape, CPU)
    np.testing.assert_array_equal(topt0.numpy(), np.asarray(opt0))
    np.testing.assert_array_equal(tprio0.numpy(), np.asarray(prio0))
    assert topt0.dtype == torch.int32 and tprio0.dtype == torch.float32
    jargs = (goal_w, jnp.asarray(ref_M, jnp.float32),
             jnp.asarray(ref_C, jnp.float32), dl, dl_w)
    return (jc, packed, jargs, (opt0, prio0, pkeys),
            [_f32(x) for x in jargs], (topt0, tprio0, tape))


def _isolated_states():
    jc, packed, jargs, (opt0, prio0, pkeys), targs, tinit = \
        _reference_inputs(shared=False)
    ref_M = np.asarray(jargs[1])
    bdp = jvec.BatchedDeviceProblem.build(packed, jc, ref_M, JCFG)
    per_problem = (bdp.dur_bins, bdp.demands, bdp.costs, bdp.n_opts,
                   bdp.pred_mask, bdp.release_bins, bdp.dt, bdp.n_real)
    want = jvec._run_sa_many_jit(per_problem, bdp.caps, *jargs, JCFG, bdp.T,
                                 opt0, prio0, pkeys)
    tbdp = tvec.device_problem_from_numpy(_leaves(bdp), T=bdp.T, device=CPU)
    return want, tvec._sa_scan(tbdp, *targs, TCFG, *tinit), ()


def _shared_states():
    jc, packed, jargs, (opt0, prio0, pkeys), targs, tinit = \
        _reference_inputs(shared=True)
    layout = packed.shared_layout()
    joint_ref = reference_point(layout.joint_problem(), jc)
    sdp = jvec.SharedDeviceProblem.build(layout, jc, joint_ref[0], JCFG)
    dp = sdp.dp
    dp_arrays = (dp.dur_bins, dp.demands, dp.costs, dp.n_opts, dp.pred_mask,
                 dp.release_bins, dp.caps, jnp.float32(dp.dt))
    want = jvec._run_sa_shared_jit(dp_arrays, (dp.T,), sdp.n_real, *jargs,
                                   JCFG, opt0, prio0, pkeys)
    tdp = tvec.device_problem_from_numpy(_leaves(dp), T=dp.T, device=CPU)
    tsdp = tvec.SharedDeviceProblem(
        tdp, sdp.P, sdp.J, torch.tensor(np.asarray(sdp.n_real)))
    got = tvec._sa_scan_shared(tsdp, *targs, TCFG, *tinit)
    return want, got, ("jbest_",)


@pytest.mark.parametrize("states", [_isolated_states, _shared_states],
                         ids=["isolated", "shared"])
def test_sweep_state_matches_reference(states):
    """The whole final SA state: options and priorities exactly, chain
    energies within stated tolerances; problem arrays carried across as
    numpy. The shared engine adds its coherent joint-best snapshot."""
    want, got, extra = states()
    for k in ("opt", "best_opt") + tuple(p + "opt" for p in extra):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the jitter update ``prio + normal * sigma`` rounds as XLA rounds it
    # (the tape's erf_inv draw times XLA's folded float32 factor)
    for k in ("prio", "best_prio") + tuple(p + "prio" for p in extra):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=0, err_msg=k)
    # an energy is a sum of O(1) float32 terms that may cancel: rtol 1e-6,
    # plus an atol of one float32 ulp at 1.0 for energies near zero
    for k in ("e", "best_e") + tuple(p + "sum" for p in extra):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1.2e-7, err_msg=k)


# --- invariants inside the port (production draws), bit-for-bit ----------


def test_port_bucketed_equals_unbucketed():
    _, _, tc, tprobs = _problems()
    for solve in (tvec.vectorized_anneal_many,
                  lambda *a, **k: tvec.vectorized_anneal_shared(*a, **k)[0]):
        a = solve(tprobs, tc, TGoal.balanced(), TCFG, device=CPU)
        b = solve(tprobs, tc, TGoal.balanced(), TCFG, bucket_p=4, device=CPU)
        _assert_same_plans(a, b)
        assert [x.energy for x in a] == [y.energy for y in b]


def _disjoint_tenants(P):
    """P identical tenants, tenant p demanding only resource p (the
    pattern of tests/test_shared_capacity.py)."""
    dags = []
    for p in range(P):
        rng = np.random.default_rng(42)
        tasks = []
        for j in range(7):
            opts = []
            for o in range(3):
                d = float(rng.uniform(5, 40))
                dem = [0.0] * P
                dem[p] = float(rng.uniform(0.5, 2.5))
                opts.append(tdag.TaskOption(f"o{o}", d, tuple(dem),
                                            d * sum(dem)))
            tasks.append(tdag.Task(f"t{j}", opts, default_option=1))
        dags.append(tdag.DAG(f"d{p}", tasks,
                             edges=[(0, 2), (1, 3), (2, 4), (3, 5), (4, 6)]))
    return dags


def test_port_shared_disjoint_equals_isolated():
    P = 3
    cluster = TCluster(tuple(TInstanceType(f"r{m}", 1, 1, 3.6)
                             for m in range(P)), (4,) * P)
    probs = [tdag.flatten([d], P) for d in _disjoint_tenants(P)]
    cfg = tvec.VecConfig(chains=16, iters=60, grid=96, seed=0)
    iso = tvec.vectorized_anneal_many(probs, cluster, TGoal.balanced(), cfg,
                                      device=CPU)
    sh, joint_errors = tvec.vectorized_anneal_shared(
        probs, cluster, TGoal.balanced(), cfg, device=CPU)
    assert joint_errors == []
    _assert_same_plans(iso, sh)
    for a, b in zip(iso, sh):
        assert (a.makespan, a.cost, a.energy) == (b.makespan, b.cost, b.energy)


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_port_telemetry_leaves_plans_unchanged(shared):
    _, _, tc, tprobs = _problems()
    on = tvec.VecConfig(**CFG_ARGS, telemetry=True, telemetry_every=7)
    if shared:
        a = tvec.vectorized_anneal_shared(tprobs, tc, TGoal.balanced(), TCFG,
                                          device=CPU)[0]
        b = tvec.vectorized_anneal_shared(tprobs, tc, TGoal.balanced(), on,
                                          device=CPU)[0]
    else:
        a = tvec.vectorized_anneal_many(tprobs, tc, TGoal.balanced(), TCFG,
                                        device=CPU)
        b = tvec.vectorized_anneal_many(tprobs, tc, TGoal.balanced(), on,
                                        device=CPU)
    _assert_same_plans(a, b)
    for x, y in zip(a, b):
        assert not hasattr(x, "telemetry")
        tel = y.telemetry
        assert list(tel["steps"]) == [6, 13, 20, 27, 34, 39]
        assert np.all(np.diff(tel["best_e"]) <= 0)      # incumbent monotone
        assert np.all((tel["accept"] >= 0) & (tel["accept"] <= 1))


# --- the B=1 decode wrappers ---------------------------------------------


def _random_problems(dag_mod, rng, P, M=2):
    """tests/test_packing.py's ``_random_problems``, built in the package
    of ``dag_mod`` (its ``DAG``, ``Task``, ``TaskOption``, ``flatten``)."""
    problems = []
    for _ in range(P):
        J = int(rng.integers(2, 12))
        tasks = []
        for j in range(J):
            n_opt = int(rng.integers(1, 4))
            options = []
            for o in range(n_opt):
                d = float(rng.uniform(1, 50))
                dem = tuple(float(x) for x in rng.uniform(0.1, 3.0, M))
                options.append(dag_mod.TaskOption(f"o{o}", d, dem,
                                                  d * sum(dem)))
            tasks.append(dag_mod.Task(
                f"t{j}", options, default_option=int(rng.integers(0, n_opt))))
        edges = [(a, b) for a in range(J) for b in range(a + 1, J)
                 if rng.random() < 0.3]
        dag = dag_mod.DAG("d", tasks, edges,
                          release_time=float(rng.uniform(0, 100)))
        problems.append(dag_mod.flatten([dag], M))
    return problems


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b1_decode_wrappers_match_reference(seed):
    """tests/test_packing.py::test_padding_never_moves_real_tasks' inputs:
    each problem of a ragged batch decoded alone (its own build) and as a
    slice of the batch (padding slots live), by ``decode_schedule`` and
    ``decode_schedule_full`` in both packages. start, finish, ok, the
    makespan and the infeasible count are equal; the cost, a float32 sum
    of J terms that the two frameworks may add in another order, within
    rtol 1e-6."""
    from repro.cluster.catalog import Cluster, InstanceType
    M = 2
    jprobs = _random_problems(jdag, np.random.default_rng(seed), 4, M)
    tprobs = _random_problems(tdag, np.random.default_rng(seed), 4, M)
    rng = np.random.default_rng(seed + 100)
    jc = Cluster(tuple(InstanceType(f"r{m}", 1, 1, 3.6) for m in range(M)),
                 (4, 4))
    tc = TCluster(tuple(TInstanceType(f"r{m}", 1, 1, 3.6)
                        for m in range(M)), (4, 4))
    jcfg, tcfg = jvec.VecConfig(grid=128), tvec.VecConfig(grid=128)
    refs = np.asarray([sum(o.duration for t in p.tasks for o in t.options[:1])
                       + 1.0 for p in jprobs])
    packed = jdag.pack_problems(jprobs, M)
    bdp = jvec.BatchedDeviceProblem.build(packed, jc, refs, jcfg)
    tbdp = tvec.BatchedDeviceProblem.build(
        tdag.pack_problems(tprobs, M), tc, refs, tcfg, device=CPU)
    Jmax = packed.max_tasks
    for p, (jprob, tprob) in enumerate(zip(jprobs, tprobs)):
        J = jprob.num_tasks
        opt = rng.integers(0, 1_000_000, Jmax) % np.asarray(packed.n_opts[p])
        prio = rng.normal(size=Jmax)
        prio[J:] = -1e9
        j_sl = jvec.DeviceProblem(bdp.dur_bins[p], bdp.demands[p],
                                  bdp.costs[p], bdp.n_opts[p],
                                  bdp.pred_mask[p], bdp.release_bins[p],
                                  bdp.caps, float(bdp.dt[p]), bdp.T)
        t_sl = tvec.DeviceProblem(tbdp.dur_bins[p], tbdp.demands[p],
                                  tbdp.costs[p], tbdp.n_opts[p],
                                  tbdp.pred_mask[p], tbdp.release_bins[p],
                                  tbdp.caps, float(tbdp.dt[p]), tbdp.T)
        cases = [(j_sl, t_sl, opt, prio),
                 (jvec.DeviceProblem.build(jprob, jc, float(refs[p]), jcfg),
                  tvec.DeviceProblem.build(tprob, tc, float(refs[p]), tcfg,
                                           device=CPU),
                  opt[:J], prio[:J])]
        for jdp, tdp, o, pr in cases:
            jo, jp = jnp.asarray(o, jnp.int32), jnp.asarray(pr, jnp.float32)
            to = torch.tensor(o, dtype=torch.int32)
            tp = torch.tensor(pr, dtype=torch.float32)
            for w, g in zip(jvec.decode_schedule_full(jdp, jo, jp),
                            tvec.decode_schedule_full(tdp, to, tp)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            s_w, mk_w, c_w, inf_w = jvec.decode_schedule(jdp, jo, jp)
            s_g, mk_g, c_g, inf_g = tvec.decode_schedule(tdp, to, tp)
            np.testing.assert_array_equal(s_g.numpy(), np.asarray(s_w))
            assert mk_g.dtype == torch.float32 and c_g.dtype == torch.float32
            assert float(mk_g) == float(mk_w)
            assert int(inf_g) == int(inf_w) and inf_g.dtype == torch.int32
            np.testing.assert_allclose(float(c_g), float(c_w), rtol=1e-6)


# --- the host re-evaluation against the reference's SGS -------------------


def _aws_tenants(n):
    """``n`` paper DAGs (DAG1, DAG2 and the motivation DAG in turn) on the
    m5 cluster, whose 16 instances a type they contend for."""
    from repro_torch.cluster.catalog import paper_cluster
    from repro_torch.cluster.workloads import dag1, dag2, motivation_dag
    cluster = paper_cluster()
    makers = (dag1, dag2, motivation_dag)
    return cluster, [tdag.flatten([makers[i % 3](cluster)],
                                  cluster.num_resources) for i in range(n)]


@pytest.mark.parametrize("case", ["alibaba", "aws-m5"])
@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_reeval_matches_reference_sgs(monkeypatch, shared, case):
    """Each returned Solution's start, finish, makespan and cost equal what
    the reference's ``sgs_schedule`` and ``schedule_cost`` give on the
    options and priorities the engine picked (recorded at its
    ``sgs_schedule``); the shared engine's on the joint problem."""
    from repro.core import sgs as rsgs
    from _sgs_cases import as_reference
    if case == "alibaba":
        _, _, cluster, probs = _problems()
    else:
        cluster, probs = _aws_tenants(6)
    calls = []
    real = tvec.sgs_schedule

    def recorded(problem, option_idx, priority=None, caps=None, **kw):
        calls.append((problem, np.array(option_idx), np.array(priority),
                      np.array(caps)))
        return real(problem, option_idx, priority=priority, caps=caps, **kw)

    monkeypatch.setattr(tvec, "sgs_schedule", recorded)
    if shared:
        sols, joint_errors = tvec.vectorized_anneal_shared(
            probs, cluster, TGoal.balanced(), TCFG, device=CPU)
        assert joint_errors == []
        (joint, oi, pr, caps), = calls
        ref_s, ref_f = rsgs.sgs_schedule(as_reference(joint), oi,
                                         priority=pr, caps=caps)
        cuts = np.cumsum([0] + [p.num_tasks for p in probs])
        picked = [(oi[a:b], ref_s[a:b], ref_f[a:b])
                  for a, b in zip(cuts[:-1], cuts[1:])]
        if case == "aws-m5":
            ready = np.zeros(joint.num_tasks)
            for a, b in joint.edges:
                ready[b] = max(ready[b], ref_f[a])
            assert np.any(ref_s > ready)      # the shared capacity binds
    else:
        sols = tvec.vectorized_anneal_many(probs, cluster, TGoal.balanced(),
                                           TCFG, device=CPU)
        assert [c[0] for c in calls] == probs
        picked = []
        for prob, oi, pr, caps in calls:
            s, f = rsgs.sgs_schedule(as_reference(prob), oi, priority=pr,
                                     caps=caps)
            picked.append((oi, s, f))
    assert len(sols) == len(probs) == len(picked)
    for sol, prob, (oi, s, f) in zip(sols, probs, picked):
        np.testing.assert_array_equal(sol.option_idx, oi)
        np.testing.assert_array_equal(sol.start, s)
        np.testing.assert_array_equal(sol.finish, f)
        assert sol.makespan == float(f.max())
        assert sol.cost == rsgs.schedule_cost(as_reference(prob), oi,
                                              cluster.prices_per_sec)
