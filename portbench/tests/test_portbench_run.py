"""Whole runs: each cell's path at a CPU size, the import check, the
refusals, and ``correct`` coming out false with the timed path broken
underneath. The card test runs the command itself on the card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, importcheck

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("alibaba-iso-backlog", "aws-shared-backlog")
# a size the CPU holds: few chains and sweeps, small batches; the floor on
# the plans' gain is this size's (6 sweeps of 4 chains read 0.096-0.119 in
# alibaba-iso-backlog and 0.66-0.68 in aws-shared-backlog, the frozen SA
# 0.009-0.021 in the first)
CPU_SCALE = {"config": {"vec": {"chains": 4, "iters": 6, "grid": 32},
                        "limits": {"plan_gain_min": 0.05}},
             "traffic": {"loop": {"clients": 8, "rate": 20.0},
                         "daemon": {"max_batch": 4, "max_queue": 64,
                                    "max_wait_s": 0.1},
                         "pool": {"bucket_p": 4}, "warm_buckets": [4],
                         "dags": 16}}


def _cpu_run(workload, trace, cwd=ROOT, scale=CPU_SCALE, seconds=1.5):
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import run; "
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
            f"'{2**31 + 5}', '--seconds', '{seconds}', '--trace', "
            f"'{trace}'], device='cpu', scale={scale!r}, drain_s=10.0))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_cpu_sized_run_prints_one_well_formed_line(workload, trace):
    proc = _cpu_run(workload, trace)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    bench = harness.load_bench()
    wanted = {m["name"] for m in harness.cell_metrics(bench, workload,
                                                      bool(trace))}
    # the device's readings need the card; everything else is read here
    here = {n for n in wanted if not n.startswith(("device_idle",
                                                   "sgs_decode_roofline"))}
    assert here <= set(line["metrics"]) <= wanted
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert all(harness.passes(c) for c in line["checks"].values())
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_the_command_refuses_a_machine_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _cpu_run(CELLS[0], 0, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_import_check_compares_whole_names():
    assert importcheck.forbidden_loaded(
        ["repro_torch.core", "reprox", "jaxtyping", "numpy"]) == []
    assert importcheck.forbidden_loaded(
        ["repro.core.dag", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


# --- the timed path broken underneath ------------------------------------


def _broken(monkeypatch, fault):
    from repro_torch.core import session
    plan = session.PlannerSession.plan

    def broken(self, requests, **kw):
        res = plan(self, requests, **kw)
        return fault(res)
    monkeypatch.setattr(session.PlannerSession, "plan", broken)


def _shift_a_start(res):
    sol = res[0].plan.solution
    sol.start[-1] += 1.0                 # an answer altered where produced
    return res


def _drop_half(res):
    return res[:max(1, len(res) // 2)]   # half of the batch left out


def _swap(res):
    import dataclasses
    if len(res) < 2:
        return res
    # each plan handed to the other request
    return [dataclasses.replace(r, plan=o.plan)
            for r, o in zip(res, res[1:] + res[:1])]


@pytest.mark.parametrize("fault", [_shift_a_start, _drop_half, _swap])
@pytest.mark.parametrize("workload", ["alibaba-iso-backlog",
                                      "aws-shared-backlog"])
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    _broken(monkeypatch, fault)
    out = harness.run_cell(workload, 12, 1.5, False, device="cpu",
                           scale=CPU_SCALE, drain_s=3.0)
    line = out["line"]
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"


def test_a_frozen_sa_is_not_correct():
    """Every sweep returns its state unchanged: the plans stay valid, and
    their gain falls under the floor."""
    from portbench import control
    res = control.fault_run("alibaba-iso-backlog", 12, 1.5, "sa_frozen",
                            device="cpu", scale=CPU_SCALE, drain_s=3.0)
    assert res["correct"] is False
    assert res["checks"]["plan_err"]["value"] <= \
        res["checks"]["plan_err"]["limit"]
    assert not harness.passes(res["checks"]["plan_gain"])


def test_an_open_loop_cell_is_added_by_entries_alone(tmp_path):
    """The open-loop mix and its readers stand ready: a cell that names them
    runs from ``BENCHMARK.json`` entries alone."""
    bench = harness.load_bench()
    bench["workloads"].append(dict(name="alibaba-iso-open",
                                   config="alibaba-v2018", traffic="iso-open",
                                   chips=1, why="open loop"))
    bench["end_to_end"].append(dict(
        name="plan_p95_s", unit="s", better="lower", bound=0.25,
        source="host_clock", workloads=["alibaba-iso-open"]))
    bench["per_layer"].append(dict(
        name="queue_wait_ms.open", unit="ms", better="lower",
        source="program_span", layer="front door", moves="plan_p95_s",
        workloads=["alibaba-iso-open"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace, want in ((False, {"plan_p95_s", "plan_gain", "setup_s"}),
                        (True, {"queue_wait_ms.open"})):
        out = harness.run_cell("alibaba-iso-open", 3, 1.5, trace,
                               device="cpu", scale=CPU_SCALE, drain_s=5.0,
                               root=tmp_path)
        assert out["line"]["correct"] is True
        assert set(out["line"]["metrics"]) == want


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_command_on_the_card(card, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
