"""The port's planner-serving entry points on the CPU:
``python -m repro_torch.launch.serve_planner`` and
``python -m repro_torch.launch.obs_report``.

The CLI is run as a user runs it, in a subprocess: it serves
``/healthz``, plans the demo template's DAG through ``/v1/plan``, reports
``/v1/stats`` and exits cleanly on SIGINT. Without ``--device cpu`` on a
machine with no card it raises instead of serving. The port's report over
the CLI's event tape is byte for byte the reference's report over it.
"""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from repro.launch import obs_report as ref_report
from repro_torch.flow.daemon import dag_to_json
from repro_torch.launch import obs_report as port_report
from repro_torch.launch.serve_planner import demo_template

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--chains", "4", "--iters", "10", "--grid", "32"]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_planner", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Run the CLI on the CPU with an event tape: healthz, one plan and the
    stats over HTTP, then SIGINT. Yields what each step returned."""
    events = str(tmp_path_factory.mktemp("cli") / "events.jsonl")
    proc = _cli("--device", "cpu", "--port", "0", "--max-wait", "0.2",
                "--events", events, *SMALL)
    lines = []
    try:
        deadline = time.monotonic() + 120
        port = None
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "serving on http://" in line:
                port = int(line.split("serving on http://")[1]
                           .split()[0].rsplit(":", 1)[1])
        assert port is not None, "".join(lines) + proc.stderr.read()
        health = _http(port, "/healthz")
        plan = _http(port, "/v1/plan", {"dag": dag_to_json(demo_template())})
        stats = _http(port, "/v1/stats")
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    yield dict(health=health, plan=plan, stats=stats, rc=proc.returncode,
               out="".join(lines) + out, err=err, events=events)


def test_cli_serves_plans_and_exits_cleanly(served):
    assert served["health"] == (200, {"ok": True, "running": True})
    status, plan = served["plan"]
    assert status == 200 and plan["errors"] == []
    assert plan["tasks"] == ["prep", "heavy0", "heavy1"]
    status, stats = served["stats"]
    assert status == 200 and stats["served"] == 1
    assert stats["pools"]["shared"]["trace_count"] >= 1
    assert served["rc"] == 0, served["err"]
    assert "shutting down" in served["out"]


def test_cli_without_device_refuses_to_serve_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    proc = _cli("--port", "0", *SMALL)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in err and "serving on" not in out


@pytest.mark.parametrize("args", [[], ["--traces"], ["--json"], ["--trace"]],
                         ids=["report", "traces", "json", "trace"])
def test_obs_report_matches_reference(served, args):
    """Both packages' reports over the same tape, byte for byte."""
    if args == ["--trace"]:
        with open(served["events"]) as f:
            first = next(json.loads(ln)["trace_id"] for ln in f
                         if json.loads(ln).get("trace_id"))
        args = ["--trace", first]
    texts = []
    for report in (ref_report, port_report):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert report.main([served["events"], *args]) == 0
        texts.append(buf.getvalue())
    if args[:1] == ["--trace"]:
        # the port prints each batch event's phases under it (indented past
        # the event lines); the reference records none
        lines = texts[1].splitlines(keepends=True)
        phases = [ln for ln in lines if ln.startswith(" " * 16)]
        assert any("engine.solve" in ln for ln in phases)
        assert any("daemon.solve" in ln for ln in phases)
        texts[1] = "".join(ln for ln in lines if ln not in phases)
    assert texts[1] == texts[0]
    assert texts[0]
