"""``BENCHMARK.json`` against the contract's shape rules, and the harness
finding configurations, mixes and metrics by name alone (CPU)."""
import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_bench()


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert harness.load_config(c["name"])["source"] == c["source"]
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"])
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        harness.load_traffic(w["traffic"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = harness.cell_metrics(bench, w["name"], trace=False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        layer = harness.cell_metrics(bench, w["name"], trace=True)
        assert layer and all(m["moves"] in names for m in layer)
        for m in e2e + layer:
            assert callable(harness.metric_reader(m["name"]))


def test_config_files_hold_their_keys():
    for name in ("alibaba-v2018", "aws-m5-paper"):
        cfg = harness.load_config(name)
        assert cfg["name"] == name and cfg["reduced"] == []
        assert {"cluster", "dags", "vec", "goal", "limits",
                "guarantees", "assumed"} <= set(cfg)


def test_a_new_metric_file_is_found_without_editing_the_harness(
        tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "answered.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "tiny.json").write_text('{"loop": {}}')
    monkeypatch.setattr(harness, "HERE", tmp_path)
    run = harness.Run("c", {}, {}, 1.0, requests=[1, 2, 3])
    assert harness.metric_reader("answered")(run) == 3.0
    # a suffix names the cells' kind; the reader is the base name's
    assert harness.metric_reader("answered.open")(run) == 3.0
    assert harness.load_traffic("tiny") == {"loop": {}}
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("nothing")
