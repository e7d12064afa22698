"""Clock hygiene of the port's planning core and control plane.

The repository's determinism lint rule (``tools/lint/rules/determinism.py``)
is scoped to ``repro/core/`` and ``repro/flow/``, so it does not reach
``repro_torch``. This test applies the same rule to
``src/repro_torch/core/`` and ``src/repro_torch/flow/``, walking their
ASTs:

* anywhere there: ``time.time``, ``datetime.now`` / ``utcnow`` / ``today``;
* in ``flow/`` also ``time.monotonic`` and ``time.perf_counter`` (virtual
  time comes from the injected clock, ``DaemonConfig.clock``);

each such call must carry a ``# wall clock: <reason>`` comment on its line
or the line above (genuine wall-latency accounting). Ambient stdlib
randomness (``random.*``) may not appear at all.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
WALL = ("time.time", "datetime.now", "datetime.datetime.now",
        "datetime.utcnow", "datetime.datetime.utcnow", "datetime.today",
        "datetime.datetime.today")
FLOW_CLOCKS = ("time.monotonic", "time.perf_counter")
MARK = "# wall clock:"


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return ".".join([node.id] + parts[::-1])
    return None


def clock_sites(source: str, flow: bool):
    """(line, call, reasoned) of every clock read the rule covers, and
    the lines of any ambient randomness."""
    lines = source.splitlines()
    sites, randomness = [], []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Call):
            continue
        head = _dotted(node.func)
        if head is None:
            continue
        if head.startswith("random."):
            randomness.append(node.lineno)
        if head in WALL or (flow and head in FLOW_CLOCKS):
            here = lines[node.lineno - 1]
            above = lines[node.lineno - 2] if node.lineno > 1 else ""
            reasoned = any(MARK in x and x.split(MARK, 1)[1].strip()
                           for x in (here, above))
            sites.append((node.lineno, head, reasoned))
    return sites, randomness


def _files():
    for sub in ("core", "flow"):
        for name in sorted(os.listdir(os.path.join(PORT, sub))):
            if name.endswith(".py"):
                yield sub, os.path.join(PORT, sub, name)


def test_every_clock_read_in_core_and_flow_is_reasoned():
    sites, bad = 0, []
    for sub, path in _files():
        with open(path) as f:
            found, randomness = clock_sites(f.read(), flow=sub == "flow")
        rel = os.path.relpath(path, ROOT)
        bad += [f"{rel}:{n}: {head}() without '{MARK} <reason>'"
                for n, head, ok in found if not ok]
        bad += [f"{rel}:{n}: ambient randomness" for n in randomness]
        sites += len(found)
    assert not bad, "\n".join(bad)
    # the control plane's eleven wall-latency sites (executor and daemon)
    assert sites == 11


@pytest.mark.parametrize("source,flow,want", [
    ("import time\nt = time.time()\n", False, [(2, "time.time", False)]),
    ("import time\nt = time.monotonic()\n", True,
     [(2, "time.monotonic", False)]),
    ("import time\nt = time.monotonic()\n", False, []),
    ("import time\n# wall clock: a latency\nt = time.perf_counter()\n", True,
     [(3, "time.perf_counter", True)]),
    ("import time\nt = time.time()  # wall clock:\n", False,
     [(2, "time.time", False)]),
    ("import datetime\nd = datetime.datetime.now()\n", False,
     [(2, "datetime.datetime.now", False)]),
], ids=["time-core", "monotonic-flow", "monotonic-core", "reasoned",
        "no-reason", "datetime"])
def test_a_stray_clock_is_found(source, flow, want):
    """The walk finds an unreasoned clock, in core and in flow as the rule
    scopes them; a comment without a reason does not count."""
    assert clock_sites(source, flow)[0] == want
