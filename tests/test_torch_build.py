"""The kernel build and the launch counters under threads, on the CPU.

The serving daemon warms and serves each pool on threads of its own, so
two threads can ask for a kernel that is not built yet at once. Each
library must then be compiled once and loaded once per process (a second
``nvcc`` writing the same temporary file would pull it from under the
first), and the wrappers' launch counters, which ``chip_smoke.py`` reads
as proof that a solve went through a kernel, must not lose a launch.
``nvcc`` and ``ctypes.CDLL`` are stood in for here: a script that sleeps
and then writes its ``-o`` target, and a loader that records its calls.
"""
import sys
import threading
import types

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels import sched_violation as sv_kernel
from repro_torch.kernels import sgs_decode as decode_kernel
from repro_torch.kernels import usl_runtime as usl_kernel

NAMES = ("first", "second")


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in NAMES:
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'library')\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n")
    nvcc.chmod(0o755)
    opened = []

    class FakeCDLL:
        def __init__(self, path):
            opened.append(path)

        def __getattr__(self, attr):
            return types.SimpleNamespace()

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "compiles", {})
    _build.use_build_dir(tmp_path / "build")
    return types.SimpleNamespace(log=log, opened=opened,
                                 build=tmp_path / "build")


def test_concurrent_first_use_compiles_and_loads_once(fake_toolchain):
    threads_per_lib = 4
    start = threading.Barrier(threads_per_lib * len(NAMES))
    got, bound, errors = {}, [], []

    def bind(lib):
        bound.append(lib)

    def use(name, i):
        try:
            start.wait()
            got[name, i] = _build.load(name, bind)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=use, args=(name, i))
               for name in NAMES for i in range(threads_per_lib)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    assert _build.compiles == {name: 1 for name in NAMES}
    assert sorted(fake_toolchain.log.read_text().split()) == sorted(
        str(_build.CSRC / f"{name}.cu") for name in NAMES)
    assert len(fake_toolchain.opened) == len(NAMES)
    assert len(bound) == len(NAMES)
    for name in NAMES:
        libs = {id(got[name, i]) for i in range(threads_per_lib)}
        assert len(libs) == 1
    built = sorted(p.name for p in fake_toolchain.build.iterdir())
    assert not [n for n in built if n.endswith(".tmp.so")]
    assert len([n for n in built if n.endswith(".so")]) == len(NAMES)
    # a second use finds the loaded library: no compile, no load
    _build.load(NAMES[0], bind)
    assert _build.compiles == {name: 1 for name in NAMES}
    assert len(fake_toolchain.opened) == len(NAMES)


def test_build_finds_a_library_built_by_an_earlier_process(fake_toolchain):
    _build.build(*NAMES)
    _build.use_build_dir(fake_toolchain.build)     # forget what was loaded
    _build.load(NAMES[0])
    assert _build.compiles == {name: 1 for name in NAMES}
    assert _build.seconds[NAMES[0]] == 0.0


@pytest.mark.parametrize("wrapper", [decode_kernel.sgs_decode,
                                     sv_kernel.sched_violation,
                                     usl_kernel.usl_runtime],
                         ids=lambda w: w.__name__)
def test_launch_counts_are_exact_under_threads(wrapper, monkeypatch):
    """Each wrapper counts its launches through ``count_launch`` (never a
    bare ``+= 1``), and 8 threads counting at once lose nothing."""
    assert "count_launch" in wrapper.__code__.co_names
    assert "launches" not in wrapper.__code__.co_names
    monkeypatch.setattr(wrapper, "launches", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        per_thread, n = 20000, 8
        start = threading.Barrier(n)

        def launch():
            start.wait()
            for _ in range(per_thread):
                _build.count_launch(wrapper)

        threads = [threading.Thread(target=launch) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == n * per_thread
