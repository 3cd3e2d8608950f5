"""Keeps the port's CPU tests off a quarter of the host's cores, and behind
every other test on the rest.

The whole suite runs in several pytest-xdist workers at once, and the JAX
package has wall-clock tests (the fleet query p95 of
tests/test_bench_rungs.py) that fail when every core is busy.  The port's
tests compute with torch, with XLA (their JAX references) and in
subprocesses (the warp simulator, an entry point), each of which would take
every core.  So each port test module holds torch to one intra-op thread at
import, and imports the autouse fixture ``confined_to_port_cores``: while
the module's tests run, every thread of the worker, and every thread or
subprocess it starts, runs on the last three quarters of the cores it may
use, at the lowest CPU priority (nice 19).  The first quarter stays for the
other workers' tests, and on the rest the scheduler gives a test at the
default priority some seventy times the share of a port thread.  A test
whose closed loop runs against the wall clock takes the ``keep_priority``
fixture: its load generator, starved at nice 19, would miss the loop's
budget, so for that test alone the worker runs at its own priority, on the
last two of its cores only (``loop_cores``), where the loop's busy threads
meet as few of the other workers' threads as they can; it computes on one
torch thread.  Afterwards the fixtures restore the cores and the priority.
Raising a priority back takes CAP_SYS_NICE or an RLIMIT_NICE that allows
it; a process without either keeps its priority throughout and is confined
to the cores alone, so that no later test of the worker runs at nice 19.
"""

import contextlib
import json
import os
import resource
import subprocess
import sys
import threading
from pathlib import Path

import pytest

#: the worker's cores and priority before the fixture confined it
_BEFORE: dict[str, object] = {}
#: the priority the port's tests run at: the lowest
PORT_NICE = 19
#: the capability that lets a thread raise its priority (linux/capability.h)
CAP_SYS_NICE = 23


def port_cores(allowed: set[int]) -> set[int]:
    """The cores the port's tests may use: all but the lowest quarter of
    ``allowed`` (all of them where a quarter is less than one core)."""
    ordered = sorted(allowed)
    return set(ordered[len(ordered) // 4:])


def loop_cores(allowed: set[int]) -> set[int]:
    """The cores a wall-clock closed loop runs on: the last two of
    ``allowed`` (all of them where it has fewer)."""
    return set(sorted(allowed)[-2:])


def _each_thread(fn) -> None:
    """``fn(tid)`` for every thread of this process (sched_setaffinity and
    setpriority on pid 0 reach only the calling thread)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            fn(int(tid))
        except ProcessLookupError:  # the thread has exited
            pass


def _pin_process(cores: set[int]) -> None:
    _each_thread(lambda tid: os.sched_setaffinity(tid, cores))


def _renice_process(nice: int) -> None:
    """Set every thread's nice value."""
    _each_thread(lambda tid: os.setpriority(os.PRIO_PROCESS, tid, nice))


def may_restore_priority(nice: int) -> bool:
    """Whether this process may raise its threads back to ``nice`` once it
    has lowered them: RLIMIT_NICE allows nice values down to 20 - limit,
    and CAP_SYS_NICE any."""
    limit = resource.getrlimit(resource.RLIMIT_NICE)[0]
    if limit == resource.RLIM_INFINITY or 20 - limit <= nice:
        return True
    status = Path("/proc/self/status").read_text()
    effective = next(ln.split()[1] for ln in status.splitlines() if ln.startswith("CapEff:"))
    return bool(int(effective, 16) >> CAP_SYS_NICE & 1)


def port_nice(nice: int, keep_priority: bool, may_restore: bool = True) -> int:
    """The nice value a port module's tests run at, from the worker's."""
    return nice if keep_priority or not may_restore else max(nice, PORT_NICE)


@contextlib.contextmanager
def confined():
    """Confine every thread of this process (and what it starts) to the
    port's cores and priority, and restore both on exit."""
    before = _BEFORE["cores"] = os.sched_getaffinity(0)
    nice = _BEFORE["nice"] = os.getpriority(os.PRIO_PROCESS, 0)
    low = port_nice(nice, False, may_restore_priority(nice))
    _pin_process(port_cores(before))
    if low != nice:
        _renice_process(low)
    try:
        yield
    finally:
        if low != nice:
            _renice_process(nice)
        _pin_process(before)


@contextlib.contextmanager
def at_worker_priority():
    """Inside ``confined``: every thread on ``loop_cores`` of the worker's
    cores at the worker's own priority, which ``confined`` lowered only
    where it may be raised again; the confinement comes back on exit."""
    cores, low = os.sched_getaffinity(0), os.getpriority(os.PRIO_PROCESS, 0)
    nice = port_nice(_BEFORE["nice"], True)
    _pin_process(loop_cores(_BEFORE["cores"]))
    if nice != low:
        _renice_process(nice)
    try:
        yield
    finally:
        if nice != low:
            _renice_process(low)
        _pin_process(cores)


@pytest.fixture(scope="module", autouse=True)
def confined_to_port_cores():
    if not (hasattr(os, "sched_setaffinity") and os.path.isdir("/proc/self/task")):
        yield
        return
    with confined():
        yield


@pytest.fixture
def keep_priority(confined_to_port_cores):
    """For one test whose closed loop runs against the wall clock."""
    if "cores" not in _BEFORE:  # no per-thread affinity: nothing was confined
        yield
        return
    with at_worker_priority():
        yield


def test_port_modules_drop_to_the_lowest_priority_unless_they_keep_it():
    assert port_nice(0, keep_priority=False) == PORT_NICE
    assert port_nice(0, keep_priority=True) == 0
    assert port_nice(PORT_NICE, keep_priority=True) == PORT_NICE  # never raised
    # a process that could not raise its priority again keeps it
    assert port_nice(0, keep_priority=False, may_restore=False) == 0


def test_port_cores_leave_the_lowest_quarter():
    assert port_cores(set(range(8))) == set(range(2, 8))
    assert port_cores({5, 1, 9, 3}) == {3, 5, 9}
    assert port_cores({0, 1, 2}) == {0, 1, 2}
    assert port_cores({4}) == {4}


def test_the_fixture_confines_every_thread_of_the_worker():
    if "cores" not in _BEFORE:
        pytest.skip("no per-thread affinity on this host: the fixture confines nothing")
    want = port_cores(_BEFORE["cores"])
    want_nice = port_nice(_BEFORE["nice"], False, may_restore_priority(_BEFORE["nice"]))
    got = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            got[tid] = (os.sched_getaffinity(int(tid)), os.getpriority(os.PRIO_PROCESS, int(tid)))
        except OSError:  # the thread has exited
            pass
    assert got and all(v == (want, want_nice) for v in got.values()), got
    started = []
    thread = threading.Thread(
        target=lambda: started.append((os.sched_getaffinity(0), os.getpriority(os.PRIO_PROCESS, 0)))
    )
    thread.start()
    thread.join()
    assert started == [(want, want_nice)]


def test_a_subprocess_of_the_worker_inherits_the_low_priority():
    if "nice" not in _BEFORE:
        pytest.skip("no per-thread affinity on this host: the fixture confines nothing")
    out = subprocess.run(
        [sys.executable, "-c", "import os; print(os.getpriority(os.PRIO_PROCESS, 0))"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    assert int(out) == port_nice(_BEFORE["nice"], False, may_restore_priority(_BEFORE["nice"]))


# A worker that runs a lowered port module and then, inside another, a test
# that keeps its priority: that test must run at the worker's own priority,
# and the module's next test lowered again.  It runs in a subprocess,
# started at the worker's priority, as it is or as an unprivileged user (uid
# 65534), which has no CAP_SYS_NICE and the default RLIMIT_NICE of 0 and so
# may not raise its priority again.
_SEQUENCE = """
import json, os, sys
from tests.test_torch_cores import at_worker_priority, confined, may_restore_priority
os.setpriority(os.PRIO_PROCESS, 0, int(sys.argv[1]))
if sys.argv[2] == "unprivileged" and os.geteuid() == 0:
    os.setgid(65534)
    os.setuid(65534)
before = os.getpriority(os.PRIO_PROCESS, 0)
with confined():
    lowered = os.getpriority(os.PRIO_PROCESS, 0)
with confined():
    with at_worker_priority():
        kept = os.getpriority(os.PRIO_PROCESS, 0)
    assert os.getpriority(os.PRIO_PROCESS, 0) == lowered
print(json.dumps([before, lowered, kept, may_restore_priority(before)]))
"""


@pytest.mark.parametrize("user", ["as_is", "unprivileged"])
def test_a_module_that_keeps_its_priority_after_a_lowered_one_runs_at_the_worker_s(user):
    if "nice" not in _BEFORE:
        pytest.skip("no per-thread affinity on this host: the fixture confines nothing")
    out = subprocess.run(
        [sys.executable, "-c", _SEQUENCE, str(_BEFORE["nice"]), user],
        capture_output=True, text=True, check=True, timeout=60,
        cwd=Path(__file__).resolve().parent.parent,
    ).stdout
    before, lowered, kept, may_restore = json.loads(out)
    assert before == _BEFORE["nice"]
    assert lowered == port_nice(before, False, may_restore)
    assert kept == before


def test_loop_cores_are_the_last_two():
    assert loop_cores(set(range(8))) == {6, 7}
    assert loop_cores({5, 1, 9, 3}) == {5, 9}
    assert loop_cores({4}) == {4}


def test_a_test_that_keeps_its_priority_runs_on_the_loop_cores_at_the_worker_s(keep_priority):
    if "nice" not in _BEFORE:
        pytest.skip("no per-thread affinity on this host: the fixture confines nothing")
    got = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            got[tid] = (os.sched_getaffinity(int(tid)), os.getpriority(os.PRIO_PROCESS, int(tid)))
        except OSError:  # the thread has exited
            pass
    want = (loop_cores(_BEFORE["cores"]), _BEFORE["nice"])
    assert got and all(v == want for v in got.values()), got
