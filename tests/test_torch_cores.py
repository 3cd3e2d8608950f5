"""Keeps the port's CPU tests off a quarter of the host's cores.

The whole suite runs in several pytest-xdist workers at once, and the JAX
package has wall-clock tests (the fleet query p95 of
tests/test_bench_rungs.py) that fail when every core is busy.  The port's
tests compute with torch, with XLA (their JAX references) and in
subprocesses (the warp simulator, an entry point), each of which would take
every core.  So each port test module holds torch to one intra-op thread at
import, and imports the autouse fixture ``confined_to_port_cores``: while
the module's tests run, every thread of the worker, and every thread or
subprocess it starts, runs on the last three quarters of the cores it may
use.  The first quarter stays for the other workers' tests.
"""

import os
import threading

import pytest

#: the worker's cores before the fixture confined it
_BEFORE: dict[str, set[int]] = {}


def port_cores(allowed: set[int]) -> set[int]:
    """The cores the port's tests may use: all but the lowest quarter of
    ``allowed`` (all of them where a quarter is less than one core)."""
    ordered = sorted(allowed)
    return set(ordered[len(ordered) // 4:])


def _pin_process(cores: set[int]) -> None:
    """Set the affinity of every thread of this process (sched_setaffinity
    on pid 0 would set only the calling thread's)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:  # the thread has exited
            pass


@pytest.fixture(scope="module", autouse=True)
def confined_to_port_cores():
    if not (hasattr(os, "sched_setaffinity") and os.path.isdir("/proc/self/task")):
        yield
        return
    before = _BEFORE["cores"] = os.sched_getaffinity(0)
    _pin_process(port_cores(before))
    try:
        yield
    finally:
        _pin_process(before)


def test_port_cores_leave_the_lowest_quarter():
    assert port_cores(set(range(8))) == set(range(2, 8))
    assert port_cores({5, 1, 9, 3}) == {3, 5, 9}
    assert port_cores({0, 1, 2}) == {0, 1, 2}
    assert port_cores({4}) == {4}


def test_the_fixture_confines_every_thread_of_the_worker():
    if "cores" not in _BEFORE:
        pytest.skip("no per-thread affinity on this host: the fixture confines nothing")
    want = port_cores(_BEFORE["cores"])
    got = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            got[tid] = os.sched_getaffinity(int(tid))
        except OSError:  # the thread has exited
            pass
    assert got and all(cores == want for cores in got.values()), got
    started = []
    thread = threading.Thread(target=lambda: started.append(os.sched_getaffinity(0)))
    thread.start()
    thread.join()
    assert started == [want]
