"""Deterministic-interleaving race harness: the dynamic half of the
concurrency plane.

Counterpart of ``k8s_gpu_hpa_tpu/control/race_harness.py``.  The
concurrency passes (``analysis/concurrency.py``) prove lockset and escape
properties statically; this module attacks the same invariant, that
``ShardedScrapePlane.evaluate_rules_once`` commutes with schedule order,
dynamically: a seeded scheduling shim replaces the shard-rules pool and
enumerates completion orders deterministically.  One serial reference run
plus N permuted schedules (plus one run on a real ``ThreadPoolExecutor``)
must produce bit-identical shard DBs; any divergence is a real ordering
dependence and the harness reports it.

Two extra teeth:

- **instrumented lockset** (``debug_locks``, default on): the statically
  inferred lockset of the port's ``obs/coverage.py``
  (``infer_guarded_fields``, the map the lockset pass derives, so the
  static and dynamic claims cannot drift) is armed at runtime: the
  ``CoverageMap`` lock is wrapped in an owner-tracking
  :class:`InstrumentedLock` and every guarded dict in a
  :class:`LockCheckedDict` that raises :class:`LockDisciplineError` on any
  access without the lock held, from the harness's pool threads too.
- **canary ordering** (``break_ordering``, test-only): each shard
  evaluator appends its shard index to a shared trace folded into the
  fingerprint.  The trace depends on order by construction, so the harness
  provably fails on code whose output depends on the schedule.

Run as ``python -m k8s_gpu_hpa_tpu_torch simulate --scenario races``.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
from pathlib import Path

from k8s_gpu_hpa_tpu_torch import perfgates
from k8s_gpu_hpa_tpu_torch.control.scale_harness import _synthetic_fetch, fleet_shard_rules
from k8s_gpu_hpa_tpu_torch.metrics.federation import ShardedScrapePlane
from k8s_gpu_hpa_tpu_torch.obs import coverage
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

REPO_ROOT = Path(__file__).resolve().parents[2]


class LockDisciplineError(AssertionError):
    """A guarded field was accessed without its inferred lock held."""


class InstrumentedLock:
    """Wraps a real lock with owner tracking so guarded structures can
    assert "my lock is held by the current thread" on every access."""

    def __init__(self, inner):
        self._inner = inner
        self._owner: int | None = None

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self):
        self._owner = None
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()


class LockCheckedDict(dict):
    """A dict that raises :class:`LockDisciplineError` on any mutation (or
    read) performed without the instrumented lock held — the runtime
    enforcement of the statically inferred lockset."""

    def __init__(self, data, lock: InstrumentedLock, label: str):
        super().__init__(data)
        self._lock = lock
        self._label = label

    def _assert_held(self) -> None:
        if not self._lock.held_by_me():
            raise LockDisciplineError(
                f"{self._label} accessed without its inferred lock held "
                "(thread "
                f"{threading.current_thread().name}) — the static lockset "
                "says every access site takes the lock; this one did not"
            )

    def __getitem__(self, key):
        self._assert_held()
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._assert_held()
        return super().get(key, default)

    def __setitem__(self, key, value):
        self._assert_held()
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._assert_held()
        super().__delitem__(key)

    def update(self, *args, **kwargs):
        self._assert_held()
        super().update(*args, **kwargs)

    def setdefault(self, key, default=None):
        self._assert_held()
        return super().setdefault(key, default)

    def pop(self, *args):
        self._assert_held()
        return super().pop(*args)

    def popitem(self):
        self._assert_held()
        return super().popitem()

    def clear(self):
        self._assert_held()
        super().clear()


def install_lock_assertions(cmap):
    """Arm the inferred lockset of the port's obs/coverage.py on ``cmap``: wrap its
    lock in an :class:`InstrumentedLock` and every statically lock-guarded
    dict field in a :class:`LockCheckedDict`.  Returns a restore() closure
    that puts plain structures back (preserving accumulated content)."""
    from k8s_gpu_hpa_tpu_torch.analysis.concurrency import infer_guarded_fields

    inferred = infer_guarded_fields(
        REPO_ROOT / "k8s_gpu_hpa_tpu_torch" / "obs" / "coverage.py", REPO_ROOT
    )
    guarded = {
        attr: lock
        for (cls, attr), lock in sorted(inferred.items())
        if cls == "CoverageMap"
    }
    if not guarded:
        raise LockDisciplineError(
            "static analysis inferred no guarded CoverageMap fields — the "
            "lockset the harness is supposed to assert has vanished"
        )
    lock_attr = sorted(set(guarded.values()))[0]
    original_lock = getattr(cmap, lock_attr)
    ilock = InstrumentedLock(original_lock)
    setattr(cmap, lock_attr, ilock)
    wrapped: list[str] = []
    for attr in guarded:
        value = getattr(cmap, attr)
        if isinstance(value, dict):
            setattr(
                cmap, attr, LockCheckedDict(value, ilock, f"CoverageMap.{attr}")
            )
            wrapped.append(attr)

    def restore() -> None:
        for attr in wrapped:
            # plain dict again, KEEPING whatever the run accumulated
            setattr(cmap, attr, dict(getattr(cmap, attr)))
        setattr(cmap, lock_attr, original_lock)

    return restore


class ShimPool:
    """Deterministic stand-in for the shard-rules ThreadPoolExecutor: runs
    every task on the calling thread in a seeded-permutation order, while
    returning results in submission order (exactly ``Executor.map``'s
    contract).  Installed via ``plane._rule_pool = ShimPool(rng)``."""

    # evaluate_rules_once replaces pools with fewer workers than shards;
    # advertise effectively-infinite capacity so the shim survives
    _max_workers = 1 << 30

    def __init__(self, rng: random.Random):
        self._rng = rng
        self.orders: list[list[int]] = []

    def map(self, fn, iterable):
        items = list(iterable)
        order = list(range(len(items)))
        self._rng.shuffle(order)
        self.orders.append(list(order))
        results: list = [None] * len(items)
        for i in order:
            results[i] = fn(items[i])
        return results

    def shutdown(self, wait: bool = True, cancel_futures: bool = False) -> None:
        pass


# ---- plane construction / driving ------------------------------------------


def _build_plane(shards: int, targets: int):
    clock = VirtualClock()
    plane = ShardedScrapePlane(clock, shards=shards, interval=1.0)
    for i in range(targets):
        plane.add_target(_synthetic_fetch(i), name=f"synt-{i:04d}", job="fleet")
    plane.add_shard_rules(fleet_shard_rules)
    return clock, plane


def _drive(clock, plane, ticks: int) -> int:
    evals = 0
    for _ in range(ticks):
        clock.advance(1.0)
        plane.scrape_once()
        evals += plane.evaluate_rules_once()
    return evals


def _arm_canary(plane) -> list[int]:
    """Test-only ordering break: each shard evaluation appends its shard
    index to a shared trace folded into the fingerprint, making the output
    schedule-dependent by construction."""
    trace: list[int] = []
    for idx, ev in enumerate(plane.shard_evaluators):
        if ev is None:
            continue

        def wrapped(_orig=ev.evaluate_once, _idx=idx):
            trace.append(_idx)
            return _orig()

        ev.evaluate_once = wrapped
    return trace


def _fingerprint(plane, canary_trace: list[int]) -> str:
    """sha256 over a canonical JSON snapshot of every shard DB (series
    name, labels, (ts, value) points — origin span ids excluded: they are
    allocation order, not data) plus the canary trace."""
    snapshot = []
    for shard, db in enumerate(plane.shard_dbs):
        series = []
        for name in sorted(db.series_names()):
            for s in sorted(db.series_for(name), key=lambda s: s.labels):
                series.append(
                    [
                        name,
                        [list(kv) for kv in s.labels],
                        [[ts, value] for ts, value, _origin in s.points],
                    ]
                )
        snapshot.append([shard, series])
    payload = json.dumps(
        {"shards": snapshot, "canary": list(canary_trace)},
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()


# ---- the sweep -------------------------------------------------------------


def run_race_sweep(
    schedules: int | None = None,
    seed: int = 0,
    shards: int | None = None,
    targets: int | None = None,
    ticks: int | None = None,
    break_ordering: bool = False,
    debug_locks: bool = True,
) -> dict:
    """Serial reference + N seeded permuted schedules (+ one real-thread
    schedule) of the shard-rules fan-out; returns a deterministic report
    whose ``ok`` is True iff every schedule's shard-DB fingerprint is
    bit-identical to serial and no lock-discipline violation fired."""
    schedules = perfgates.RACE_SWEEP_SCHEDULES if schedules is None else schedules
    shards = perfgates.RACE_SWEEP_SHARDS if shards is None else shards
    targets = perfgates.RACE_SWEEP_TARGETS if targets is None else targets
    ticks = perfgates.RACE_SWEEP_TICKS if ticks is None else ticks

    lock_violations = 0
    restore = None
    scratch_active = False
    if debug_locks:
        cmap = coverage.active()
        if cmap is None:
            # no collector running: arm a scratch map so the assertions
            # still exercise every coverage.hit() on the rule path
            cmap = coverage.activate(coverage.CoverageMap("race-harness"))
            scratch_active = True
        restore = install_lock_assertions(cmap)
        coverage.hit("concurrency:lockset_assert_armed")

    def one_run(schedule: str):
        nonlocal lock_violations
        clock, plane = _build_plane(shards, targets)
        if schedule == "serial":
            plane.parallel_rules = False
        elif schedule.startswith("shim"):
            plane._rule_pool = ShimPool(
                random.Random(f"{seed}:{schedule}")
            )
        trace = _arm_canary(plane) if break_ordering else []
        try:
            _drive(clock, plane, ticks)
        except LockDisciplineError:
            lock_violations += 1
            return "lock-discipline-violation", plane, trace
        finally:
            pool = plane._rule_pool
            if pool is not None and not isinstance(pool, ShimPool):
                pool.shutdown(wait=True)
        return _fingerprint(plane, trace), plane, trace

    try:
        coverage.hit("concurrency:race_schedule_serial")
        serial_fp, _plane, _trace = one_run("serial")

        runs = []
        for s in range(schedules):
            coverage.hit("concurrency:race_schedule_permuted")
            fp, plane, _trace = one_run(f"shim-{s}")
            pool = plane._rule_pool
            runs.append(
                {
                    "schedule": f"shim-{s}",
                    "orders": pool.orders if isinstance(pool, ShimPool) else [],
                    "fingerprint": fp,
                    "match": fp == serial_fp,
                }
            )

        threads_report = None
        if not break_ordering:
            # end-to-end smoke on a real pool; skipped under the canary
            # because real-thread append order is genuinely nondeterministic
            fp, _plane, _trace = one_run("threads")
            threads_report = {"fingerprint": fp, "match": fp == serial_fp}
    finally:
        if restore is not None:
            restore()
        if scratch_active:
            coverage.deactivate()

    divergent = [r["schedule"] for r in runs if not r["match"]]
    if threads_report is not None and not threads_report["match"]:
        divergent.append("threads")
    return {
        "seed": seed,
        "schedules": schedules,
        "shards": shards,
        "targets": targets,
        "ticks": ticks,
        "break_ordering": break_ordering,
        "debug_locks": debug_locks,
        "serial_fingerprint": serial_fp,
        "runs": runs,
        "threads": threads_report,
        "divergent": divergent,
        "lock_violations": lock_violations,
        "ok": not divergent and lock_violations == 0,
    }


def render_race_report(result: dict) -> str:
    lines = [
        "race sweep — deterministic-interleaving check of the shard-rules "
        "fan-out",
        f"  seed={result['seed']} shards={result['shards']} "
        f"targets={result['targets']} ticks={result['ticks']} "
        f"debug_locks={'on' if result['debug_locks'] else 'off'}"
        + (" BREAK-ORDERING" if result["break_ordering"] else ""),
        f"  serial    {result['serial_fingerprint'][:16]}…  (reference)",
    ]
    for run in result["runs"]:
        mark = "ok " if run["match"] else "DIVERGED"
        lines.append(
            f"  {run['schedule']:<9} {run['fingerprint'][:16]}…  {mark}"
        )
    if result["threads"] is not None:
        mark = "ok " if result["threads"]["match"] else "DIVERGED"
        lines.append(
            f"  threads   {result['threads']['fingerprint'][:16]}…  {mark}"
        )
    if result["lock_violations"]:
        lines.append(
            f"  lock-discipline violations: {result['lock_violations']}"
        )
    lines.append(
        "  PASS: all schedules bit-identical to serial"
        if result["ok"]
        else "  FAIL: evaluation order leaked into the merged result "
        f"(divergent: {', '.join(result['divergent']) or 'lock discipline'})"
    )
    return "\n".join(lines)
