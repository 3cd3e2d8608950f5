"""The race harness (``control/race_harness.py``), the shard-rules fan-out
it drives (``metrics/federation.py``) and the ``races`` scenario against
the JAX package's.

- ``run_race_sweep`` at seeds 0 and 7 and 2 and 4 schedules: JAX's result
  dict, the serial fingerprint and every run's completion orders included;
  the break-ordering canary fails in both packages with the same result.
- The lock discipline: ``ShimPool`` keeps submission order,
  ``LockCheckedDict`` and ``install_lock_assertions`` raise on an access
  without the lock and restore what the run accumulated; the inferred
  lockset of the port's ``obs/coverage.py`` is JAX's of its own.
- The fan-out: a plane's shard rules evaluated on the pool, serially and
  through the fallback (an evaluator with a tracer) leave the shard DBs
  JAX's, and each mode hits JAX's ``concurrency:*`` probe.
- The CLI: ``simulate --scenario races`` exits 0 and prints PASS; with
  ``--break-ordering`` it exits 2 and prints DIVERGED, as JAX's does.
- ``run_coverage("races")``: JAX's bytes, the concurrency domain at 1.0.

Tolerance: exact (virtual time throughout).
"""

import hashlib
import json
import random
import threading

import pytest
import torch

from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.analysis.concurrency import infer_guarded_fields as jax_infer
from k8s_gpu_hpa_tpu.control import race_harness as jax_races
from k8s_gpu_hpa_tpu.control import scale_harness as jax_scale
from k8s_gpu_hpa_tpu.metrics import federation as jax_federation
from k8s_gpu_hpa_tpu.obs import Tracer as JaxTracer
from k8s_gpu_hpa_tpu.obs import coverage as jax_coverage
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxClock
from k8s_gpu_hpa_tpu_torch import perfgates, simulate
from k8s_gpu_hpa_tpu_torch.__main__ import main as umbrella_main
from k8s_gpu_hpa_tpu_torch.analysis import REPO_ROOT
from k8s_gpu_hpa_tpu_torch.analysis.concurrency import infer_guarded_fields
from k8s_gpu_hpa_tpu_torch.control import race_harness as races
from k8s_gpu_hpa_tpu_torch.control import scale_harness
from k8s_gpu_hpa_tpu_torch.metrics import federation
from k8s_gpu_hpa_tpu_torch.obs import Tracer, coverage
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


# ---- the sweep -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("schedules", [2, 4])
def test_the_sweep_is_jax_s(seed, schedules):
    port = races.run_race_sweep(seed=seed, schedules=schedules)
    ref = jax_races.run_race_sweep(seed=seed, schedules=schedules)
    assert port["ok"] and ref["ok"]
    assert port["serial_fingerprint"] == ref["serial_fingerprint"]
    assert [r["orders"] for r in port["runs"]] == [r["orders"] for r in ref["runs"]]
    assert _dump(port) == _dump(ref)
    # the shim permuted: not every completion order is the serial one
    assert any(o != sorted(o) for r in port["runs"] for o in r["orders"])


def test_the_default_sweep_is_perfgates_and_jax_s():
    port = races.run_race_sweep()
    assert (port["schedules"], port["shards"], port["targets"], port["ticks"]) == (
        perfgates.RACE_SWEEP_SCHEDULES, perfgates.RACE_SWEEP_SHARDS,
        perfgates.RACE_SWEEP_TARGETS, perfgates.RACE_SWEEP_TICKS)
    assert port["serial_fingerprint"].startswith("54cda6645930cacb")
    assert port["threads"]["match"]
    assert _dump(port) == _dump(jax_races.run_race_sweep())


def test_the_ordering_canary_fails_in_both_packages():
    port = races.run_race_sweep(seed=7, break_ordering=True)
    ref = jax_races.run_race_sweep(seed=7, break_ordering=True)
    assert not port["ok"] and not ref["ok"]
    assert port["divergent"] and port["threads"] is None
    assert _dump(port) == _dump(ref)
    assert "DIVERGED" in races.render_race_report(port)
    assert races.render_race_report(port) == jax_races.render_race_report(ref)


# ---- the lock discipline ---------------------------------------------------------


def test_the_shim_pool_keeps_submission_order():
    pool = races.ShimPool(random.Random("t"))
    ref = jax_races.ShimPool(random.Random("t"))
    assert pool.map(lambda x: x * 10, range(6)) == [0, 10, 20, 30, 40, 50]
    ref.map(lambda x: x * 10, range(6))
    assert pool.orders == ref.orders and sorted(pool.orders[0]) == list(range(6))
    assert races.ShimPool._max_workers == jax_races.ShimPool._max_workers


def test_a_lock_checked_dict_refuses_access_without_its_lock():
    lock = races.InstrumentedLock(threading.Lock())
    d = races.LockCheckedDict({"a": 1}, lock, "test.d")
    with pytest.raises(races.LockDisciplineError):
        d["b"] = 2
    with pytest.raises(races.LockDisciplineError):
        d.get("a")
    with lock:
        d["b"] = 2
        assert d.get("b") == 2
    assert not lock.held_by_me()


def test_the_armed_lockset_raises_and_restores_what_the_run_accumulated():
    cmap = coverage.CoverageMap("test")
    pid = "concurrency:race_schedule_serial"
    restore = races.install_lock_assertions(cmap)
    assert isinstance(cmap.counts, races.LockCheckedDict)
    cmap.record(pid)  # record() takes the instrumented lock itself
    with pytest.raises(races.LockDisciplineError):
        cmap.counts[pid] = 99
    with pytest.raises(races.LockDisciplineError):
        cmap.first_hit_ts.get(pid)
    restore()
    assert type(cmap.counts) is dict and type(cmap.first_hit_ts) is dict
    assert cmap.counts[pid] == 1 and pid in cmap.first_hit_ts


def test_the_inferred_lockset_of_the_coverage_map_is_jax_s():
    port = infer_guarded_fields(REPO_ROOT / "k8s_gpu_hpa_tpu_torch" / "obs" / "coverage.py",
                                REPO_ROOT)
    ref = jax_infer(REPO_ROOT / "k8s_gpu_hpa_tpu" / "obs" / "coverage.py", REPO_ROOT)
    assert port == ref
    for field in ("counts", "first_hit_ts", "first_hit_span"):
        assert port[("CoverageMap", field)] == "_lock"


# ---- the fan-out -----------------------------------------------------------------


def _plane(fed, scale, clock_cls, tracer_cls, mode):
    clock = clock_cls()
    plane = fed.ShardedScrapePlane(clock, shards=4, interval=1.0)
    for i in range(12):
        plane.add_target(scale._synthetic_fetch(i), name=f"synt-{i:04d}", job="fleet")
    if fed is federation:
        plane.add_shard_rules(scale.fleet_shard_rules)
    else:
        plane.add_shard_rules(scale.fleet_shard_rules, interval=1.0)
    if mode == "serial":
        plane.parallel_rules = False
    elif mode == "fallback":
        plane.shard_evaluators[0].tracer = tracer_cls(clock)
    return clock, plane


@pytest.mark.parametrize("mode,probe", [
    ("parallel", "concurrency:shard_rules_parallel"),
    ("serial", "concurrency:shard_rules_serial_fallback"),
    ("fallback", "concurrency:shard_rules_serial_fallback"),
])
def test_each_evaluation_mode_records_jax_s_values(mode, probe):
    got = []
    for fed, scale, clock_cls, tracer_cls, cov, fingerprint in (
        (federation, scale_harness, VirtualClock, Tracer, coverage, races._fingerprint),
        (jax_federation, jax_scale, JaxClock, JaxTracer, jax_coverage, jax_races._fingerprint),
    ):
        clock, plane = _plane(fed, scale, clock_cls, tracer_cls, mode)
        with cov.collect("fan-out") as cmap:
            evals = 0
            for _ in range(6):
                clock.advance(1.0)
                plane.scrape_once()
                evals += plane.evaluate_rules_once()
        if plane._rule_pool is not None:
            plane._rule_pool.shutdown(wait=True)
        export = cmap.export()
        hits = {pid: rec["count"] for pid, rec in export["probes"].items()
                if pid.startswith("concurrency:shard_rules")}
        got.append((evals, fingerprint(plane, []), hits))
    assert got[0] == got[1]
    assert got[0][2][probe] == 6
    assert (got[0][0], got[0][1]) == (got[1][0], got[1][1])
    # every mode leaves the same shard DBs: the serial loop's
    if mode != "serial":
        clock, plane = _plane(federation, scale_harness, VirtualClock, Tracer, "serial")
        for _ in range(6):
            clock.advance(1.0)
            plane.scrape_once()
            plane.evaluate_rules_once()
        assert races._fingerprint(plane, []) == got[0][1]


def test_the_pool_is_rebuilt_when_it_has_fewer_workers_than_shards():
    clock, plane = _plane(federation, scale_harness, VirtualClock, Tracer, "parallel")
    small = races.ShimPool(random.Random(0))
    small._max_workers = 1
    plane._rule_pool = small
    clock.advance(1.0)
    plane.scrape_once()
    plane.evaluate_rules_once()
    assert plane._rule_pool is not small
    assert plane._rule_pool._max_workers == 4
    plane._rule_pool.shutdown(wait=True)


# ---- the scenario and its coverage run ------------------------------------------------


@pytest.mark.parametrize("flags,code,says", [
    ([], 0, "PASS: all schedules bit-identical to serial"),
    (["--break-ordering"], 2, "DIVERGED"),
])
def test_the_races_command_exits_as_jax_s(flags, code, says, capsys):
    argv = ["simulate", "--scenario", "races", "--seed", "7", "--schedules", "2", *flags]
    assert umbrella_main(argv) == code
    out = capsys.readouterr().out
    assert says in out
    ref = jax_races.run_race_sweep(seed=7, schedules=2, break_ordering=bool(flags))
    assert out.strip() == jax_races.render_race_report(ref)


def test_the_races_coverage_run_is_jax_s_bytes():
    port = simulate.run_coverage("races")
    ref = jax_simulate.run_coverage("races")
    assert _dump(port) == _dump(ref)
    assert port["domains"]["concurrency"]["ratio"] == 1.0
    digest = hashlib.sha256(_dump(port).encode()).hexdigest()
    assert digest == "da406d54d6b317cba7263a1dc7ad8c08be4c2e233c784ffa671af371538668af"


def test_the_chip_phase_holds_jax_s_digests():
    """``chip_smoke.py``'s races phase holds the card's runs to these:
    JAX's, recomputed here from the JAX package."""
    import chip_smoke

    def digest(obj):
        return hashlib.sha256(_dump(obj).encode()).hexdigest()

    assert chip_smoke.RACES_EXPECTED == {
        "race_sweep": digest(jax_races.run_race_sweep()),
        "race_canary": digest(jax_races.run_race_sweep(seed=7, break_ordering=True)),
        "coverage_races": digest(jax_simulate.run_coverage("races")),
    }
