"""The region evacuation (``chaos/evacuate.py``), the global control plane
(``control/region.py``), the three fleet fault kinds and the ``evacuate``
scenario against the JAX package's.

- ``run_region_evacuation()`` of each package, the full run, the smoke run
  and the canary (spilling off), each run once a module: the same result
  as sorted JSON with ``objstore.bytes`` left out (JAX's own byte count
  follows PYTHONHASHSEED; in one process both packages give the same), the
  same fingerprint, report and ``--why`` chain.
- ``evaluate_evacuation_contract`` on doctored results, a clause at a time
  (test_evacuate.py's cases): the violation fires, in JAX's words.
- The committed tests/scenarios/evac-smoke.json replays through the port;
  another kind of artifact is refused; the four exit codes of ``simulate
  --scenario evacuate`` through the port's umbrella.
- ``FAULT_KINDS`` has JAX's keys; the fleet kinds refuse a pipeline outside
  a region in JAX's words; a kill and a recovery on a region with an
  autoscaler leave the cluster as JAX's do; ``RecoveryReport.region`` shows
  only when set.
- ``trial.region_evacuation_rung()`` is bench.py's rung key for key, and the
  EVAC_* gates are JAX's.

Tolerance: exact (virtual time throughout).
"""

import copy
import json
from pathlib import Path

import pytest
import torch

import bench
from k8s_gpu_hpa_tpu import perfgates as jax_perfgates
from k8s_gpu_hpa_tpu.chaos import evacuate as jax_evacuate
from k8s_gpu_hpa_tpu.chaos import faults as jax_faults
from k8s_gpu_hpa_tpu.chaos.schedule import RecoveryReport as JaxReport
from k8s_gpu_hpa_tpu.control import region as jax_region
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxClock
import k8s_gpu_hpa_tpu_torch.__main__ as cli
from k8s_gpu_hpa_tpu_torch import chaos, perfgates, trial
from k8s_gpu_hpa_tpu_torch.chaos import evacuate, faults
from k8s_gpu_hpa_tpu_torch.chaos.schedule import RecoveryReport
from k8s_gpu_hpa_tpu_torch.control import region
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

SCENARIO = Path(__file__).resolve().parent / "scenarios" / "evac-smoke.json"

RUNS = {
    "full": {},
    "smoke": {"smoke": True},
    "canary": {"spill_enabled": False, "smoke": True},
}


@pytest.fixture(scope="module")
def results():
    """Each run of each package once: {run: (port, jax)}."""
    return {
        name: (evacuate.run_region_evacuation(**kw), jax_evacuate.run_region_evacuation(**kw))
        for name, kw in RUNS.items()
    }


def _without_bytes(result: dict) -> str:
    out = copy.deepcopy(result)
    del out["objstore"]["bytes"]
    return json.dumps(out, sort_keys=True)


@pytest.mark.parametrize("run", list(RUNS))
def test_the_evacuation_is_jax_s_as_sorted_json(results, run):
    port, ref = results[run]
    assert _without_bytes(port) == _without_bytes(ref)
    assert evacuate.evacuation_fingerprint(port) == jax_evacuate.evacuation_fingerprint(ref)
    assert evacuate.render_evacuation_report(port) == jax_evacuate.render_evacuation_report(ref)
    for tenant in ("tpu-prod", "tpu-batch", "eu-local"):
        assert evacuate.render_evacuation_why(port, tenant) == jax_evacuate.render_evacuation_why(
            ref, tenant)
    assert evacuate.build_evacuation_artifact(run, port) == jax_evacuate.build_evacuation_artifact(
        run, ref)


@pytest.mark.parametrize("run,fingerprint,generations", [
    ("full", "crc32:38f93eee", {"us": 25, "eu": 33, "ap": 31}),
    ("smoke", "crc32:8a4db88e", {"us": 19, "eu": 23, "ap": 21}),
])
def test_the_runs_keep_the_contract_with_jax_s_outcome(results, run, fingerprint, generations):
    port, _ = results[run]
    assert port["ok"] is True and port["violations"] == []
    assert evacuate.evacuation_fingerprint(port) == fingerprint
    assert port["evacuations"][0]["tenant_ttc_s"] == {"tpu-prod": 15.0, "tpu-batch": 75.0}
    assert port["spills"] == {"admitted": 3, "denied": 4}
    assert port["exchange"]["generations"] == generations
    assert port["global"]["bit_identical"] is True
    assert port["global"]["fingerprint"] == "crc32:51c97f39:3568"
    assert port["all_recovered"] is True


def test_the_store_s_bytes_are_jax_s_in_one_process(results):
    """The byte count moves with PYTHONHASHSEED in both packages, and the
    same way: inside one process they agree."""
    for port, ref in results.values():
        assert port["objstore"]["bytes"] == ref["objstore"]["bytes"]


def test_the_smoke_run_is_deterministic(results):
    again = evacuate.run_region_evacuation(smoke=True)
    assert _without_bytes(again) == _without_bytes(results["smoke"][0])


def test_prod_reconverges_tighter_than_batch(results):
    port, _ = results["smoke"]
    evac = port["evacuations"][0]
    by_band = {band: max(ttc for t, ttc in evac["tenant_ttc_s"].items() if port["bands"][t] == band)
               for band in ("prod", "batch")}
    assert by_band["prod"] < by_band["batch"]
    assert by_band["prod"] <= perfgates.EVAC_PROD_TTC_MAX_S
    assert by_band["batch"] <= perfgates.EVAC_BATCH_TTC_MAX_S
    assert perfgates.EVAC_PROD_TTC_MAX_S < perfgates.EVAC_BATCH_TTC_MAX_S


def test_the_canary_fails_the_contract_as_jax_s(results):
    port, ref = results["canary"]
    assert port["ok"] is False and len(port["violations"]) == 5
    assert port["violations"] == ref["violations"]
    assert any("never reconverged" in v for v in port["violations"])
    assert port["spills"] == {"admitted": 0, "denied": 26}


@pytest.mark.parametrize(
    "doctor, expect_fragment",
    [
        (lambda r: r["evacuations"][0]["tenant_ttc_s"].update({"tpu-prod": 1e9}), "over the"),
        (lambda r: r["evacuations"][0]["tenant_ttc_s"].pop("tpu-prod"), "never reconverged"),
        (lambda r: r["audits"].update(alive_conserved=False, alive_violations=["t=1: us leaked"]),
         "conservation broken"),
        (lambda r: r["regions"]["eu"]["tenants"]["eu-local"].update({"max_pending_stint_s": 1e9}),
         "starved"),
        (lambda r: r["regions"]["eu"]["mirror_replicas"].update({"tpu-prod-evac": 2}),
         "never drained home"),
        (lambda r: r.update(all_recovered=False), "not every fault"),
        (lambda r: r["global"].update(bit_identical=False), "diverged from the merged reference"),
        (lambda r: r.update(decisions=[d for d in r["decisions"] if d["tenant"] != "tpu-prod"]),
         "no admitted cross-region spill decision"),
        (lambda r: r["spills"].update(admitted=0), "no spill was ever admitted"),
        (lambda r: r["spills"].update(denied=0), "no spill was ever denied"),
        (lambda r: r["objstore"].update(outage_errors=0), "objstore_outage never bit"),
        (lambda r: r["exchange"].update(publish_failures=0), "no publish ever failed"),
        (lambda r: r["exchange"]["generations"].update({"ap": 0}), "never sealed a generation"),
        (lambda r: r.update(evacuations=[]), "no region was ever killed"),
    ],
)
def test_each_contract_clause_fires_as_jax_s(results, doctor, expect_fragment):
    doctored = copy.deepcopy(results["smoke"][0])
    doctor(doctored)
    violations = evacuate.evaluate_evacuation_contract(doctored)
    assert any(expect_fragment in v for v in violations), violations
    assert violations == jax_evacuate.evaluate_evacuation_contract(doctored)


def test_the_committed_scenario_replays_bit_identically():
    outcome = evacuate.replay_evacuation_artifact(json.loads(SCENARIO.read_text()))
    assert outcome["ok"], f"expected {outcome['expected']}, got {outcome['actual']}"
    assert outcome["actual"]["fingerprint"] == "crc32:8a4db88e"


def test_the_replay_refuses_another_kind_of_artifact():
    with pytest.raises(ValueError, match="not an evacuation artifact"):
        evacuate.replay_evacuation_artifact({"kind": "fuzz_scenario"})


def test_the_coverage_session_runs_the_smoke_and_the_exchange_s_edges():
    assert evacuate.run_evacuation_coverage_session() == {
        "scenario": "region_evacuation", "ok": True}


@pytest.mark.parametrize("flags,code,says", [
    (["--smoke"], 0, "contract: all clauses hold"),
    (["--smoke", "--no-spill"], 2, "CONTRACT VIOLATIONS:"),
    (["--smoke", "--replay", str(SCENARIO)], 0, "reproduced bit-identically (crc32:8a4db88e)"),
    (["--smoke", "--replay", "doctored"], 2, "DID NOT REPRODUCE"),
], ids=["smoke", "no-spill", "replay", "replay-doctored"])
def test_the_evacuate_command_exits_as_jax_s(flags, code, says, tmp_path, capsys):
    if "doctored" in flags:
        artifact = json.loads(SCENARIO.read_text())
        artifact["expect"]["fingerprint"] = "crc32:deadbeef"
        doctored = tmp_path / "evac-doctored.json"
        doctored.write_text(json.dumps(artifact))
        flags = [str(doctored) if f == "doctored" else f for f in flags]
    assert cli.main(["simulate", "--scenario", "evacuate", *flags]) == code
    assert says in capsys.readouterr().out


def test_an_unreadable_artifact_exits_2(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    argv = ["simulate", "--scenario", "evacuate", "--replay"]
    assert cli.main([*argv, str(bad)]) == 2
    assert cli.main([*argv, str(tmp_path / "missing.json")]) == 2
    out = capsys.readouterr().out
    assert out.count("simulate evacuate --replay: ") == 2


def test_why_prints_the_tenant_s_chain_after_the_report(results, monkeypatch, capsys):
    port, _ = results["smoke"]
    monkeypatch.setattr(evacuate, "run_region_evacuation", lambda **kw: port)
    assert cli.main(["simulate", "--scenario", "evacuate", "--smoke", "--why", "tpu-prod"]) == 0
    out = capsys.readouterr().out
    assert out.endswith(evacuate.render_evacuation_why(port, "tpu-prod") + "\n")
    assert "tpu-prod: decision chain" in out and "reconverged 15.0s after 'us' was killed" in out


# ---- the fault kinds, the plane and the schedule ----------------------------


def test_the_fault_kinds_are_jax_s():
    assert set(faults.FAULT_KINDS) == set(jax_faults.FAULT_KINDS)
    assert len(faults.FAULT_KINDS) == 18
    assert chaos.FAULT_KINDS is faults.FAULT_KINDS


def _lone_pipeline(clock_cls, cluster_cls, dep_cls, pipe_cls):
    clock = clock_cls()
    cluster = cluster_cls(clock, nodes=[("n0", 8)], pod_start_latency=5.0)
    dep = dep_cls(cluster, "tpu-test", "tpu-test", load_fn=lambda t: 20.0, load_mode="shared")
    cluster.add_deployment(dep, replicas=1)
    return pipe_cls(cluster, dep, target_value=40.0, max_replicas=4)


@pytest.mark.parametrize("kind", ["region_kill", "region_partition", "objstore_outage"])
def test_a_fleet_kind_refuses_a_pipeline_outside_a_region_in_jax_s_words(kind):
    from k8s_gpu_hpa_tpu.control.cluster import SimCluster as JaxCluster
    from k8s_gpu_hpa_tpu.control.cluster import SimDeployment as JaxDeployment
    from k8s_gpu_hpa_tpu.control.loop import AutoscalingPipeline as JaxPipeline

    port = _lone_pipeline(VirtualClock, SimCluster, SimDeployment, AutoscalingPipeline)
    ref = _lone_pipeline(JaxClock, JaxCluster, JaxDeployment, JaxPipeline)
    with pytest.raises(ValueError) as got:
        faults.FAULT_KINDS[kind](port, faults.FaultSpec(kind, 0.0, 10.0))
    with pytest.raises(ValueError) as want:
        jax_faults.FAULT_KINDS[kind](ref, jax_faults.FaultSpec(kind, 0.0, 10.0))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"{kind}: pipeline is not part of a region")


#: tests/test_fault_injectors.py's natural spec of each fleet kind; the
#: pipeline kinds' rows are in tests/test_torch_chaos.py
NATURAL_SPECS = {
    "region_kill": dict(duration=20.0),
    "region_partition": dict(duration=10.0),
    "objstore_outage": dict(duration=10.0),
}


def _one_region_pipeline(mods):
    """tests/test_fault_injectors.py's single-region wrapper: a pipeline
    inside one region of a GlobalControlPlane whose own loops are not
    started, settled for 60 s."""
    clock = mods["clock"]()
    cluster = mods["cluster"](clock, nodes=[("tpu-node-0", 4), ("tpu-node-1", 4)],
                              pod_start_latency=12.0)
    dep = mods["deployment"](cluster, "tpu-test", "tpu-test", load_fn=lambda t: 90.0,
                             load_mode="shared")
    cluster.add_deployment(dep, replicas=1)
    clock.advance(15.0)
    pipe = mods["pipeline"](cluster, dep, target_value=40.0, max_replicas=4)
    reg = mods["region"].Region("test-region", pipe)
    mods["region"].GlobalControlPlane(clock, [reg], mods["store"](clock))
    pipe.start()
    clock.advance(60.0)
    return clock, pipe, reg


@pytest.mark.parametrize("kind", sorted(NATURAL_SPECS))
def test_a_fleet_kind_injects_and_clears_twice_as_jax_s(kind):
    """Each fleet kind with its natural spec on a one-region pipeline,
    cleared twice and followed for 90 s: the region's state while the
    fault holds and after, the scale history, the replicas and the
    exporter's ``up`` series are JAX's, and the loop is healthy again."""
    from k8s_gpu_hpa_tpu.control.cluster import SimCluster as JaxCluster
    from k8s_gpu_hpa_tpu.control.cluster import SimDeployment as JaxDeployment
    from k8s_gpu_hpa_tpu.control.loop import AutoscalingPipeline as JaxPipeline
    from k8s_gpu_hpa_tpu.metrics.objstore import SimObjectStore as JaxStore
    from k8s_gpu_hpa_tpu_torch.metrics.objstore import SimObjectStore

    port = dict(clock=VirtualClock, cluster=SimCluster, deployment=SimDeployment,
                pipeline=AutoscalingPipeline, region=region, store=SimObjectStore, faults=faults)
    ref = dict(clock=JaxClock, cluster=JaxCluster, deployment=JaxDeployment,
               pipeline=JaxPipeline, region=jax_region, store=JaxStore, faults=jax_faults)
    runs = []
    for mods in (port, ref):
        clock, pipe, reg = _one_region_pipeline(mods)
        spec = mods["faults"].FaultSpec(kind=kind, at=0.0, **NATURAL_SPECS[kind])
        clear = mods["faults"].FAULT_KINDS[kind](pipe, spec)
        during = (reg.alive, reg.partitioned, pipe.replicas())
        clock.advance(max(spec.duration, 5.0))
        clear()
        clear()  # idempotent: the second call is a no-op
        clock.advance(90.0)
        assert pipe.running() == pipe.replicas() >= 1
        assert pipe.db.latest("up", {"target": "exporter/tpu-node-1"}) == 1.0
        assert all(getattr(t, "_fault_depth", 0) == 0 for t in pipe.scraper.targets)
        runs.append(dict(during=during, after=(reg.alive, reg.partitioned),
                         history=list(pipe.scale_history), replicas=pipe.replicas(),
                         up=pipe.db.latest("up", {"target": "exporter/tpu-node-0"})))
    assert runs[0] == runs[1]
    assert runs[0]["after"] == (True, False)


_TENANTS = [
    dict(name="a-prod", priority=100, weight=2.0, preemption_budget=0, starvation_budget_s=120.0,
         chips_per_pod=4, max_replicas=4, base_load=90.0, band="prod"),
]
_OTHER = [
    dict(name="b-local", priority=10, weight=1.0, preemption_budget=6, starvation_budget_s=600.0,
         chips_per_pod=2, max_replicas=4, base_load=35.0, band="batch"),
]


def _fleet(region_mod, clock):
    """Two regions, the first with an autoscaler of 2 nodes; started and
    settled for 60 s."""
    a = region_mod.build_region(clock, "a", _TENANTS, node_chips=8, base_nodes=1,
                                slice_quantum=4, autoscaler_max_nodes=2, provision_delay_s=20.0)
    b = region_mod.build_region(clock, "b", _OTHER, node_chips=8, base_nodes=2, slice_quantum=4)
    return a, b


def _lifecycle(region_mod, faults_mod, store_cls, clock) -> dict:
    """A kill (with a node added while the region is dead), a second kill
    nested in it, a partition and an object-store outage through the fault
    kinds, a region named that does not exist, then the recoveries."""
    a, b = _fleet(region_mod, clock)
    plane = region_mod.GlobalControlPlane(clock, [a, b], store_cls(clock, latency_s=2.0))
    plane.start()
    clock.advance(60.0)
    spec = faults_mod.FaultSpec
    with pytest.raises(ValueError) as nowhere:
        faults_mod.FAULT_KINDS["region_kill"](a.pipeline, spec("region_kill", 0.0, 1.0, target="zz"))
    clear_kill = faults_mod.FAULT_KINDS["region_kill"](a.pipeline, spec("region_kill", 0.0, 1.0))
    clear_again = faults_mod.FAULT_KINDS["region_kill"](b.pipeline,
                                                        spec("region_kill", 0.0, 1.0, target="a"))
    capped = a.scheduler.autoscaler.max_nodes
    a.cluster.add_node("a-late", 8)  # born into the dead window: preempted on arrival
    clear_part = faults_mod.FAULT_KINDS["region_partition"](a.pipeline,
                                                            spec("region_partition", 0.0, 1.0,
                                                                 target="b"))
    clear_out = faults_mod.FAULT_KINDS["objstore_outage"](b.pipeline, spec("objstore_outage", 0.0, 1.0))
    clock.advance(15.0)
    partitioned = b.partitioned
    clear_part()  # "b" publishes at the next tick, into the outage
    clock.advance(30.0)
    dead = {"alive": a.alive, "nodes": {n: (x.ready, x.schedulable) for n, x in a.cluster.nodes.items()},
            "capped": capped, "healthy": plane.healthy(), "partitioned": partitioned,
            "store": plane.objstore.available}
    clear_out()
    clear_kill()
    still_dead = a.alive
    clear_again()
    clear_kill()  # idempotent
    clock.advance(120.0)
    return {
        "nowhere": str(nowhere.value), "dead": dead, "still_dead_after_one_clear": still_dead,
        "alive": a.alive, "max_nodes": a.scheduler.autoscaler.max_nodes,
        "nodes": {n: (x.ready, x.schedulable) for n, x in a.cluster.nodes.items()},
        "hooks": len(a.cluster.on_node_added), "status": plane.status(),
        "events": plane.events, "decisions": plane.decision_log,
        "explain": plane.explain("a-prod"),
        "mirrors": {f"{t}@{r}": d.replicas for (t, r), d in plane._mirrors.items()},
        "mirror_specs": sorted(t for t in b.scheduler.tenants),
    }


def test_a_kill_and_its_recovery_leave_the_fleet_as_jax_s():
    from k8s_gpu_hpa_tpu.metrics.objstore import SimObjectStore as JaxStore
    from k8s_gpu_hpa_tpu_torch.metrics.objstore import SimObjectStore

    port = _lifecycle(region, faults, SimObjectStore, VirtualClock())
    ref = _lifecycle(jax_region, jax_faults, JaxStore, JaxClock())
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["nowhere"] == "region_kill: no region named 'zz'"
    assert port["dead"]["alive"] is False and port["still_dead_after_one_clear"] is False
    assert port["dead"]["nodes"]["a-late"] == (False, False)
    assert port["alive"] is True and port["nodes"]["a-node-0"] == (True, True)
    assert port["mirror_specs"] == ["a-prod-evac", "b-local"]
    assert [e["event"] for e in port["events"]][:4] == [
        "region_kill", "region_partition", "partition_heal", "publish_failed"]
    assert port["dead"]["partitioned"] is True and port["dead"]["store"] is False


def test_the_recovery_report_names_its_region_only_when_set():
    """A single cluster's reports keep their shape; a region's name one."""
    for cls, spec in ((RecoveryReport, faults.FaultSpec), (JaxReport, jax_faults.FaultSpec)):
        report = cls(fault=spec("pod_crash", at=0.0))
        assert "region" not in report.as_dict()
        report.region = "us"
        assert report.as_dict()["region"] == "us"
    port = RecoveryReport(fault=faults.FaultSpec("pod_crash", at=0.0), region="eu").as_dict()
    ref = JaxReport(fault=jax_faults.FaultSpec("pod_crash", at=0.0), region="eu").as_dict()
    assert port == ref


def test_the_evacuation_s_reports_carry_the_home_region(results):
    port, ref = results["smoke"]
    assert [f["region"] for f in port["faults"]] == ["us", "us", "us"]
    assert port["faults"] == ref["faults"]


# ---- the rung and the gates --------------------------------------------------


def test_the_rung_is_bench_s_key_for_key(results, monkeypatch):
    """``trial.region_evacuation_rung()`` against bench.py's
    ``run_rung_region_evacuation()``, each over its package's runs of this
    module (the same two configurations, asked for by keyword)."""
    def canned(which):
        def run(**kw):
            name = next(n for n, want in RUNS.items() if want == kw)
            return results[name][which]
        return run

    monkeypatch.setattr(trial, "run_region_evacuation", canned(0))
    monkeypatch.setattr(jax_evacuate, "run_region_evacuation", canned(1))
    port, ref = trial.region_evacuation_rung(), bench.run_rung_region_evacuation()
    assert list(port) == list(ref)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["ok"] is True and port["canary_failed"] is True and port["canary_violations"] == 5
    assert port["ttc_s"] == {"tpu-prod": 15.0, "tpu-batch": 75.0}


def test_the_evacuation_gates_are_jax_s():
    names = [n for n in dir(jax_perfgates) if n.startswith("EVAC_")]
    assert len(names) == 20
    assert {n: getattr(perfgates, n) for n in names} == {n: getattr(jax_perfgates, n) for n in names}
    assert evacuate.EVAC_TENANTS == jax_evacuate.EVAC_TENANTS
    assert evacuate.EVAC_LOCALITY == jax_evacuate.EVAC_LOCALITY
    assert evacuate.EVAC_TTC_BUDGETS_S == jax_evacuate.EVAC_TTC_BUDGETS_S
    assert region.mirror_name("x") == jax_region.mirror_name("x") == "x-evac"
