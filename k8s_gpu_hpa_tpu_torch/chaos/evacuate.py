"""The region evacuation: a whole region dies mid-traffic and its tenants
converge again on the survivors.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/evacuate.py``: the
``region_evacuation`` rung behind ``python -m k8s_gpu_hpa_tpu_torch simulate
--scenario evacuate`` (and ``trial.region_evacuation_rung``).  Where the
crunch (:mod:`.crunch`) squeezes one pool's supply, the evacuation takes a
pool away: three regional stacks (:func:`..control.region.build_region`)
share a virtual clock and exchange sealed format-3 snapshots through a
simulated object store; a :class:`..control.region.GlobalControlPlane`
merges their reads Thanos-style and spills demand across regions by
``(priority, fair share, data-locality cost)``; then ``region_kill`` takes
the home region away.  Under test is the fleet's brain: the frozen demand
must land on the survivors' mirrors within each priority band's
time-to-reconvergence budget, the survivors' own tenants must not starve,
and the global query layer must keep serving, answering exactly as a
directly merged reference, through an object-store outage and a survivor's
partition.

The cast (a region: 2 nodes of 8 devices, a slice quantum of 4, no
autoscaler, so the headroom stands):

=========  =========  ========  ======  ======  =====  =========  ======
region     tenant     priority  weight  devices  max   base load  band
                                        a pod   repl.
=========  =========  ========  ======  ======  =====  =========  ======
us         tpu-prod        100     2.0       4      4       90.0  prod
us         tpu-batch        10     1.0       2      6       60.0  batch
eu         eu-local         10     1.0       2      4       35.0  batch
ap         ap-local         10     1.0       2      4       35.0  batch
=========  =========  ========  ======  ======  =====  =========  ======

Settled, "us" runs 3 prod and 2 batch replicas (16 of 16 devices); "eu" and
"ap" run one local replica each (2 of 16) and hold the headroom.  The
faults (seconds after arming, from :mod:`..perfgates`):

=========  =============================  ====================================
t (s)      fault                          what must happen
=========  =============================  ====================================
30-120     region_partition ap            "ap" serves ap-local but takes no
                                          spill and stops publishing (global
                                          reads serve its last sealed
                                          generation)
60-360     region_kill us                 demand frozen, nodes preempted;
                                          prod spills to "eu" within its TTC
                                          budget, batch lands in part and is
                                          denied the rest (no_capacity)
                                          until the partition heals
120-165    objstore_outage                publishes fail without using up
                                          generation numbers; global reads
                                          serve the cached merge, stale
=========  =============================  ====================================

After 360 s "us" recovers: its pods bind again, the plane drains every
mirror, and the contract asks for each band's TTC within budget, every
surviving pool's audit conserved, no survivor's tenant starved, and the
global basket read through the exchange equal to a merged reference that
never failed.
"""

from __future__ import annotations

import json
import zlib

from k8s_gpu_hpa_tpu_torch import perfgates
from k8s_gpu_hpa_tpu_torch.chaos.faults import FaultSpec
from k8s_gpu_hpa_tpu_torch.chaos.schedule import ChaosSchedule
from k8s_gpu_hpa_tpu_torch.control.region import GlobalControlPlane, build_region, mirror_name
from k8s_gpu_hpa_tpu_torch.metrics.global_query import (
    basket_fingerprint,
    combined_payload_of,
    merge_payloads,
    publish_snapshot,
    query_basket,
    read_latest_sealed,
    restore_payload,
)
from k8s_gpu_hpa_tpu_torch.metrics.objstore import SimObjectStore, TornUpload
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

#: each region's tenants in :func:`build_region`'s row shape; the first row
#: is the region's pipeline tenant.  The starvation budgets are perfgates',
#: so the contract and the gates cannot drift apart
EVAC_TENANTS: dict[str, list[dict]] = {
    "us": [
        dict(name="tpu-prod", priority=100, weight=2.0, preemption_budget=0,
             starvation_budget_s=perfgates.EVAC_STARVATION_BUDGETS_S["tpu-prod"],
             chips_per_pod=4, max_replicas=4, base_load=90.0, band="prod"),
        dict(name="tpu-batch", priority=10, weight=1.0, preemption_budget=6,
             starvation_budget_s=perfgates.EVAC_STARVATION_BUDGETS_S["tpu-batch"],
             chips_per_pod=2, max_replicas=6, base_load=60.0, band="batch"),
    ],
    "eu": [
        dict(name="eu-local", priority=10, weight=1.0, preemption_budget=6,
             starvation_budget_s=perfgates.EVAC_STARVATION_BUDGETS_S["eu-local"],
             chips_per_pod=2, max_replicas=4, base_load=35.0, band="batch"),
    ],
    "ap": [
        dict(name="ap-local", priority=10, weight=1.0, preemption_budget=6,
             starvation_budget_s=perfgates.EVAC_STARVATION_BUDGETS_S["ap-local"],
             chips_per_pod=2, max_replicas=4, base_load=35.0, band="batch"),
    ],
}

#: data-locality costs: the "us" tenants' data replicates to "eu" first, so
#: with both survivors loaded alike the spill prefers "eu"
EVAC_LOCALITY: dict[str, dict[str, float]] = {
    "us": {"eu": 0.5, "ap": 1.0},
    "eu": {"us": 0.5, "ap": 1.0},
    "ap": {"us": 1.0, "eu": 1.0},
}

#: the TTC budget of each band (perfgates' ceilings)
EVAC_TTC_BUDGETS_S = {
    "prod": perfgates.EVAC_PROD_TTC_MAX_S,
    "batch": perfgates.EVAC_BATCH_TTC_MAX_S,
}


def _evac_faults(kill_duration: float) -> list[FaultSpec]:
    return [
        FaultSpec("region_partition", at=perfgates.EVAC_PARTITION_AT_S,
                  duration=perfgates.EVAC_PARTITION_DURATION_S, target="ap"),
        FaultSpec("region_kill", at=perfgates.EVAC_KILL_AT_S,
                  duration=kill_duration, target="us"),
        FaultSpec("objstore_outage", at=perfgates.EVAC_OUTAGE_AT_S,
                  duration=perfgates.EVAC_OUTAGE_DURATION_S),
    ]


def _basket_names() -> list[str]:
    names = ["up"]
    for rows in EVAC_TENANTS.values():
        for t in rows:
            names.append(f"{t['name'].replace('-', '_')}_tensorcore_avg")
    return sorted(names)


def run_region_evacuation(
    spill_enabled: bool = True,
    smoke: bool = False,
    total: float | None = None,
    on_plane=None,
) -> dict:
    """Run the canned evacuation and return a JSON-able result, the contract
    evaluated (``result["ok"]``, ``result["violations"]``).

    ``spill_enabled=False`` is the planted canary (``--no-spill``): the
    plane denies every spill, the frozen demand never converges again, and
    the contract fails.  ``smoke`` shortens the kill and the tail: the same
    lifecycle, the same clauses.  ``on_plane(plane, regions, schedule)``
    runs before the faults are armed (the paging drill's hook); it leaves
    the result's shape as it is."""
    clock = VirtualClock()
    store = SimObjectStore(clock, latency_s=perfgates.EVAC_OBJSTORE_LATENCY_S)
    regions = [
        build_region(
            clock,
            name,
            EVAC_TENANTS[name],
            node_chips=perfgates.EVAC_NODE_CHIPS,
            base_nodes=perfgates.EVAC_BASE_NODES,
            slice_quantum=perfgates.EVAC_SLICE_QUANTUM,
            locality=EVAC_LOCALITY[name],
        )
        for name in perfgates.EVAC_REGIONS
    ]
    plane = GlobalControlPlane(
        clock,
        regions,
        store,
        spill_enabled=spill_enabled,
        sync_interval=perfgates.EVAC_SYNC_INTERVAL_S,
        publish_interval=perfgates.EVAC_PUBLISH_INTERVAL_S,
    )
    by_name = plane.regions

    # the 5 s monitor: every region's pool must audit conserved at every
    # tick it is alive (a dead pool is expected empty, not conserved), and
    # the global query layer is polled, so the outage's stale serves are
    # exercised
    audits: list[dict] = []

    def monitor() -> None:
        for region in regions:
            audits.append({"region": region.name, "alive": region.alive, **region.scheduler.pool.audit()})
        plane.query.refresh()
        clock.call_later(5.0, monitor)

    clock.call_later(5.0, monitor)

    plane.start()
    clock.advance(perfgates.EVAC_SETTLE_S)
    settled = {
        name: {t: by_name[name].cluster.deployments[t].replicas for t in by_name[name].tenants}
        for name in by_name
    }

    kill_duration = (
        perfgates.EVAC_SMOKE_KILL_DURATION_S if smoke else perfgates.EVAC_KILL_DURATION_S
    )
    if total is None:
        total = perfgates.EVAC_SMOKE_TOTAL_S if smoke else perfgates.EVAC_TOTAL_S
    schedule = ChaosSchedule(by_name["us"].pipeline, _evac_faults(kill_duration), plane=plane)
    if on_plane is not None:
        on_plane(plane, regions, schedule)
    schedule.arm()
    clock.advance(total)

    # the final seal and the reference at the same instant: each live region
    # publishes once more, and the reference takes the same payload straight
    # from the live DB.  The exchange's side goes through canonical JSON, the
    # store and the sealed reader, so any difference is the exchange's
    reference_payloads: dict[str, dict] = {}
    for region in regions:
        if region.alive:
            plane.publish_region(region.name)
            reference_payloads[region.name] = combined_payload_of(region.pipeline.db)
    at = clock.now()
    clock.advance(perfgates.EVAC_OBJSTORE_LATENCY_S + 1.0)
    names = _basket_names()
    windows = [60.0, 300.0]
    global_basket = query_basket(plane.query.db(), names, windows, at)
    reference_db = restore_payload(merge_payloads(reference_payloads), clock)
    reference_basket = query_basket(reference_db, names, windows, at)
    fp_global = basket_fingerprint(global_basket)
    fp_reference = basket_fingerprint(reference_basket)

    region_results: dict[str, dict] = {}
    for region in regions:
        scheduler = region.scheduler
        tenants: dict[str, dict] = {}
        for tenant, spec_row in region.tenants.items():
            dep = region.cluster.deployments[tenant]
            tenants[tenant] = {
                "band": spec_row["band"],
                "final_replicas": dep.replicas,
                "final_running": len(region.cluster.running_pods(tenant)),
                "final_pending": len(scheduler.pending_pods(tenant)),
                "max_pending_stint_s": round(
                    max(scheduler.max_pending_stint.get(tenant, 0.0),
                        scheduler.open_stint_seconds(tenant)),
                    1,
                ),
                "starvation_budget_s": spec_row["starvation_budget_s"],
                "preemptions_suffered": scheduler.preemptions_suffered.get(tenant, 0),
            }
        mirrors = {
            mirror_name(t): dep.replicas
            for (t, rname), dep in plane._mirrors.items()
            if rname == region.name
        }
        region_results[region.name] = {
            "alive": region.alive,
            "partitioned": region.partitioned,
            "tenants": tenants,
            "mirror_replicas": mirrors,
            "pool_final": scheduler.pool.audit(),
            "generation": plane._generation[region.name],
        }

    result = {
        "scenario": "region_evacuation",
        "mode": "virtual",
        "smoke": smoke,
        "spill_enabled": spill_enabled,
        "killed_region": "us",
        "settled": settled,
        "regions": region_results,
        "bands": {t["name"]: t["band"] for rows in EVAC_TENANTS.values() for t in rows},
        "ttc_budgets_s": dict(EVAC_TTC_BUDGETS_S),
        "evacuations": plane.evacuations,
        "audits": {
            "ticks": len(audits),
            "alive_conserved": all(a["conserved"] for a in audits if a["alive"]),
            "alive_violations": [
                f"{a['region']}: {v}" for a in audits if a["alive"] for v in a["violations"]
            ],
        },
        "spills": {"admitted": plane.spills_admitted, "denied": plane.spills_denied},
        "decisions": plane.decision_log,
        "plane_events": plane.events,
        "faults": [r.as_dict() for r in schedule.reports],
        "all_recovered": schedule.all_recovered(),
        "objstore": store.stats(),
        "exchange": {
            "publishes": plane.publishes_total,
            "publish_failures": plane.publish_failures_total,
            "generations": {name: plane._generation[name] for name in by_name},
            "query": plane.query.status(),
        },
        "global": {
            "fingerprint": fp_global,
            "reference_fingerprint": fp_reference,
            "bit_identical": fp_global == fp_reference and global_basket == reference_basket,
            "basket_names": len(names),
        },
    }
    result["violations"] = evaluate_evacuation_contract(result)
    result["ok"] = not result["violations"]
    return result


def evaluate_evacuation_contract(result: dict) -> list[str]:
    """Score an evacuation's result against the fleet contract.  Pure over
    the result dict (the tests feed it doctored results, a clause at a
    time):

    - **reconvergence**: each killed-region tenant's frozen demand Running
      on the survivors' mirrors within its band's TTC budget, and the
      mirrors drained once home recovers;
    - **survivors' integrity**: every pool audit conserved at every tick a
      region was alive, and no survivor's own tenant starved past its
      budget;
    - **home convergence**: after the recovery every tenant runs at its
      desired count with nothing Pending, and every fault recovered;
    - **global reads**: the global basket read through the exchange equal
      to the merged reference that never failed;
    - **decision chain**: every evacuated tenant has an admitted spill on
      record (``--why``);
    - **non-vacuity**: the run spilled, was denied at least once, saw the
      store fail, and sealed a generation in every region.
    """
    violations: list[str] = []
    bands = result["bands"]
    budgets = result["ttc_budgets_s"]
    if not result["evacuations"]:
        violations.append("vacuous run: no region was ever killed")
    for evac in result["evacuations"]:
        for tenant, want in evac["frozen"].items():
            ttc = evac["tenant_ttc_s"].get(tenant)
            budget = budgets[bands[tenant]]
            if ttc is None:
                violations.append(
                    f"{tenant}: {want} frozen replica(s) never reconverged "
                    f"on surviving regions (budget {budget:.0f}s)"
                )
            elif ttc > budget:
                violations.append(
                    f"{tenant}: reconverged in {ttc:.1f}s, over the "
                    f"{bands[tenant]} band's {budget:.0f}s budget"
                )
        if evac["completed_at"] is not None and evac["drained_at"] is None:
            violations.append(f"{evac['region']}: mirrors never drained after recovery")
    if not result["audits"]["alive_conserved"]:
        violations.append(
            "pool conservation broken in a live region: "
            + ("; ".join(result["audits"]["alive_violations"][:3])
               or "used + free != capacity on some tick")
        )
    killed = result["killed_region"]
    for rname, region in result["regions"].items():
        for tenant, t in region["tenants"].items():
            if rname != killed and t["max_pending_stint_s"] > t["starvation_budget_s"]:
                violations.append(
                    f"{rname}/{tenant}: starved {t['max_pending_stint_s']:.1f}s, "
                    f"over its {t['starvation_budget_s']:.0f}s budget"
                )
            if t["final_running"] != t["final_replicas"] or t["final_pending"]:
                violations.append(
                    f"{rname}/{tenant}: did not converge "
                    f"({t['final_running']}/{t['final_replicas']} running, "
                    f"{t['final_pending']} pending)"
                )
        for mirror, replicas in region["mirror_replicas"].items():
            if replicas:
                violations.append(
                    f"{rname}/{mirror}: {replicas} mirror replica(s) never drained home"
                )
    if not result["all_recovered"]:
        violations.append("not every fault recovered")
    if not result["global"]["bit_identical"]:
        violations.append(
            "global query basket diverged from the merged reference: "
            f"{result['global']['fingerprint']} != "
            f"{result['global']['reference_fingerprint']}"
        )
    admitted_for = {
        d["tenant"] for d in result["decisions"]
        if d.get("to") is not None and d.get("cause") != "drain_home_recovered"
    }
    for evac in result["evacuations"]:
        for tenant in evac["frozen"]:
            if tenant not in admitted_for:
                violations.append(f"{tenant}: no admitted cross-region spill decision on record")
    if result["spills"]["admitted"] < 1:
        violations.append("vacuous run: no spill was ever admitted")
    if result["spills"]["denied"] < 1:
        violations.append("vacuous run: no spill was ever denied")
    if result["objstore"]["outage_errors"] < 1:
        violations.append("vacuous run: objstore_outage never bit")
    if result["exchange"]["publish_failures"] < 1:
        violations.append("vacuous run: no publish ever failed")
    for rname, generation in result["exchange"]["generations"].items():
        if generation < 1:
            violations.append(f"{rname}: never sealed a generation")
    return violations


def render_evacuation_report(result: dict) -> str:
    """The report ``simulate --scenario evacuate`` prints: the TTC of each
    band beside its budget, the decision chain and the contract."""
    lines = [
        f"region evacuation: killed {result['killed_region']!r} among "
        f"{len(result['regions'])} regions, "
        f"{result['spills']['admitted']} spills admitted / "
        f"{result['spills']['denied']} denied, "
        f"{result['exchange']['publishes']} generations sealed "
        f"({result['exchange']['publish_failures']} publish failures)",
        "",
        f"{'tenant':<10} {'band':<6} {'frozen':>6} {'TTC':>8} {'budget':>8}",
    ]
    bands = result["bands"]
    budgets = result["ttc_budgets_s"]
    for evac in result["evacuations"]:
        for tenant, want in sorted(evac["frozen"].items()):
            ttc = evac["tenant_ttc_s"].get(tenant)
            band = bands[tenant]
            lines.append(
                f"{tenant:<10} {band:<6} {want:>6} "
                f"{'never' if ttc is None else f'{ttc:.0f}s':>8} "
                f"{budgets[band]:>7.0f}s"
            )
    lines += ["", "cross-region decision chain:"]
    for d in result["decisions"]:
        target = d["to"] if d.get("to") else f"DENIED ({d.get('denied')})"
        lines.append(
            f"  t={d['t']:7.1f}  {d['tenant']:<12} {d['from']} -> {target:<22} "
            f"x{d['replicas']} [{d['cause']}]"
        )
    lines += [
        "",
        f"surviving pools conserved: {result['audits']['alive_conserved']} "
        f"({result['audits']['ticks']} audit rows)",
        f"all faults recovered:      {result['all_recovered']}",
        f"global reads bit-identical: {result['global']['bit_identical']} "
        f"({result['global']['fingerprint']})",
    ]
    if result["violations"]:
        lines += ["", "CONTRACT VIOLATIONS:"]
        lines += [f"  - {v}" for v in result["violations"]]
    else:
        lines += ["", "contract: all clauses hold"]
    return "\n".join(lines)


def render_evacuation_why(result: dict, tenant: str) -> str:
    """One tenant's decision chain across the regions: what ``simulate
    --scenario evacuate --why TENANT`` prints."""
    rows = [d for d in result["decisions"] if d["tenant"] == tenant]
    if not rows:
        return f"{tenant}: no cross-region decisions recorded"
    lines = [f"{tenant}: decision chain ({len(rows)} steps)"]
    for d in rows:
        if d.get("to"):
            verdict = f"spill {d['replicas']} -> {d['to']}"
            if d.get("score") is not None:
                verdict += f" (pool ratio {d['score'][0]}, locality {d['score'][1]})"
        elif d.get("cause") == "drain_home_recovered":
            verdict = f"drain mirrors in {d['from']} home to {d.get('to')}"
        else:
            verdict = f"deny {d['replicas']} ({d.get('denied')})"
        lines.append(f"  t={d['t']:7.1f}  [{d['cause']}] {verdict}")
    for evac in result["evacuations"]:
        ttc = evac["tenant_ttc_s"].get(tenant)
        if ttc is not None:
            lines.append(f"  reconverged {ttc:.1f}s after {evac['region']!r} was killed")
    return "\n".join(lines)


# ---- replayable scenario artifacts -----------------------------------------


def evacuation_fingerprint(result: dict) -> str:
    """CRC32 over a result's deterministic core: the TTCs, the frozen
    demand, the spill counts, the decision chain, the global basket's
    fingerprint and the violations.  Two runs of one configuration give the
    same value: the committed artifact's replay check."""
    basis = {
        "ttc": [e["tenant_ttc_s"] for e in result["evacuations"]],
        "frozen": [e["frozen"] for e in result["evacuations"]],
        "spills": result["spills"],
        "decisions": [
            [d["t"], d["tenant"], d["from"], d.get("to"), d["replicas"], d["cause"], d.get("denied")]
            for d in result["decisions"]
        ],
        "global": result["global"]["fingerprint"],
        "violations": result["violations"],
    }
    blob = json.dumps(basis, sort_keys=True, separators=(",", ":")).encode()
    return f"crc32:{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


def build_evacuation_artifact(name: str, result: dict) -> dict:
    """A committed scenario artifact (tests/scenarios/evac-*.json): the
    configuration to run again and the fingerprint the replay must give."""
    return {
        "version": 1,
        "kind": "region_evacuation",
        "name": name,
        "smoke": result["smoke"],
        "spill_enabled": result["spill_enabled"],
        "expect": {
            "ok": result["ok"],
            "violations": result["violations"],
            "fingerprint": evacuation_fingerprint(result),
        },
    }


def replay_evacuation_artifact(artifact: dict) -> dict:
    """Run an artifact's configuration again and compare.  Returns ``{"ok",
    "expected", "actual", "result"}``; ``ok`` means the same fingerprint and
    the same verdict.  ValueError for an artifact of another kind."""
    if artifact.get("kind") != "region_evacuation":
        raise ValueError(f"not an evacuation artifact: {artifact.get('kind')!r}")
    result = run_region_evacuation(spill_enabled=artifact["spill_enabled"], smoke=artifact["smoke"])
    actual = {
        "ok": result["ok"],
        "violations": result["violations"],
        "fingerprint": evacuation_fingerprint(result),
    }
    return {"ok": actual == artifact["expect"], "expected": artifact["expect"],
            "actual": actual, "result": result}


def run_evacuation_coverage_session() -> dict:
    """The ``coverage`` scenario's evacuation session: one smoke evacuation
    drives the whole lifecycle, and a small exchange drives the protocol's
    edges the scenario leaves cold: a torn seal falling back to the last
    good generation, and a read of a region that never published."""
    result = run_region_evacuation(smoke=True)

    clock = VirtualClock()
    store = SimObjectStore(clock)  # no latency: the edges, not the physics
    db = TimeSeriesDB(clock)
    db.append("up", (("job", "edge"),), 1.0)
    payload = db.snapshot_payload()
    publish_snapshot(store, "edge", 1, payload)
    try:
        # generation 2's seal tears mid-upload: the reader falls back to 1
        publish_snapshot(store, "edge", 2, payload, fail_seal_after=5)
    except TornUpload:
        pass
    sealed = read_latest_sealed(store, "edge")
    assert sealed is not None and sealed[0] == 1, sealed
    assert read_latest_sealed(store, "never-published") is None
    return {"scenario": result["scenario"], "ok": result["ok"]}
