"""Pipeline doctor: the runbook's per-joint probes as one command, and the
NVML probe of a GPU node.

Counterpart of ``k8s_gpu_hpa_tpu/doctor.py``.  The reference's only test story is four
manual curl probes interleaved with install steps (exporter text,
README.md:42-47; Prometheus query, :80-88; custom-metrics raw API,
:98-102; the scale-up watch, :112-121), with the discipline "don't advance
past a failing probe" implicit in their order.  ``diagnose`` makes it executable: an ordered list
of probes, one per string-contract joint, that stops at the first broken
joint and says which contract broke.

- ``diagnose(...)`` takes plain callables (the tests' in-process payloads,
  ``main``'s HTTP and kubectl fetchers);
- ``check_self_metrics`` probes the traced pipeline's own families (the
  ``pipeline-self`` target, obs/selfmetrics.py) in an instant-query payload
  of ``SELF_METRICS_QUERY``, ``check_histograms`` that target's histograms
  in its exposition, ``check_shards`` a sharded scrape plane's topology
  (metrics/federation.py), ``check_query_planner`` the planner's selfcheck
  (metrics/planner.py), ``check_downsampling`` the rollup tiers' selfcheck
  (metrics/downsample.py), ``check_capacity_pool`` the capacity economy's
  selfcheck (control/capacity.py), ``check_operator_metrics`` the
  slice-quantum operator's ``/metrics`` (control/operator.py), and
  ``check_alerts`` Prometheus's alerts: a firing
  ``Tpu*`` alert (metrics/rules.py's ``shipped_alert_rules``) is a
  diagnosis even when every joint answered;
- ``python -m k8s_gpu_hpa_tpu_torch.doctor`` probes a cluster.  Its
  environment: EXPORTER_URL (default http://localhost:9400/metrics),
  PROM_URL (default http://localhost:9090), METRIC (default
  tpu_test_tensorcore_avg), HPA and NAMESPACE for the HPA check (the
  custom-metrics and HPA probes need ``kubectl``), SELF_METRICS=1 to probe
  the self-metric series (only where the pipeline's ``pipeline-self``
  target is scraped), OPERATOR_URL to probe the quantum operator's
  ``/metrics`` (e.g. http://localhost:8086/metrics through a port-forward),
  CAPACITY_SELFCHECK=1 to run ``capacity_selfcheck()`` in process and probe
  it;
- ``python -m k8s_gpu_hpa_tpu_torch.doctor nvml`` runs ``probe_nvml``, the
  counterpart of the JAX doctor's libtpu probe: every NVML call the node
  exporter's ``NvmlSource`` makes, on every GPU of the host.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable
from urllib.parse import quote

from k8s_gpu_hpa_tpu_torch.control.capacity import capacity_selfcheck
from k8s_gpu_hpa_tpu_torch.exporter import nvml
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.metrics.schema import CHIP_METRICS, CORE_CHIP_METRICS
from k8s_gpu_hpa_tpu_torch.obs.selfmetrics import (
    SELF_HISTOGRAM_NAMES,
    SELF_METRIC_NAMES,
    SELF_TARGET_NAME,
)

#: one instant query covering every self-metric family (obs/selfmetrics.py)
SELF_METRICS_QUERY = '{__name__=~"%s"}' % "|".join(SELF_METRIC_NAMES)


@dataclass
class ProbeResult:
    name: str
    ok: bool
    detail: str


@dataclass
class Probe:
    """One joint check: ``run`` returns a detail string on success and
    raises on failure; None where the joint has no fetcher (skipped)."""

    name: str
    description: str
    run: Callable[[], str] | None


def check_exporter_text(text: str) -> str:
    """L2 joint: the exporter serves fresh per-device gauges with the
    attribution labels the rules depend on."""
    fams = {f.name: f for f in parse_text(text)}
    up = fams.get("tpu_metrics_exporter_up")
    if up is None or not up.samples:
        raise AssertionError("tpu_metrics_exporter_up missing from exposition")
    if up.samples[0].value != 1.0:
        raise AssertionError(
            "tpu_metrics_exporter_up=0: exporter is serving but its metric "
            "source is stale (no fresh sweep within the staleness window)"
        )
    # only the CORE families exist on every healthy source; the optional ones
    # are absent where nothing can measure them
    missing = [m for m in CORE_CHIP_METRICS if m not in fams or not fams[m].samples]
    if missing:
        raise AssertionError(f"core chip metric families missing/empty: {missing}")
    probe_fam = fams.get("tpu_duty_cycle") or fams[CORE_CHIP_METRICS[0]]
    sample = probe_fam.samples[0]
    for label in ("node", "chip"):
        if sample.label(label) is None:
            raise AssertionError(f"per-chip samples lack the {label!r} label")
    n = len(probe_fam.samples)
    attributed = sum(1 for s in probe_fam.samples if s.label("pod"))
    optional = sorted(
        m for m in CHIP_METRICS
        if m not in CORE_CHIP_METRICS and m in fams and fams[m].samples
    )
    return (
        f"{n} chips exported, {attributed} attributed to pods"
        + (f", optional families: {', '.join(optional)}" if optional else "")
    )


def check_prom_vector(payload: str, metric: str) -> str:
    """L3 joint: the recorded series exists with its addressing labels.
    ``payload`` is the Prometheus instant-query JSON response body."""
    doc = json.loads(payload)
    if doc.get("status") != "success":
        raise AssertionError(f"prometheus query failed: {doc}")
    results = doc["data"]["result"]
    if not results:
        raise AssertionError(
            f"series {metric} absent: scrape job, recording rule, or the "
            "kube_pod_labels join is broken (or the workload isn't running — "
            "deploy it first, README ordering)"
        )
    labels = results[0]["metric"]
    addressed = {
        k: v for k, v in labels.items() if k in ("namespace", "deployment", "statefulset", "pod")
    }
    if "namespace" not in addressed or len(addressed) < 2:
        raise AssertionError(
            f"series {metric} lacks object-addressing labels (got {labels}); "
            "prometheus-adapter cannot associate it with a Kubernetes object"
        )
    value = results[0]["value"][1]
    return f"{metric}={value} {addressed}"


def check_scrape_up(payload: str) -> str:
    """L3 scrape health: every scrape target answers (``up == 1``).  A down
    target degrades coverage silently from the recorded series' point of
    view (the average is served from the survivors).  ``payload`` is the
    instant-query JSON for ``up``."""
    doc = json.loads(payload)
    if doc.get("status") != "success":
        raise AssertionError(f"prometheus query failed: {doc}")
    results = doc["data"]["result"]
    if not results:
        raise AssertionError("no up series at all: the scrape config matched zero targets")
    down = []
    for r in results:
        if float(r["value"][1]) != 1.0:
            labels = r["metric"]
            down.append(
                labels.get("target") or labels.get("instance") or labels.get("job") or "?"
            )
    if down:
        raise AssertionError(
            f"{len(down)}/{len(results)} scrape target(s) down: " + ", ".join(sorted(down))
        )
    return f"all {len(results)} scrape targets up"


def check_shards(payload: str) -> str:
    """L3 shard topology (sharded scrape planes only): every scraper shard
    reachable, the shards' target sets pairwise disjoint, and their union
    the whole fleet.  A shard that is down fails quietly (its targets stop
    being scraped while the federated average is served from the rest), and
    an assignment fault (two shards owning one target, or none) double-counts
    or drops series the global rules read.  ``payload`` is
    ``ShardedScrapePlane.shard_status_json()`` (in production each agent's
    /-/ready and its target list)."""
    doc = json.loads(payload)
    shards = doc.get("shards", [])
    if not shards:
        raise AssertionError("no shards reported: not a sharded scrape plane?")
    unreachable = [s["shard"] for s in shards if not s.get("reachable", False)]
    if unreachable:
        raise AssertionError(
            f"shard(s) {unreachable} unreachable: their targets are not "
            "being scraped (the federated aggregate keeps serving from "
            "survivors, so this degrades coverage silently)"
        )
    owned: dict[str, int] = {}
    dupes = []
    for s in shards:
        for name in s["targets"]:
            if name in owned:
                dupes.append(f"{name} (shards {owned[name]} and {s['shard']})")
            owned[name] = s["shard"]
    if dupes:
        raise AssertionError(
            f"{len(dupes)} target(s) owned by more than one shard — "
            "double-scraped and double-counted by fleet aggregates: "
            + ", ".join(sorted(dupes)[:5])
        )
    fleet = doc.get("fleet", [])
    orphans = sorted(set(fleet) - set(owned))
    if orphans:
        raise AssertionError(
            f"{len(orphans)} fleet target(s) owned by no shard (never "
            "scraped): " + ", ".join(orphans[:5])
        )
    return (
        f"{len(shards)} shards reachable, {len(owned)} targets "
        "disjointly owned, union covers fleet"
    )


def check_self_metrics(payload: str) -> str:
    """The pipeline watching itself: every self-metric family present and
    fresh (an instant query returns only points inside the lookback, so
    presence is freshness), and a ``scrape_duration_seconds`` sample for the
    ``pipeline-self`` target itself, which shows the self-monitoring loop
    closed over its own scrape.  ``payload`` is the instant-query JSON for
    :data:`SELF_METRICS_QUERY`."""
    doc = json.loads(payload)
    if doc.get("status") != "success":
        raise AssertionError(f"prometheus query failed: {doc}")
    results = doc["data"]["result"]
    if not results:
        raise AssertionError(
            "no pipeline self-metric series at all: the pipeline is not "
            "traced/instrumented, or its pipeline-self target is not scraped"
        )
    found = {r["metric"].get("__name__", "") for r in results}
    missing = [n for n in SELF_METRIC_NAMES if n not in found]
    if missing:
        raise AssertionError(
            f"self-metric families missing or stale: {missing} (got {sorted(found)})"
        )
    self_scraped = any(
        r["metric"].get("__name__") == "scrape_duration_seconds"
        and r["metric"].get("target") == SELF_TARGET_NAME
        for r in results
    )
    if not self_scraped:
        raise AssertionError(
            f"no scrape_duration_seconds sample for target={SELF_TARGET_NAME!r}: "
            "the self-metrics target is served but not being scraped"
        )
    return f"all {len(SELF_METRIC_NAMES)} self-metric families fresh ({len(results)} series)"


def check_histograms(text: str) -> str:
    """Every self-histogram family in the ``pipeline-self`` exposition
    ``text`` keeps the OpenMetrics bucket contract, for each label set:
    counts non-decreasing in ``le``, a ``+Inf`` bucket equal to ``_count``,
    and ``_sum`` non-negative and 0 while the count is 0.  A break here
    spoils the quantiles and the SLO's bucket-derived counters while every
    series looks fresh, which no freshness probe sees."""
    fams = {f.name: f for f in parse_text(text)}
    checked = 0
    for name in SELF_HISTOGRAM_NAMES:
        fam = fams.get(name)
        if fam is None:
            raise AssertionError(f"histogram family {name} missing from exposition")
        # the suffixed series grouped by their label sets less le
        groups: dict[tuple, dict] = {}
        for s in fam.samples:
            key = tuple(sorted((k, v) for k, v in s.labels if k != "le"))
            g = groups.setdefault(key, {"buckets": [], "sum": None, "count": None})
            if s.suffix == "_bucket":
                le = s.label("le")
                if le is None:
                    raise AssertionError(f"{name}_bucket sample lacks the le label")
                g["buckets"].append((float(le), s.value))
            elif s.suffix == "_sum":
                g["sum"] = s.value
            elif s.suffix == "_count":
                g["count"] = s.value
        if not groups:
            raise AssertionError(f"histogram family {name} has no samples")
        for key, g in groups.items():
            where = f"{name}{dict(key) if key else ''}"
            if g["sum"] is None or g["count"] is None:
                raise AssertionError(f"{where}: _sum/_count series missing")
            buckets = sorted(g["buckets"])
            if not buckets or buckets[-1][0] != float("inf"):
                raise AssertionError(f"{where}: no +Inf bucket")
            counts = [c for _, c in buckets]
            if any(later < earlier for earlier, later in zip(counts, counts[1:])):
                raise AssertionError(
                    f"{where}: bucket counts not cumulative (non-decreasing in le): {counts}"
                )
            if counts[-1] != g["count"]:
                raise AssertionError(
                    f"{where}: +Inf bucket {counts[-1]:g} != _count {g['count']:g}"
                )
            if g["sum"] < 0 or (g["count"] == 0 and g["sum"] != 0):
                raise AssertionError(
                    f"{where}: _sum {g['sum']:g} inconsistent with _count {g['count']:g}"
                )
            checked += 1
    return f"{len(SELF_HISTOGRAM_NAMES)} histogram families conformant ({checked} label sets)"


def check_query_planner(payload: str) -> str:
    """Query-engine health (metrics/planner.py): the planned and the naive
    evaluation of every rule agree sample for sample, and the chunk-summary
    fast path is taken.  A disagreement means the plans compute other
    numbers than the rules' semantics, and the HPA acts on the plans; a
    fast path never taken means the summaries stopped applying and every
    window pays a full decode.  ``payload`` is ``planner_selfcheck(...)``
    JSON."""
    doc = json.loads(payload)
    disagree = [r["record"] for r in doc.get("rules", []) if not r["agree"]]
    if not doc.get("agree_all", False) or disagree:
        raise AssertionError(
            "planned evaluation DISAGREES with naive AST evaluation for: "
            + (", ".join(disagree) or "(unreported rules)")
            + " — do not trust scale decisions until this is fixed"
        )
    fastpath = doc.get("fastpath", 0)
    fallback = doc.get("fallback", 0)
    if fastpath <= 0:
        raise AssertionError(
            f"planner summary fast path never taken (fastpath=0, "
            f"fallback={fallback}): windowed reads are decoding every chunk "
            "— seal-time summaries are missing or the planner fell back"
        )
    return (
        f"{len(doc.get('rules', []))} rules planned==naive; "
        f"fastpath {fastpath} chunk(s), fallback {fallback} decode(s), "
        f"series cache {doc.get('series_cache_hits', 0)} hit(s)/"
        f"{doc.get('series_resolves', 0)} resolve(s)"
    )


def check_downsampling(payload: str) -> str:
    """Long-horizon rollup-tier health (TSDBs running a DownsamplePolicy,
    metrics/downsample.py): every configured tier holds sealed buckets,
    and on tier-aligned windows where raw retention still overlaps rollup
    coverage the rollup fold returns the SAME floats as re-bucketing the
    raw points.  A tier with zero buckets means compaction silently
    stopped (horizon misconfigured, or the append/evict hooks detached);
    a disagreement means the flight recorder and ``simulate history`` are
    narrating numbers the raw store never produced — distrust every
    long-horizon readout until fixed.  ``payload`` is
    ``downsample_selfcheck(...)`` JSON."""
    doc = json.loads(payload)
    if not doc.get("enabled", False):
        raise AssertionError(
            "no downsample policy on this TSDB — long-horizon queries are "
            "serving raw decode only (enable DownsamplePolicy to get tiers)"
        )
    tiers = doc.get("tiers", {})
    empty = sorted(t for t, e in tiers.items() if e.get("buckets", 0) <= 0)
    if not tiers or empty:
        raise AssertionError(
            "rollup tier(s) hold no sealed buckets: "
            + (", ".join(empty) or "(none configured)")
            + " — compaction is not running (pipeline younger than "
            "step+horizon, or the downsampler lost its append/evict hooks)"
        )
    disagree = [
        f"{a['name']}@{a['tier']}"
        for a in doc.get("agreement", [])
        if a.get("served") and not a.get("agree")
    ]
    if not doc.get("agree_all", True) or disagree:
        raise AssertionError(
            "rollup fold DISAGREES with the raw twin for: "
            + (", ".join(disagree) or "(unreported windows)")
            + " — long-horizon rollup reads are not faithful to raw history"
        )
    served = doc.get("windows_served", 0)
    if served <= 0:
        raise AssertionError(
            f"no tier-aligned window could be differentially verified "
            f"({doc.get('windows_skipped', 0)} skipped): rollup coverage "
            "never overlaps raw retention — probe from a DB whose raw "
            "window still holds compacted points"
        )
    tier_bits = ", ".join(
        f"{label} {e.get('buckets', 0)} bucket(s)/"
        f"{e.get('bytes', 0)} B (lag "
        + (
            f"{e['coverage_lag_s']:.0f}s"
            if e.get("coverage_lag_s") is not None
            else "n/a"
        )
        + ")"
        for label, e in sorted(tiers.items())
    )
    return (
        f"{served} aligned window(s) rollup==raw twin; {tier_bits}"
    )


def check_capacity_pool(payload: str) -> str:
    """The capacity economy's health (control/capacity.py): the pool's
    accounting conserved (used + free == capacity, no boundary violation)
    at every tick of a small crunch, and a preemption taking its victim
    round to Running again (pending, admitted, preempted, readmitted).  A
    broken conservation means devices leaked or were booked twice, so every
    placement after it is suspect; a missing round trip means eviction
    with grace deletes victims instead of queueing them again.
    ``payload`` is ``capacity_selfcheck()`` as JSON."""
    doc = json.loads(payload)
    if not doc.get("conserved_all", False) or doc.get("violations"):
        broken = doc.get("violations", [])
        raise AssertionError(
            "pool accounting NOT conserved across "
            f"{doc.get('ticks', 0)} tick(s): "
            + ("; ".join(broken[:3]) or "used + free != capacity")
            + " — chips leaked or double-booked; distrust every placement"
        )
    if not doc.get("preemption_roundtrip", False):
        raise AssertionError(
            "no preemption round-tripped its victim back to Running "
            f"({doc.get('preemptions_total', 0)} preemption(s) recorded) — "
            "eviction-with-grace is losing victims instead of re-queueing"
        )
    if doc.get("lo_running", 0) < 1 or doc.get("hi_running", 0) < 1:
        raise AssertionError(
            "crunch did not converge: lo_running="
            f"{doc.get('lo_running', 0)}, hi_running={doc.get('hi_running', 0)}"
            " — the provisioned node never re-admitted the victim"
        )
    return (
        f"pool conserved over {doc['ticks']} tick(s), "
        f"{doc['preemptions_total']} preemption(s) round-tripped to Running"
    )


def check_custom_metrics_api(payload: str, metric: str) -> str:
    """L4 joint: the aggregated API lists the metric (README.md:98-102)."""
    doc = json.loads(payload)
    names = {r.get("name", "") for r in doc.get("resources", [])}
    if not any(metric in n for n in names):
        raise AssertionError(
            f"{metric} not in custom.metrics.k8s.io discovery "
            f"({len(names)} resources); adapter rules config is broken or the "
            "series has gone stale upstream"
        )
    return f"{metric} discoverable among {len(names)} resources"


def check_hpa_status(payload: str) -> str:
    """L5 joint: the HPA read the metric (ScalingActive true)."""
    doc = json.loads(payload)
    conditions = {c["type"]: c for c in doc.get("status", {}).get("conditions", [])}
    active = conditions.get("ScalingActive")
    if active is None:
        raise AssertionError("HPA has no ScalingActive condition yet")
    if active.get("status") != "True":
        raise AssertionError(
            f"ScalingActive={active.get('status')}: {active.get('reason')} — "
            f"{active.get('message')}"
        )
    cur = doc.get("status", {}).get("currentReplicas")
    des = doc.get("status", {}).get("desiredReplicas")
    return f"ScalingActive, replicas current={cur} desired={des}"


def check_alerts(payload: str) -> str:
    """After the joints: Prometheus's alerts (``/api/v1/alerts``).  A firing
    ``Tpu*`` alert is a diagnosis even when every joint answered, e.g. one
    node's exporter down in a fleet whose other exporter the L2 probe read."""
    doc = json.loads(payload)
    firing = sorted(
        a["labels"].get("alertname", "?")
        for a in doc.get("data", {}).get("alerts", [])
        if a.get("state") == "firing" and a["labels"].get("alertname", "").startswith("Tpu")
    )
    if firing:
        raise AssertionError(f"pipeline alerts firing: {', '.join(firing)}")
    return "no pipeline alerts firing"


def check_operator_metrics(text: str) -> str:
    """The quantum operator's own report (its ``/metrics`` on the health
    port).  Serving the counters shows the reconcile loop alive; a
    ``partial_slice_held`` sample at 1 is a diagnosis itself: stranded
    hosts running and serving nothing (the steady hold of
    control/operator.py), whose remedy the TpuSliceHeldPartial alert
    states: make the HPA's replica bounds slice multiples."""
    families = {f.name: f for f in parse_text(text)}
    reconciles_fam = families.get("quantum_operator_reconciles_total")
    if reconciles_fam is None or not reconciles_fam.samples:
        raise AssertionError(
            "no quantum_operator_reconciles_total sample served — not the "
            "operator's /metrics endpoint, or a truncated scrape?"
        )
    reconciles = int(reconciles_fam.samples[0].value)
    held_fam = families.get("quantum_operator_partial_slice_held")
    held = [
        dict(s.labels).get("target", "?")
        for s in (held_fam.samples if held_fam is not None else [])
        if s.value > 0
    ]
    if held:
        raise AssertionError(
            f"partial slice held on {', '.join(held)}: stranded hosts are "
            "running but serving nothing — make the HPA's minReplicas/"
            "maxReplicas slice multiples"
        )
    return f"operator alive ({reconciles} reconcile passes), no partial slice held"


def diagnose(
    exporter_fetch: Callable[[], str] | None = None,
    prom_fetch: Callable[[], str] | None = None,
    api_fetch: Callable[[], str] | None = None,
    hpa_fetch: Callable[[], str] | None = None,
    metric: str = "tpu_test_tensorcore_avg",
    alerts_fetch: Callable[[], str] | None = None,
    operator_fetch: Callable[[], str] | None = None,
    up_fetch: Callable[[], str] | None = None,
    self_metrics_fetch: Callable[[], str] | None = None,
    self_exposition_fetch: Callable[[], str] | None = None,
    shards_fetch: Callable[[], str] | None = None,
    planner_fetch: Callable[[], str] | None = None,
    downsample_fetch: Callable[[], str] | None = None,
    capacity_fetch: Callable[[], str] | None = None,
) -> list[ProbeResult]:
    """Run the ordered joint probes, stopping at the first failure (the
    runbook's discipline).  Fetchers set to None are skipped."""

    def probe(name: str, description: str, check: Callable[[str], str],
              fetch: Callable[[], str] | None) -> Probe:
        return Probe(name, description, (lambda: check(fetch())) if fetch else None)

    probes = [
        probe("L2 exporter", "per-chip gauges fresh with node/pod attribution",
              check_exporter_text, exporter_fetch),
        probe("L3 prometheus", f"recorded series {metric} exists and is object-addressed",
              lambda p: check_prom_vector(p, metric), prom_fetch),
        probe("L3 scrape health", "every scrape target serving (up==1)",
              check_scrape_up, up_fetch),
        probe("L3 shard topology",
              "every scraper shard reachable, target sets disjoint, union covers fleet",
              check_shards, shards_fetch),
        probe("L3 self-metrics", "pipeline self-metric families present and fresh",
              check_self_metrics, self_metrics_fetch),
        probe("L3 histogram conformance",
              "self-histograms cumulative, +Inf == _count, _sum consistent",
              check_histograms, self_exposition_fetch),
        probe("L3 query planner",
              "planned rule evaluation bit-agrees with naive, fast path live",
              check_query_planner, planner_fetch),
        probe("L3 rollup tiers",
              "downsample tiers hold buckets, rollup folds bit-agree with raw",
              check_downsampling, downsample_fetch),
        probe("capacity pool",
              "slice pool conserved every tick, preemptions round-trip victims",
              check_capacity_pool, capacity_fetch),
        probe("L4 custom-metrics API", f"{metric} discoverable on custom.metrics.k8s.io",
              lambda p: check_custom_metrics_api(p, metric), api_fetch),
        probe("L5 HPA", "HPA is reading the metric (ScalingActive)",
              check_hpa_status, hpa_fetch),
        probe("quantum operator", "operator self-metrics live, no partial slice held",
              check_operator_metrics, operator_fetch),
        probe("alerts", "no tpu-pipeline-alerts firing", check_alerts, alerts_fetch),
    ]
    results: list[ProbeResult] = []
    for p in probes:
        if p.run is None:
            results.append(ProbeResult(p.name, True, "skipped (no fetcher)"))
            continue
        try:
            detail = p.run()
        except Exception as e:  # noqa: BLE001 — any failure is a diagnosis
            results.append(ProbeResult(p.name, False, f"{p.description}: {e}"))
            break  # don't advance past a failing probe
        results.append(ProbeResult(p.name, True, detail))
    return results


def _gpm(lib: nvml.Nvml, handle: int, i: int) -> None:
    """GPM on device ``i``: whether it is advertised, and what one pair of
    samples gives.  Every answer is a finding; none is a failure."""
    if not lib.has_gpm:
        print(f"[-- ] device {i}: GPM: the library exports no GPM function "
              "(a driver before R520): no bandwidth gauge")
        return
    try:
        supported = lib.gpm_supported(handle)
    except nvml.NvmlError as e:
        print(f"[-- ] device {i}: GPM support query refused: {e}")
        return
    print(f"[-- ] device {i}: GPM advertised: {supported}")
    if not supported:
        return
    samples: list[int] = []
    try:
        samples = [lib.gpm_sample_alloc(), lib.gpm_sample_alloc()]
        lib.gpm_sample_get(handle, samples[0])
        time.sleep(0.1)
        lib.gpm_sample_get(handle, samples[1])
        bw = lib.gpm_dram_bw_util(samples[0], samples[1])
        print(f"[-- ] device {i}: GPM sample served: DRAM bandwidth {bw:.2f}% of peak")
    except nvml.NvmlError as e:
        print(f"[-- ] device {i}: GPM sample refused ({e}): the exporter serves "
              "no bandwidth gauge on this node")
    finally:
        for sample in samples:
            lib.gpm_sample_free(sample)


def _mib(mem: nvml.MemoryV2) -> str:
    return f"{mem.used / 2**20:.0f} of {mem.total / 2**20:.0f}"


def probe_nvml(library: str = nvml.DEFAULT_LIBRARY) -> int:
    """Call every NVML function the node exporter's ``NvmlSource`` calls,
    on every device of the host, through ``exporter/nvml.py``: the device
    count, the handle by index and by UUID, the index, the UUID,
    utilization, memory, temperature and power.  Prints each answer; exit
    code 0 only when every call answered, 1 otherwise.  GPM is probed too
    (advertised, and one pair of samples), and its refusal is printed as a
    finding: it costs the bandwidth gauge, not the exporter."""
    try:
        lib = nvml.Nvml(library)
        lib.init()
    except (OSError, nvml.NvmlError) as e:
        print(f"[FAIL] NVML not usable from {library}: {e}")
        return 1
    failures = 0

    def call(what: str, fn: Callable[[], object]) -> object:
        nonlocal failures
        try:
            value = fn()
        except nvml.NvmlError as e:
            failures += 1
            print(f"[FAIL] {what}: {e}")
            return None
        print(f"[ok ] {what}: {value}")
        return value

    try:
        count = call("nvmlDeviceGetCount_v2", lib.device_count)
        for i in range(count or 0):
            handle = call(f"device {i}: nvmlDeviceGetHandleByIndex_v2",
                          lambda i=i: lib.handle_by_index(i))
            if handle is None:
                continue
            call(f"device {i}: nvmlDeviceGetIndex", lambda: lib.index(handle))
            uuid = call(f"device {i}: nvmlDeviceGetUUID", lambda: lib.uuid(handle))
            if uuid is not None:
                call(f"device {i}: nvmlDeviceGetHandleByUUID -> index",
                     lambda: lib.index(lib.handle_by_uuid(uuid)))
            call(f"device {i}: nvmlDeviceGetUtilizationRates (gpu %)",
                 lambda: lib.utilization(handle).gpu)
            call(f"device {i}: nvmlDeviceGetMemoryInfo_v2 (MiB used of total)",
                 lambda: _mib(lib.memory(handle)))
            call(f"device {i}: nvmlDeviceGetTemperature (C)", lambda: lib.temperature_c(handle))
            call(f"device {i}: nvmlDeviceGetPowerUsage (W)", lambda: lib.power_mw(handle) / 1000.0)
            _gpm(lib, handle, i)
    finally:
        lib.shutdown()
    if failures:
        print(f"\n{failures} NVML call(s) failed: the node exporter cannot serve this host")
        return 1
    if not count:
        print("\nNVML answered but sees no GPU on this host")
        return 1
    print(f"\nNVML answered every call the node exporter makes, on {count} device(s)")
    return 0


def _http_fetch(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def _kubectl_raw(path: str) -> str:
    return subprocess.run(
        ["kubectl", "get", "--raw", path], check=True, capture_output=True, text=True
    ).stdout


def main() -> int:
    """The runbook's probes against a cluster, from the environment."""
    exporter_url = os.environ.get("EXPORTER_URL", "http://localhost:9400/metrics")
    prom_url = os.environ.get("PROM_URL", "http://localhost:9090")
    metric = os.environ.get("METRIC", "tpu_test_tensorcore_avg")
    namespace = os.environ.get("NAMESPACE", "default")
    hpa_name = os.environ.get("HPA", "tpu-test")
    have_kubectl = shutil.which("kubectl") is not None
    results = diagnose(
        exporter_fetch=lambda: _http_fetch(exporter_url),
        prom_fetch=lambda: _http_fetch(f"{prom_url}/api/v1/query?query={quote(metric)}"),
        api_fetch=(
            (lambda: _kubectl_raw("/apis/custom.metrics.k8s.io/v1beta1"))
            if have_kubectl else None
        ),
        hpa_fetch=(
            (lambda: _kubectl_raw(
                f"/apis/autoscaling/v2/namespaces/{namespace}/horizontalpodautoscalers/{hpa_name}"
            ))
            if have_kubectl else None
        ),
        metric=metric,
        alerts_fetch=lambda: _http_fetch(f"{prom_url}/api/v1/alerts"),
        up_fetch=lambda: _http_fetch(f"{prom_url}/api/v1/query?query=up"),
        # the operator is deployed beside the multihost rungs only:
        # OPERATOR_URL opts in (after `kubectl port-forward
        # deploy/quantum-operator 8086`)
        operator_fetch=(
            (lambda: _http_fetch(os.environ["OPERATOR_URL"]))
            if os.environ.get("OPERATOR_URL") else None
        ),
        # the capacity economy runs in the simulator, not in a cluster:
        # CAPACITY_SELFCHECK=1 runs its small crunch in process
        capacity_fetch=(
            (lambda: json.dumps(capacity_selfcheck()))
            if os.environ.get("CAPACITY_SELFCHECK") else None
        ),
        # the self-metric families exist only where the pipeline's
        # pipeline-self target is scraped: SELF_METRICS=1 opts in
        self_metrics_fetch=(
            (lambda: _http_fetch(f"{prom_url}/api/v1/query?query={quote(SELF_METRICS_QUERY)}"))
            if os.environ.get("SELF_METRICS") else None
        ),
    )
    broken = False
    for r in results:
        print(f"[{'ok ' if r.ok else 'FAIL'}] {r.name}: {r.detail}")
        broken = broken or not r.ok
    if broken:
        print(
            "\npipeline broken at the first FAILing joint above; fix it "
            "before looking further down the stack (each layer only consumes "
            "the one below)"
        )
    return 1 if broken else 0


def cli(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m k8s_gpu_hpa_tpu_torch.doctor")
    parser.add_argument("probe", nargs="?", choices=["nvml"],
                        help="nvml: probe this host's NVML instead of the cluster's joints")
    parser.add_argument("--library", default=nvml.DEFAULT_LIBRARY,
                        help="the NVML library to load (probe nvml)")
    args = parser.parse_args(argv)
    return probe_nvml(args.library) if args.probe == "nvml" else main()


if __name__ == "__main__":
    sys.exit(cli())
