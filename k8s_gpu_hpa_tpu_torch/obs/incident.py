"""Incident correlation: tie each page to the causes that explain it.

Counterpart of ``k8s_gpu_hpa_tpu/obs/incident.py``.  A page without a story
is half an alerting plane.  This module takes the router's notification
log (obs/alerting.py) and the run's evidence (chaos fault windows as
RecoveryReport dicts with their span ids, SLO burn alerts riding in the
page itself, scale events, the capacity scheduler's denials and the region
evacuation's decisions) and builds one incident record a page: an id, the
paged group, and a causal chain ordered on virtual time.
``simulate --scenario incident --why INC-002`` prints that chain as a
postmortem timeline.

Everything here is pure over JSON-able dicts, as evaluate_crunch_contract
and render_evacuation_why are: the chaos harness (chaos/paging.py)
gathers the evidence, and this module never imports it.

The paging contract (exit 2 in the CLI, gated by
``trial.paging_bench_rung``):

- every page must be **attributable**: at least one cause of a root-cause
  kind (fault window, SLO burn, capacity denial or evacuation decision) in
  its evidence window; scale events alone are lineage, not cause;
- the log must hold **no uninhibited duplicate page**
  (:func:`~k8s_gpu_hpa_tpu_torch.obs.alerting.notification_log_violations`),
  which the planted ``--break-inhibition`` canary trips.
"""

from __future__ import annotations

from k8s_gpu_hpa_tpu_torch.obs import coverage
from k8s_gpu_hpa_tpu_torch.obs.alerting import notification_log_violations
from k8s_gpu_hpa_tpu_torch.obs.latency import percentile

#: how far before a page's oldest firing alert the correlator still accepts
#: evidence — covers detection lag (monitor granularity + alert for_seconds)
EVIDENCE_SLACK_S = 60.0

#: cause kinds that make a page attributable; "scale_event" is
#: deliberately absent (lineage context, not a root cause)
ROOT_CAUSE_KINDS = (
    "fault_window",
    "slo_burn",
    "capacity_denial",
    "evacuation",
)

#: capacity-scheduler event types the correlator treats as denial evidence
CAPACITY_DENIAL_EVENTS = ("fair_share_limited", "preempted", "denied")


def _page_window(page: dict, slack: float = EVIDENCE_SLACK_S) -> tuple[float, float]:
    """The evidence window of a page: from ``slack`` before its oldest
    firing alert up to the page itself."""
    oldest = min(
        (a["active_since"] for a in page["alerts"] if a["active_since"] is not None),
        default=page["t"],
    )
    return (oldest - slack, page["t"])


def _fault_end(fw: dict, slack: float = EVIDENCE_SLACK_S) -> float:
    """A fault window's effective end for attribution: recovery when the
    monitor saw one, else clearing plus slack (the pipeline is still
    digesting), else open-ended."""
    if fw.get("recovered_at") is not None:
        return fw["recovered_at"]
    if fw.get("cleared_at") is not None:
        return fw["cleared_at"] + slack
    return float("inf")


def correlate(pages: list[dict], evidence: dict) -> list[dict]:
    """Build one IncidentRecord dict per page notification.

    ``evidence`` keys (each optional, every row a plain dict/tuple):

    - ``faults``: RecoveryReport.as_dict rows (fault windows; span ids);
    - ``scale_events``: ``(t, from, to)`` rows from a pipeline's
      scale_history;
    - ``capacity_events``: CapacityScheduler ``events`` rows
      (``{"t", "tenant", "event", ...}``);
    - ``evacuation_decisions``: GlobalControlPlane ``decision_log`` rows.
    """
    faults = evidence.get("faults") or []
    scale_events = evidence.get("scale_events") or []
    capacity_events = evidence.get("capacity_events") or []
    decisions = evidence.get("evacuation_decisions") or []
    incidents: list[dict] = []
    for page in pages:
        start, end = _page_window(page)
        causes: list[dict] = []
        for fw in faults:
            injected = fw.get("injected_at")
            if injected is None:
                continue
            if injected <= end and _fault_end(fw) >= start:
                coverage.hit("alerting:cause_fault_window")
                causes.append(
                    {
                        "kind": "fault_window",
                        "t": injected,
                        "summary": f"fault {fw['fault']} ({fw['kind']}) injected",
                        "ref": fw.get("trace_span_id"),
                        "fault": fw["fault"],
                    }
                )
        for alert in page["alerts"]:
            if "burn" in alert["labels"]:
                coverage.hit("alerting:cause_slo_burn")
                causes.append(
                    {
                        "kind": "slo_burn",
                        "t": alert["active_since"],
                        "summary": (
                            f"SLO {alert['labels'].get('slo', '?')} "
                            f"{alert['labels']['burn']}-burn alert "
                            f"{alert['name']} firing"
                        ),
                        "ref": None,
                        "alert": alert["name"],
                    }
                )
        for t, before, after in scale_events:
            if start <= t <= end:
                coverage.hit("alerting:cause_scale_event")
                causes.append(
                    {
                        "kind": "scale_event",
                        "t": t,
                        "summary": f"scaled {before} -> {after} replicas",
                        "ref": None,
                    }
                )
        for row in capacity_events:
            if row.get("event") in CAPACITY_DENIAL_EVENTS and start <= row["t"] <= end:
                coverage.hit("alerting:cause_capacity_denial")
                causes.append(
                    {
                        "kind": "capacity_denial",
                        "t": row["t"],
                        "summary": (
                            f"capacity scheduler {row['event']} for tenant "
                            f"{row.get('tenant', '?')}"
                        ),
                        "ref": None,
                        "tenant": row.get("tenant"),
                    }
                )
        for row in decisions:
            if start <= row["t"] <= end:
                coverage.hit("alerting:cause_evacuation")
                verdict = "denied" if row.get("denied") else "admitted"
                causes.append(
                    {
                        "kind": "evacuation",
                        "t": row["t"],
                        "summary": (
                            f"evacuation spill {verdict}: {row.get('replicas')}"
                            f" x {row.get('tenant')} {row.get('from')} -> "
                            f"{row.get('to') or '(nowhere)'}"
                        ),
                        "ref": None,
                        "tenant": row.get("tenant"),
                    }
                )
        causes.sort(key=lambda c: (c["t"], c["kind"], c["summary"]))
        attributed = any(c["kind"] in ROOT_CAUSE_KINDS for c in causes)
        coverage.hit("alerting:incident_opened")
        if attributed:
            coverage.hit("alerting:incident_attributed")
        else:
            coverage.hit("alerting:incident_unattributed")
        incidents.append(
            {
                "id": f"INC-{len(incidents) + 1:03d}",
                "opened_at": page["t"],
                "page_seq": page["seq"],
                "group": page["group"],
                "alerts": page["alerts"],
                "causes": causes,
                "attributed": attributed,
            }
        )
    return incidents


def score_paging(
    faults: list[dict],
    incidents: list[dict],
    log: list[dict],
    repeat_interval: float,
) -> dict:
    """Paging quality against injected-fault ground truth.

    - **recall**: fraction of injected faults covered by at least one
      attributed notification (page or repeat) inside the fault's window —
      ``trial.paging_bench_rung`` requires 1.0;
    - **time_to_page**: per covered fault, injection to the first covering
      notification; p50/p95/max reported;
    - **precision**: attributed pages / all pages;
    - **violations**: uninhibited duplicate pages + dedup regressions.

    Coverage uses *notifications with the fault attributed as a cause*
    (correlate() already did the window math), so a fault that pages late
    via a ``repeat`` while the group never resolved still counts — at its
    honest, larger time-to-page.
    """
    covering: dict[str, list[float]] = {}
    attributed_pages = 0
    for inc in incidents:
        if inc["attributed"]:
            attributed_pages += 1
        for cause in inc["causes"]:
            if cause["kind"] == "fault_window":
                covering.setdefault(cause["fault"], []).append(inc["opened_at"])
    # repeats re-page a still-firing group; credit them to any fault whose
    # window they land in (the correlator only ran over first pages)
    fault_rows = {f["fault"]: f for f in faults if f.get("injected_at") is not None}
    for entry in log:
        if entry["kind"] != "repeat":
            continue
        for name, fw in fault_rows.items():
            if fw["injected_at"] <= entry["t"] <= _fault_end(fw):
                covering.setdefault(name, []).append(entry["t"])
    uncovered: list[str] = []
    latencies: list[float] = []
    for name, fw in fault_rows.items():
        times = [t for t in covering.get(name, []) if t >= fw["injected_at"]]
        if not times:
            uncovered.append(name)
        else:
            latencies.append(min(times) - fw["injected_at"])
    pages_total = len(incidents)
    recall = (
        1.0
        if not fault_rows
        else (len(fault_rows) - len(uncovered)) / len(fault_rows)
    )
    precision = 1.0 if pages_total == 0 else attributed_pages / pages_total
    return {
        "faults_total": len(fault_rows),
        "uncovered_faults": sorted(uncovered),
        "recall": round(recall, 4),
        "pages_total": pages_total,
        "attributed_pages": attributed_pages,
        "precision": round(precision, 4),
        "time_to_page_s": {
            "p50": percentile(latencies, 50.0),
            "p95": percentile(latencies, 95.0),
            "max": percentile(latencies, 100.0),
        },
        "violations": notification_log_violations(log, repeat_interval),
        "unattributed_incidents": [
            i["id"] for i in incidents if not i["attributed"]
        ],
    }


# ---------------------------------------------------------------------------
# rendering


def render_incident_report(result: dict) -> str:
    """The ``simulate incident`` summary: score card plus one line per
    incident."""
    score = result["score"]
    ttp = score["time_to_page_s"]

    def fmt(x) -> str:
        return "-" if x is None else f"{x:.0f}s"

    lines = [
        f"incident drill: scenario={result['scenario']} "
        f"pages={score['pages_total']} incidents={len(result['incidents'])}",
        "",
        f"recall:        {score['recall']:.2f} "
        f"({score['faults_total'] - len(score['uncovered_faults'])}"
        f"/{score['faults_total']} faults paged)",
        f"precision:     {score['precision']:.2f} "
        f"({score['attributed_pages']}/{score['pages_total']} pages attributed)",
        f"time-to-page:  p50={fmt(ttp['p50'])} p95={fmt(ttp['p95'])} "
        f"max={fmt(ttp['max'])}",
        f"violations:    {len(score['violations'])}",
        "",
        f"{'incident':<9} {'paged at':>9} {'alerts':>7} {'causes':>7}  group",
    ]
    for inc in result["incidents"]:
        group = ",".join(f"{k}={v}" for k, v in sorted(inc["group"].items()) if v)
        flag = "" if inc["attributed"] else "  UNATTRIBUTED"
        lines.append(
            f"{inc['id']:<9} {inc['opened_at']:>8.0f}s "
            f"{len(inc['alerts']):>7} {len(inc['causes']):>7}  {group}{flag}"
        )
    for v in score["violations"]:
        lines.append(
            f"VIOLATION: {v['kind']} at {v['t']:.0f}s "
            f"(seq {v['seq']}, group {v['group']})"
        )
    return "\n".join(lines)


def render_incident_why(result: dict, incident_id: str) -> str:
    """Replay one incident's causal chain as a postmortem timeline — the
    ``simulate incident --why INC-00N`` view, the alerting analog of
    ``simulate evacuate --why``."""
    inc = next(
        (i for i in result["incidents"] if i["id"] == incident_id), None
    )
    if inc is None:
        known = ", ".join(i["id"] for i in result["incidents"]) or "(none)"
        return f"no incident {incident_id!r} in this run (known: {known})"
    group = ",".join(f"{k}={v}" for k, v in sorted(inc["group"].items()) if v)
    lines = [
        f"{inc['id']}: paged at {inc['opened_at']:.0f}s  group {group}",
        f"attributed: {'yes' if inc['attributed'] else 'NO — exit-2 contract'}",
        "",
        "timeline:",
    ]
    events: list[tuple[float, str]] = []
    for cause in inc["causes"]:
        ref = f"  [span {cause['ref']}]" if cause.get("ref") is not None else ""
        events.append((cause["t"], f"{cause['kind']:<16} {cause['summary']}{ref}"))
    for alert in inc["alerts"]:
        labels = ",".join(f"{k}={v}" for k, v in sorted(alert["labels"].items()))
        events.append(
            (
                alert["active_since"],
                f"{'alert_firing':<16} {alert['name']}{{{labels}}}",
            )
        )
    events.append((inc["opened_at"], f"{'page':<16} group paged ({inc['id']})"))
    events.sort(key=lambda e: (e[0], e[1]))
    for t, text in events:
        lines.append(f"  {t:>8.1f}s  {text}")
    return "\n".join(lines)
