"""The span schema: one table every trace producer and consumer shares.

Counterpart of ``k8s_gpu_hpa_tpu/obs/schema.py``, whole: all nine kinds,
including those whose producers arrive with later parts of the port
(``fault_window``, ``component_restart``).  Every span the pipeline emits
(obs/trace.py) is validated against this table when it closes, so a stage
cannot grow a private span shape that the lineage walker or the timeline
renderer silently fails to read.

Span kinds map one to one onto the pipeline's layers:

========  =================  ==============================================
layer     kind               emitted by
========  =================  ==============================================
L2        exporter_sample    one fresh collection sweep of a node exporter
L3        scrape             one scrape attempt against one target
L3        rule_eval          one recording-rule evaluation pass
L4        adapter_query      one custom/external-metrics API read
L5        hpa_sync           one HPA sync (always, scale or hold)
L5        scale_event        one actual replica change
—         workload_change    offered-load intensity step (harness-emitted)
—         fault_window       one chaos fault's injected→recovered window
—         component_restart  one control-plane crash+rebuild (WAL replay /
                             checkpoint restore stats)
========  =================  ==============================================

Causality flows through ``links`` (the ids of the spans whose data fed
this one): scale_event → hpa_sync → adapter_query → rule_eval → scrape →
exporter_sample.  ``link_kinds`` declares which kinds a span may link to;
the lineage walker (obs/lineage.py) follows exactly these edges.
"""

from __future__ import annotations

#: kind -> {description, required attrs, optional attrs, allowed link kinds}
SPAN_SCHEMA: dict[str, dict] = {
    "exporter_sample": {
        "description": "one fresh per-node exporter collection sweep "
        "(the raw chip readings every downstream value derives from)",
        "required": frozenset({"node", "chips"}),
        "optional": frozenset(),
        "link_kinds": frozenset(),  # lineage root
    },
    "scrape": {
        "description": "one scrape attempt against one target; links to the "
        "exporter sweep whose cached exposition it ingested",
        "required": frozenset({"target", "ok"}),
        "optional": frozenset({"samples", "error"}),
        "link_kinds": frozenset({"exporter_sample"}),
    },
    "rule_eval": {
        "description": "one recording-rule evaluation; links to every scrape "
        "(or upstream rule_eval) whose points the expression read",
        "required": frozenset({"rule", "samples_out"}),
        "optional": frozenset({"staleness_seconds", "tiers"}),
        "link_kinds": frozenset({"scrape", "rule_eval"}),
    },
    "adapter_query": {
        "description": "one custom/external-metrics API read; links to the "
        "rule evaluations that produced the points served",
        "required": frozenset({"api", "metric", "found"}),
        "optional": frozenset({"value", "duration_seconds"}),
        "link_kinds": frozenset({"rule_eval", "scrape"}),
    },
    "hpa_sync": {
        "description": "one HPA sync pass (emitted on every sync, scale or "
        "hold); links to the adapter queries it issued",
        "required": frozenset(
            {"reason", "current_replicas", "desired_replicas"}
        ),
        "optional": frozenset({"duration_seconds"}),
        "link_kinds": frozenset({"adapter_query"}),
    },
    "scale_event": {
        "description": "one actual replica change; links to the hpa_sync "
        "that decided it — the entry point of every lineage walk",
        "required": frozenset({"from_replicas", "to_replicas"}),
        "optional": frozenset(),
        "link_kinds": frozenset({"hpa_sync"}),
    },
    "workload_change": {
        "description": "offered-load intensity step, emitted by the harness "
        "(obs/latency.py TracedLoad) — the start pin of every "
        "signal-propagation measurement",
        "required": frozenset({"intensity"}),
        "optional": frozenset({"previous"}),
        "link_kinds": frozenset(),
    },
    "fault_window": {
        "description": "one chaos fault's injected→recovered window "
        "(chaos/schedule.py); span start/end ARE the degraded window, so "
        "the RecoveryReport's MTTR is backed by the trace",
        "required": frozenset({"fault", "kind"}),
        "optional": frozenset(
            {"detected_at", "mttr", "replay_gap", "time_to_first_good_sync"}
        ),
        "link_kinds": frozenset(),
    },
    "component_restart": {
        "description": "one control-plane component torn down and rebuilt "
        "from durable state (loop.restart_*): WAL replay stats for the "
        "TSDB, checkpoint-restore flag for the HPA — the marker that keeps "
        "a trace explicable across a restart boundary",
        "required": frozenset({"component"}),
        "optional": frozenset(
            {
                "snapshot_restored",
                "recovered_series",
                "recovered_points",
                "replayed_records",
                "dropped_records",
                "replay_gap_seconds",
                "checkpoint_restored",
            }
        ),
        "link_kinds": frozenset(),
    },
}

#: lineage hop order, decision-side first — the order the timeline renderer
#: and the lineage walker present hops in
LINEAGE_ORDER = (
    "scale_event",
    "hpa_sync",
    "adapter_query",
    "rule_eval",
    "scrape",
    "exporter_sample",
)


def validate_span_fields(
    kind: str, attrs: dict, *, span_id: int | None = None
) -> None:
    """Raise ValueError when ``kind``/``attrs`` do not match the schema —
    unknown kind, missing required attr, or an attr the schema never
    declared (the silent-drift mode this table exists to prevent)."""
    entry = SPAN_SCHEMA.get(kind)
    where = f"span {span_id}" if span_id is not None else "span"
    if entry is None:
        raise ValueError(f"{where}: unknown span kind {kind!r}")
    missing = entry["required"] - attrs.keys()
    if missing:
        raise ValueError(
            f"{where} ({kind}): missing required attrs {sorted(missing)}"
        )
    unknown = attrs.keys() - entry["required"] - entry["optional"]
    if unknown:
        raise ValueError(
            f"{where} ({kind}): attrs {sorted(unknown)} not in schema"
        )
