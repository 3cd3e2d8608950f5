"""Metric lineage: walk a scale event back to the raw exporter sweeps.

Counterpart of ``k8s_gpu_hpa_tpu/obs/lineage.py``.  The link graph
(obs/schema.py) is a DAG rooted at exporter_sample spans; ``lineage_of``
walks it transitively from any span (as a rule a scale_event) and groups
the spans it reaches into ordered hops:

    scale_event → hpa_sync → adapter_query → rule_eval → scrape
                → exporter_sample

Each hop carries its span ids and its range of start times, so the answer
to "why did the HPA scale at t = 75 s?" is a concrete chain: these device
sweeps at t = 73-74, scraped at t = 74, recorded by this rule at t = 74,
served to the adapter and acted on by the sync at t = 75.  ``complete`` is
True when the walk reaches raw exporter samples, the bar every simulated
scale event must meet.  The walk is transitive, so a rule reading another
rule's output needs nothing special: both land in the one ``rule_eval`` hop.
"""

from __future__ import annotations

from k8s_gpu_hpa_tpu_torch.obs.schema import LINEAGE_ORDER
from k8s_gpu_hpa_tpu_torch.obs.trace import Span


def index_spans(spans: list[Span]) -> dict[int, Span]:
    return {s.span_id: s for s in spans}


def lineage_of(span: Span, by_id: dict[int, Span]) -> dict:
    """Transitive closure of ``span`` over its links, grouped into hops.

    Returns ``{"span_id", "hops": [{kind, span_ids, first_ts, last_ts}...],
    "complete"}``; hops come in ``LINEAGE_ORDER`` and only when non-empty.
    A link whose target is missing from ``by_id`` (a truncated export) is
    ignored: the walk degrades to incomplete rather than raising."""
    reached: dict[int, Span] = {}
    frontier = [span]
    while frontier:
        current = frontier.pop()
        if current.span_id in reached:
            continue
        reached[current.span_id] = current
        for link in current.links:
            parent = by_id.get(link)
            if parent is not None:
                frontier.append(parent)
    hops = []
    for kind in LINEAGE_ORDER:
        members = sorted(
            (s for s in reached.values() if s.kind == kind),
            key=lambda s: (s.start, s.span_id),
        )
        if not members:
            continue
        hops.append(
            {
                "kind": kind,
                "span_ids": [s.span_id for s in members],
                "first_ts": members[0].start,
                "last_ts": members[-1].start,
            }
        )
    return {
        "span_id": span.span_id,
        "hops": hops,
        "complete": any(h["kind"] == "exporter_sample" for h in hops),
    }


def format_lineage(lineage: dict) -> str:
    """One line of a lineage walk, decision side first."""
    parts = []
    for hop in lineage["hops"]:
        n = len(hop["span_ids"])
        if hop["first_ts"] == hop["last_ts"]:
            ts = f"t={hop['first_ts']:.0f}s"
        else:
            ts = f"t={hop['first_ts']:.0f}-{hop['last_ts']:.0f}s"
        parts.append(f"{hop['kind']} x{n} ({ts})")
    chain = " <- ".join(parts)
    status = "" if lineage["complete"] else "  [INCOMPLETE: no exporter samples reached]"
    return chain + status
