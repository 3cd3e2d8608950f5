"""Deterministic Alertmanager-style alert routing on virtual time.

Counterpart of ``k8s_gpu_hpa_tpu/obs/alerting.py``.  The rule evaluator
computes each alert's state every tick; this module routes it, removes
duplicates, silences and pages, after the Prometheus Alertmanager's design
cut down to the simulator's rules of determinism:

- **grouping**: firing alert instances (``RuleEvaluator.
  firing_alert_instances()``) are bucketed by a configured subset of their
  labels; one notification covers the whole group;
- **timing**: ``group_wait`` holds back the first page so a burst arrives
  as one notification, ``group_interval`` throttles the updates of a group
  already paged (a flap inside the interval folds into ONE update, never a
  second page), and ``repeat_interval`` pages again a group still firing
  that would otherwise go quiet;
- **silences**: matcher sets with a start and an expiry, read on the shared
  virtual clock;
- **inhibition**: a firing source alert suppresses the matching target
  alerts whose ``equal`` labels agree (a region-dead page inhibits the
  per-tenant unschedulable pages it explains);
- **notification log**: append-only, stamped with virtual time, and
  exported as canonical JSON, the same bytes for two runs of one seed
  (``trial.paging_bench_rung`` holds it to that).

The router is *polled*: ``observe()`` runs from the pipeline's rule tick
(control/loop.py), never from timers of its own: ``VirtualClock.advance``
is not reentrant, and one observation a tick keeps the log's order a pure
function of the scenario.  ``break_inhibition`` arms the mis-inhibition
canary: inhibition is computed but not applied, every page that *should*
have been suppressed is stamped ``would_inhibit > 0``, and
:func:`notification_log_violations` flags it, the planted failure the
paging contract must catch (exit 2).
"""

from __future__ import annotations

import json
import re
import zlib
from dataclasses import dataclass, field

from k8s_gpu_hpa_tpu_torch.obs import coverage

#: self-metric family names (exposed by ``alerting_families``; consumed by
#: the Grafana "Alerting" row — the metrics contract checks both ends)
ALERTING_NOTIFICATIONS_TOTAL = "tpu_sim_alerting_notifications_total"
ALERTING_GROUPS_ACTIVE = "tpu_sim_alerting_groups_active"
ALERTING_SUPPRESSED_TOTAL = "tpu_sim_alerting_suppressed_total"
ALERTING_TIME_TO_PAGE = "tpu_sim_alerting_time_to_page_seconds"
ALERTING_METRIC_NAMES = (
    ALERTING_NOTIFICATIONS_TOTAL,
    ALERTING_GROUPS_ACTIVE,
    ALERTING_SUPPRESSED_TOTAL,
    ALERTING_TIME_TO_PAGE,
)

#: notification kinds, in the order they can occur for one group
NOTIFICATION_KINDS = ("page", "update", "repeat", "resolved")


@dataclass(frozen=True)
class Matcher:
    """One label matcher: ``=`` exact, ``!=`` negated exact, ``=~`` full
    regex match — the Alertmanager matcher subset the sim needs.  The alert
    name is matched as the implicit ``alertname`` label, as in PromQL."""

    name: str
    value: str
    op: str = "="

    def matches(self, labels: dict[str, str]) -> bool:
        actual = labels.get(self.name, "")
        if self.op == "=":
            return actual == self.value
        if self.op == "!=":
            return actual != self.value
        if self.op == "=~":
            return re.fullmatch(self.value, actual) is not None
        raise ValueError(f"unknown matcher op {self.op!r}")


def match_all(matchers: tuple[Matcher, ...], labels: dict[str, str]) -> bool:
    return all(m.matches(labels) for m in matchers)


@dataclass(frozen=True)
class InhibitRule:
    """Suppress target alerts while a source alert fires and every label in
    ``equal`` agrees between the two (Alertmanager ``inhibit_rules``)."""

    source: tuple[Matcher, ...]
    target: tuple[Matcher, ...]
    equal: tuple[str, ...] = ()

    def inhibits(self, source_labels: dict, target_labels: dict) -> bool:
        if source_labels is target_labels:
            return False  # an alert never inhibits itself
        if not match_all(self.source, source_labels):
            return False
        if not match_all(self.target, target_labels):
            return False
        return all(
            source_labels.get(k) == target_labels.get(k) for k in self.equal
        )


@dataclass
class Silence:
    """A matcher set with a validity window; alerts matching ALL matchers
    are dropped before grouping while ``starts_at <= now < ends_at``."""

    silence_id: str
    matchers: tuple[Matcher, ...]
    starts_at: float
    ends_at: float
    created_by: str = ""
    comment: str = ""

    def active(self, now: float) -> bool:
        return self.starts_at <= now < self.ends_at

    def matches(self, labels: dict[str, str]) -> bool:
        return match_all(self.matchers, labels)


def _full_labels(instance: dict) -> dict[str, str]:
    """The matchable label set: declared labels plus the implicit
    ``alertname``, the same convention Alertmanager matchers use."""
    labels = dict(instance["labels"])
    labels["alertname"] = instance["name"]
    return labels


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _fingerprint(alerts: list[dict]) -> str:
    """Stable fingerprint of a group's alert set: identical alert
    membership (name + labels + active-since) → identical fingerprint."""
    basis = [
        {
            "name": a["name"],
            "labels": a["labels"],
            "active_since": a["active_since"],
        }
        for a in alerts
    ]
    return f"{zlib.crc32(_canon(basis).encode()):08x}"


def _identity(alert: dict) -> tuple:
    return (alert["name"], tuple(sorted(alert["labels"].items())))


@dataclass
class _Group:
    """Per-group-key router state (one Alertmanager aggregation group)."""

    key: tuple[tuple[str, str], ...]
    first_seen: float
    #: current firing membership, refreshed every observe
    alerts: list[dict] = field(default_factory=list)
    paged: bool = False
    last_notified_at: float | None = None
    last_sent_fingerprint: str | None = None
    #: identity -> active_since as of the last notification, for flap
    #: detection (same identity back with a new active_since = a re-fire
    #: coalesced into the next update instead of a fresh page)
    last_sent_since: dict[tuple, float] = field(default_factory=dict)


class AlertRouter:
    """Deterministic notification router over labeled alert instances.

    ``observe(instances)`` is called once per rule-eval tick with the
    evaluator's current ``firing_alert_instances()``; everything else —
    waiting out ``group_wait``, update throttling, repeats, expiry — is
    derived from the virtual clock at observation time.  The notification
    log is append-only; :meth:`export_json` is canonical and bit-identical
    for same-seed runs."""

    def __init__(
        self,
        clock,
        group_by: tuple[str, ...] = ("alertname", "severity"),
        group_wait: float = 15.0,
        group_interval: float = 60.0,
        repeat_interval: float = 600.0,
        inhibit_rules: tuple[InhibitRule, ...] = (),
        silences: tuple[Silence, ...] = (),
        break_inhibition: bool = False,
    ):
        self.clock = clock
        self.group_by = tuple(group_by)
        self.group_wait = group_wait
        self.group_interval = group_interval
        self.repeat_interval = repeat_interval
        self.inhibit_rules = tuple(inhibit_rules)
        self.silences = list(silences)
        self.break_inhibition = break_inhibition
        #: append-only notification log (dicts; see _notify for the shape)
        self.log: list[dict] = []
        self._groups: dict[tuple, _Group] = {}
        self._seq = 0
        self.silenced_total = 0
        self.inhibited_total = 0
        self.flaps_coalesced = 0
        #: seconds from an alert turning firing to its group's first page,
        #: one entry per page (feeds the time-to-page self-metric)
        self.page_latencies: list[float] = []

    def add_silence(self, silence: Silence) -> None:
        self.silences.append(silence)

    # ------------------------------------------------------------------
    # observation

    def observe(self, instances: list[dict]) -> None:
        now = self.clock.now()
        labeled = [
            {**i, "_full": _full_labels(i)}
            for i in instances
            if i.get("active_since") is not None
        ]
        active = self._drop_silenced(labeled, now)
        active, would_inhibit = self._apply_inhibition(active)
        self._regroup(active, would_inhibit)
        self._flush(now)

    def _drop_silenced(self, labeled: list[dict], now: float) -> list[dict]:
        out = []
        for inst in labeled:
            if any(
                s.active(now) and s.matches(inst["_full"])
                for s in self.silences
            ):
                self.silenced_total += 1
                coverage.hit("alerting:silenced")
            else:
                out.append(inst)
        return out

    def _apply_inhibition(
        self, active: list[dict]
    ) -> tuple[list[dict], set[tuple]]:
        """Partition the active set into routed alerts and inhibited ones.
        Returns (routed, identities-that-would-be-inhibited): under
        ``break_inhibition`` nothing is actually removed, but the would-be
        set still stamps the resulting notifications so the paging gate can
        prove the canary run emits uninhibited duplicate pages."""
        would: set[tuple] = set()
        for target in active:
            for rule in self.inhibit_rules:
                if any(
                    rule.inhibits(source["_full"], target["_full"])
                    for source in active
                ):
                    would.add(_identity(target))
                    break
        if self.break_inhibition:
            return active, would
        routed = []
        for inst in active:
            if _identity(inst) in would:
                self.inhibited_total += 1
                coverage.hit("alerting:inhibited")
            else:
                routed.append(inst)
        return routed, set()

    def _group_key(self, inst: dict) -> tuple[tuple[str, str], ...]:
        labels = inst["_full"]
        return tuple((k, labels.get(k, "")) for k in self.group_by)

    def _regroup(self, active: list[dict], would_inhibit: set[tuple]) -> None:
        now = self.clock.now()
        by_key: dict[tuple, list[dict]] = {}
        for inst in active:
            by_key.setdefault(self._group_key(inst), []).append(inst)
        for key, members in by_key.items():
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(key=key, first_seen=now)
                coverage.hit("alerting:group_waiting")
            group.alerts = sorted(
                (
                    {
                        "name": m["name"],
                        "labels": dict(m["labels"]),
                        "active_since": m["active_since"],
                        "would_inhibit": _identity(m) in would_inhibit,
                    }
                    for m in members
                ),
                key=lambda a: (a["name"], sorted(a["labels"].items())),
            )
        for key, group in self._groups.items():
            if key not in by_key:
                group.alerts = []

    # ------------------------------------------------------------------
    # notification emission

    def _flush(self, now: float) -> None:
        expired = []
        for key in sorted(self._groups):
            group = self._groups[key]
            if not group.paged:
                if not group.alerts:
                    # resolved before group_wait elapsed: nothing was ever
                    # sent, so nothing to resolve — the group just expires
                    expired.append(key)
                elif now - group.first_seen >= self.group_wait:
                    self._notify(group, "page", now)
            else:
                due = now - (group.last_notified_at or 0.0)
                if not group.alerts:
                    if due >= self.group_interval:
                        self._notify(group, "resolved", now)
                        expired.append(key)
                elif _fingerprint(group.alerts) != group.last_sent_fingerprint:
                    if due >= self.group_interval:
                        self._notify(group, "update", now)
                elif due >= self.repeat_interval:
                    self._notify(group, "repeat", now)
        for key in expired:
            del self._groups[key]

    def _notify(self, group: _Group, kind: str, now: float) -> None:
        fingerprint = _fingerprint(group.alerts)
        would = sum(1 for a in group.alerts if a["would_inhibit"])
        if kind == "update":
            for alert in group.alerts:
                ident = _identity(alert)
                sent = group.last_sent_since.get(ident)
                if sent is not None and sent != alert["active_since"]:
                    # pending→firing→resolved→firing inside group_interval:
                    # the re-fire rides this ONE update, not a second page
                    self.flaps_coalesced += 1
                    coverage.hit("alerting:flap_coalesced")
        entry = {
            "seq": self._seq,
            "t": now,
            "kind": kind,
            "group": dict(group.key),
            "fingerprint": fingerprint,
            "alerts": [
                {
                    "name": a["name"],
                    "labels": a["labels"],
                    "active_since": a["active_since"],
                }
                for a in group.alerts
            ],
            "would_inhibit": would,
        }
        self._seq += 1
        self.log.append(entry)
        group.paged = True
        group.last_notified_at = now
        group.last_sent_fingerprint = fingerprint
        group.last_sent_since = {
            _identity(a): a["active_since"] for a in group.alerts
        }
        if kind == "page":
            coverage.hit("alerting:page_sent")
            oldest = min(
                (a["active_since"] for a in group.alerts), default=now
            )
            self.page_latencies.append(max(0.0, now - oldest))
        elif kind == "update":
            coverage.hit("alerting:update_sent")
        elif kind == "repeat":
            coverage.hit("alerting:repeat_sent")
        elif kind == "resolved":
            coverage.hit("alerting:resolved_sent")

    # ------------------------------------------------------------------
    # export + accounting

    def pages(self) -> list[dict]:
        return [n for n in self.log if n["kind"] == "page"]

    def stats(self) -> dict:
        counts = {k: 0 for k in NOTIFICATION_KINDS}
        for n in self.log:
            counts[n["kind"]] += 1
        return {
            "notifications": counts,
            "groups_active": len(self._groups),
            "silenced_total": self.silenced_total,
            "inhibited_total": self.inhibited_total,
            "flaps_coalesced": self.flaps_coalesced,
        }

    def export(self) -> dict:
        return {"notifications": self.log, "stats": self.stats()}

    def export_json(self) -> str:
        """Canonical (sorted keys, no whitespace): the paging_bench rung
        requires this string bit-identical across same-seed runs."""
        return _canon(self.export())


def notification_log_violations(
    log: list[dict], repeat_interval: float = 600.0
) -> list[dict]:
    """Paging-contract check over a notification log.  Violations:

    - ``uninhibited_duplicate_page``: a page carrying alerts an inhibition
      rule should have suppressed (``would_inhibit > 0``) — what the
      ``break_inhibition`` canary plants;
    - ``duplicate_page``: two pages for the same group with the same
      fingerprint, no resolve between them, closer than repeat_interval —
      a dedup regression the router must never produce by construction.
    """
    violations: list[dict] = []
    last_page: dict[tuple, dict] = {}
    for entry in log:
        key = tuple(sorted(entry["group"].items()))
        if entry["kind"] == "resolved":
            last_page.pop(key, None)
            continue
        if entry["kind"] != "page":
            continue
        if entry["would_inhibit"] > 0:
            violations.append(
                {
                    "kind": "uninhibited_duplicate_page",
                    "seq": entry["seq"],
                    "t": entry["t"],
                    "group": entry["group"],
                    "would_inhibit": entry["would_inhibit"],
                }
            )
        prior = last_page.get(key)
        if (
            prior is not None
            and prior["fingerprint"] == entry["fingerprint"]
            and entry["t"] - prior["t"] < repeat_interval
        ):
            violations.append(
                {
                    "kind": "duplicate_page",
                    "seq": entry["seq"],
                    "t": entry["t"],
                    "group": entry["group"],
                    "prior_seq": prior["seq"],
                }
            )
        last_page[key] = entry
    return violations


def shipped_inhibit_rules() -> tuple[InhibitRule, ...]:
    """The inhibition topology the sim ships: a critical source explains
    away warning-severity noise for the same alert family/SLO, and a
    region-dead page inhibits the per-tenant unschedulable pages it causes
    (the evacuation scenario's page storm)."""
    return (
        InhibitRule(
            source=(Matcher("severity", "critical"),),
            target=(Matcher("severity", "warning"),),
            equal=("slo",),
        ),
        InhibitRule(
            source=(Matcher("alertname", "RegionDead"),),
            target=(Matcher("alertname", "TenantUnschedulable"),),
            equal=("region",),
        ),
    )


def alerting_families(router: "AlertRouter"):
    """MetricFamily exposition of the router's own state (same pattern as
    coverage_families/profile_families; MetricFamily imported per-call to
    keep this module importable before the metrics package)."""
    from k8s_gpu_hpa_tpu_torch.metrics.schema import MetricFamily
    from k8s_gpu_hpa_tpu_torch.obs.latency import percentile

    stats = router.stats()
    notif = MetricFamily(
        ALERTING_NOTIFICATIONS_TOTAL,
        "counter",
        "notifications appended to the alert-router log, by kind",
    )
    for kind in NOTIFICATION_KINDS:
        notif.add(float(stats["notifications"][kind]), kind=kind)
    groups = MetricFamily(
        ALERTING_GROUPS_ACTIVE,
        "gauge",
        "aggregation groups currently tracked by the router",
    )
    groups.add(float(stats["groups_active"]))
    suppressed = MetricFamily(
        ALERTING_SUPPRESSED_TOTAL,
        "counter",
        "alert instances dropped before grouping, by reason",
    )
    suppressed.add(float(stats["silenced_total"]), reason="silenced")
    suppressed.add(float(stats["inhibited_total"]), reason="inhibited")
    ttp = MetricFamily(
        ALERTING_TIME_TO_PAGE,
        "gauge",
        "seconds from alert firing to its group's first page",
    )
    latencies = router.page_latencies
    for q, label in ((50, "p50"), (95, "p95"), (100, "max")):
        value = percentile(latencies, q) if latencies else 0.0
        ttp.add(float(value or 0.0), quantile=label)
    return [notif, groups, suppressed, ttp]
