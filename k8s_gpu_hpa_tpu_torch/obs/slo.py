"""SLO declarations, error-budget accounting and burn-rate alerts.

Counterpart of ``k8s_gpu_hpa_tpu/obs/slo.py``.  Declare the objective once
and derive the rest from it, as the Google SRE Workbook does:

- :class:`SLODefinition`: a name, an objective (the fraction of events that
  must be good) and where good and total events are counted (a pair of
  cumulative counters, or a 0/1 gauge vector such as ``up``);
- :class:`SLORecorder`: error-budget accounting in the TSDB.  It takes the
  place of a recording rule (``evaluate_into``) and folds each SLO's source
  into two cumulative counters of one shape for every SLO,
  ``slo_good_total{slo=...}`` and ``slo_events_total{slo=...}``;
- :func:`burn_rate_alerts`: the multi-window, multi-burn-rate pair of one
  SLO (Workbook ch. 5): *fast* pages on a burn above 14.4 over 5m AND 1h,
  *slow* tickets on a burn above 6.0 over 30m AND 6h.  The short window
  resets quickly once the burn stops; the long one guards against flaps.

A burn of 1.0 spends the budget exactly at the rate the objective allows.
Both alerts need traffic: no events in the window is no evidence, never a
page.

The shipped SLOs (:func:`shipped_slos`):

- ``signal-propagation``: 95% of workload-change→scale-event propagations
  complete within 30 clock seconds, the good events counted off the
  ``signal_propagation_seconds_bucket{le="30"}`` series;
- ``scrape-success``: 99% of scrape attempts succeed, counted off the
  per-target ``up`` gauge the scraper writes each sweep (1 healthy,
  0 failed), so a scrape blackout burns budget from the next tick.

Each recorder branch is an ``alert_state:slo_*`` coverage probe
(obs/coverage.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from k8s_gpu_hpa_tpu_torch.metrics.rules import AlertRule, AndOn, BurnRate, Cmp, _fmt_window
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.obs import coverage
from k8s_gpu_hpa_tpu_torch.obs.selfmetrics import SIGNAL_PROPAGATION

#: the error-budget counters every SLO records into (label: slo=<name>)
SLO_GOOD_TOTAL = "slo_good_total"
SLO_EVENTS_TOTAL = "slo_events_total"

#: the Workbook's thresholds and (short, long) window pairs, seconds
FAST_BURN = 14.4
FAST_WINDOWS = (300.0, 3600.0)  # 5m / 1h -> page
SLOW_BURN = 6.0
SLOW_WINDOWS = (1800.0, 21600.0)  # 30m / 6h -> ticket


@dataclass(frozen=True)
class SLODefinition:
    """One declared objective and the series its events are counted from.

    ``source`` picks the counting mode:

    - ``"counter"``: ``good_series``/``total_series`` are cumulative
      counters already (a histogram's ``_bucket``/``_count``); the recorder
      mirrors their current sums;
    - ``"gauge"``: ``good_series`` is a 0/1 gauge vector (``up``); each
      tick adds the vector's sum to good and its sample count to total
      (``total_series`` unused).
    """

    name: str
    objective: float  # e.g. 0.99: the fraction of events that must be good
    description: str
    source: str  # "counter" | "gauge"
    good_series: str
    total_series: str = ""
    good_matchers: dict[str, str] = field(default_factory=dict)
    total_matchers: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.source not in ("counter", "gauge"):
            raise ValueError(f"unknown SLO source mode {self.source!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1) exclusive")
        if self.source == "counter" and not self.total_series:
            raise ValueError("counter-mode SLO requires total_series")

    @property
    def labels(self) -> tuple[tuple[str, str], ...]:
        return (("slo", self.name),)


class SLORecorder:
    """One SLO's events folded into the two budget counters each tick.

    It has a recording rule's ``evaluate_into``, so the ``RuleEvaluator``
    drives it in group order (recorders before alerts: the burn expressions
    read what this tick wrote).  Its counters seed themselves from the TSDB
    on the first tick, so a recorder built over a recovered TSDB continues
    them instead of resetting them."""

    def __init__(self, slo: SLODefinition):
        self.slo = slo
        #: a recording rule's output name, for listings
        self.record = f"{SLO_GOOD_TOTAL}{{slo={slo.name}}}"
        self._good = 0.0
        self._total = 0.0
        self._seeded = False

    def _sum(
        self, db: TimeSeriesDB, name: str, matchers: dict[str, str], at: float
    ) -> tuple[float, int] | None:
        vec = db.instant_vector(name, matchers, at)
        if not vec:
            return None
        return sum(s.value for s in vec), len(vec)

    def evaluate_into(
        self,
        db: TimeSeriesDB,
        at: float | None = None,
        tracer=None,
        selfmetrics=None,
    ) -> int:
        ts = db.clock.now() if at is None else at
        if not self._seeded:
            self._good = db.latest(SLO_GOOD_TOTAL, dict(self.slo.labels)) or 0.0
            self._total = db.latest(SLO_EVENTS_TOTAL, dict(self.slo.labels)) or 0.0
            self._seeded = True
            coverage.hit("alert_state:slo_seeded")
        if self.slo.source == "gauge":
            read = self._sum(db, self.slo.good_series, self.slo.good_matchers, ts)
            if read is None:
                coverage.hit("alert_state:slo_gauge_no_evidence")
                return 0  # source absent: no evidence this tick, no write
            value_sum, count = read
            self._good += value_sum
            self._total += count
        else:
            good = self._sum(db, self.slo.good_series, self.slo.good_matchers, ts)
            total = self._sum(db, self.slo.total_series, self.slo.total_matchers, ts)
            if total is None:
                coverage.hit("alert_state:slo_counter_missing")
                return 0  # the histogram not scraped yet, or expired
            # mirror the source counters but never regress: a source briefly
            # out of the lookback window is not a reset
            self._good = max(self._good, (good or (0.0, 0))[0])
            self._total = max(self._total, total[0])
        coverage.hit("alert_state:slo_budget_recorded")
        db.append(SLO_GOOD_TOTAL, self.slo.labels, self._good, ts)
        db.append(SLO_EVENTS_TOTAL, self.slo.labels, self._total, ts)
        return 2


def _camel(name: str) -> str:
    return "".join(part.capitalize() for part in name.replace("_", "-").split("-"))


def _burn_alert(
    slo: SLODefinition,
    windows: tuple[float, float],
    threshold: float,
    severity: str,
    speed: str,
) -> AlertRule:
    """One multi-window burn alert: it fires only while both windows burn
    above the threshold."""
    short, long = windows

    def burn(window: float) -> BurnRate:
        return BurnRate(
            good_name=SLO_GOOD_TOTAL,
            total_name=SLO_EVENTS_TOTAL,
            objective=slo.objective,
            window=window,
            good_matchers=dict(slo.labels),
            total_matchers=dict(slo.labels),
        )

    return AlertRule(
        alert=f"SLO{_camel(slo.name)}{speed.capitalize()}Burn",
        expr=AndOn(
            Cmp(burn(short), ">", threshold),
            Cmp(burn(long), ">", threshold),
        ),
        labels={
            "severity": severity,
            "slo": slo.name,
            "burn": speed,
            "window": f"{_fmt_window(short)}/{_fmt_window(long)}",
        },
        annotations={
            "summary": f"SLO {slo.name} ({slo.description}) is burning "
            f"error budget over {threshold:g}x the sustainable rate on "
            f"both the {_fmt_window(short)} and {_fmt_window(long)} "
            f"windows — at this burn the {slo.objective:.0%} objective "
            "fails well inside the budget period"
        },
    )


def burn_rate_alerts(slo: SLODefinition) -> list[AlertRule]:
    """The Workbook pair of one SLO: fast (page) and slow (ticket)."""
    return [
        _burn_alert(slo, FAST_WINDOWS, FAST_BURN, "critical", "fast"),
        _burn_alert(slo, SLOW_WINDOWS, SLOW_BURN, "warning", "slow"),
    ]


#: the propagation budget a good event must beat, clock seconds; it must be
#: a bucket boundary of SIGNAL_PROPAGATION_BUCKETS (the good events are
#: counted off that bucket's series)
PROPAGATION_BUDGET_SECONDS = 30.0


def shipped_slos() -> list[SLODefinition]:
    """The declared SLOs, the one list the pipeline's wiring
    (control/loop.py) reads."""
    return [
        SLODefinition(
            name="signal-propagation",
            objective=0.95,
            description="95% of workload-change->scale-event propagations "
            f"complete within {PROPAGATION_BUDGET_SECONDS:g}s",
            source="counter",
            good_series=SIGNAL_PROPAGATION + "_bucket",
            total_series=SIGNAL_PROPAGATION + "_count",
            good_matchers={"le": f"{PROPAGATION_BUDGET_SECONDS:g}"},
        ),
        SLODefinition(
            name="scrape-success",
            objective=0.99,
            description="99% of scrape attempts succeed",
            source="gauge",
            good_series="up",
        ),
    ]


def shipped_slo_recorders() -> list[SLORecorder]:
    return [SLORecorder(slo) for slo in shipped_slos()]


def shipped_slo_alerts() -> list[AlertRule]:
    return [alert for slo in shipped_slos() for alert in burn_rate_alerts(slo)]
