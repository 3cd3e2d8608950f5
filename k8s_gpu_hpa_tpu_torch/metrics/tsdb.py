"""Mini time-series database + scrape manager (the L3 stand-in).

Counterpart of ``k8s_gpu_hpa_tpu/metrics/tsdb.py``, cut to what the headline
loop reads.  In production L3 is kube-prometheus-stack; for the loop this
module reproduces the two Prometheus behaviors the pipeline depends on:

- **scrape**: pull exposition from targets every interval (the reference
  scrapes at 1 s, kube-prometheus-stack-values.yaml:5) and attach target
  metadata labels — the ``node`` relabel of
  kube-prometheus-stack-values.yaml:13-16.  Targets serve text exposition or
  pre-parsed ``MetricFamily`` lists.
- **instant query with staleness**: the newest point per series within a
  lookback window (Prometheus default 5 min), which is what both the
  recording-rule engine and the custom-metrics adapter consume.  A NaN point
  is a staleness marker and ends its series at once.

For metric lineage every point may carry an ``origin``, the id of the span
that wrote it (obs/trace.py): the scraper's ``scrape`` span or a rule's
``rule_eval`` span.  A read bracketed by ``begin_capture``/``end_capture``
learns the origin of every point it returned, which is how rule evaluations
and adapter queries link to their inputs.

Series are plain per-series point lists, so every read is served from raw
points.  Retention is the JAX package's: points leave in whole groups of
``chunk_size`` (its sealed Gorilla chunks), counted from the series' first
point, once a group's last point is older than ``retention``; the open
group (JAX's head) never leaves.  So a read older than the lookback sees
what JAX's sees.  A series ended by a staleness marker is dropped by
``gc`` once the marker is older than the lookback, every ``GC_EVERY``
appends, as in JAX.

Durability: constructed with a ``WriteAheadLog`` (metrics/wal.py), the DB
logs every accepted append (markers too) before the call returns and cuts
a snapshot every ``snapshot_every`` logged records; ``TimeSeriesDB.recover``
rebuilds the store (points with their origins, version counters, the
pending-staleness map) from the snapshot and a replay of the tail.  The
snapshot is JAX's format 1, per-point ``[ts, value|null, origin]``
triples, which JAX's ``recover`` reads; JAX's formats 2 and 3 carry
Gorilla chunks and rollups, which the port has not (they come with the
metrics plane at scale).  The JAX package's Gorilla encoding, downsampled
tiers, exemplars and profiling stages are not ported.

Targets may report how long serving took (``TimedExposition``,
``StructuredExposition``): a fetch past its target's ``deadline`` counts as
a failed scrape (``ScrapeTimeout``), which is how the chaos plane's
``slow_scrape`` bites on virtual time.
"""

from __future__ import annotations

import math
import random
import time
import zlib
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Callable

from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.metrics.schema import MetricFamily, Sample
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock

LabelSet = tuple[tuple[str, str], ...]


class _Series:
    """One labeled series: parallel sorted timestamp, value and origin
    lists (an origin is the id of the span that wrote the point, or None)."""

    __slots__ = ("labels", "ts", "values", "origins")

    def __init__(self, labels: LabelSet):
        self.labels = labels
        self.ts: list[float] = []
        self.values: list[float] = []
        self.origins: list[int | None] = []

    def latest_point_at(
        self, at: float, lookback: float
    ) -> tuple[float, float, int | None] | None:
        """The newest (ts, value, origin) at or before ``at``, unless it is a
        staleness marker or older than the lookback."""
        idx = bisect_right(self.ts, at) - 1
        if idx < 0:
            return None
        value = self.values[idx]
        if value != value or at - self.ts[idx] > lookback:  # NaN: stale marker
            return None
        return self.ts[idx], value, self.origins[idx]


#: the snapshot payload format ``TimeSeriesDB.snapshot`` writes: JAX's
#: format 1 (per-point triples), the one its ``recover`` reads without
#: Gorilla chunks
SNAPSHOT_FORMAT = 1


class TimeSeriesDB:
    """Store of named series with bounded retention, queried as instant
    vectors."""

    #: the GC's cadence: every this many appends, drop the series whose
    #: staleness marker is older than the lookback
    GC_EVERY = 4096

    def __init__(
        self,
        clock: Clock | None = None,
        lookback: float = 300.0,
        retention: float | None = None,
        wal=None,
        snapshot_every: int = 8192,
        chunk_size: int = 64,
    ):
        self.clock = clock or SystemClock()
        self.lookback = lookback
        #: per-series retained window, never below the lookback (a shorter
        #: one would drop points an ``at >= newest`` read still sees)
        self.retention = lookback if retention is None else max(retention, lookback)
        #: points leave in whole groups of this many, as JAX's sealed chunks
        self.chunk_size = chunk_size
        self._data: dict[str, dict[LabelSet, _Series]] = {}
        #: per-name monotonic write counters (staleness markers included)
        self._versions: dict[str, int] = {}
        #: (name, labels) -> marker ts of each series a staleness marker
        #: ended; ``gc`` drops it once the marker is older than the lookback
        self._stale_pending: dict[tuple[str, LabelSet], float] = {}
        self._appends_since_gc = 0
        #: the active read capture (see begin_capture), else None
        self._capture: list[tuple[str, LabelSet, float, float, int | None, str]] | None = None
        #: metrics.wal.WriteAheadLog, or None for a DB in memory only; each
        #: accepted append is logged, and a snapshot cut every
        #: ``snapshot_every`` logged records bounds a restart's replay
        self.wal = wal
        self.snapshot_every = snapshot_every
        self._wal_records_since_snapshot = 0
        #: True while ``recover`` replays the tail: nothing is logged again
        self._replaying = False
        #: the stats of the recovery that built this DB (``recover``), else
        #: None
        self.last_recovery: dict | None = None

    def append(
        self,
        name: str,
        labels: LabelSet,
        value: float,
        ts: float | None = None,
        origin: int | None = None,
    ) -> None:
        ts = self.clock.now() if ts is None else ts
        by_name = self._data.setdefault(name, {})
        series = by_name.get(labels)
        if series is None:
            series = by_name[labels] = _Series(labels)
        elif ts < series.ts[-1]:
            # out-of-order appends would break the sorted-points invariant
            # every read relies on; equal timestamps are allowed
            raise ValueError(
                f"out-of-order append to {name}{dict(labels)}: "
                f"ts {ts} < newest {series.ts[-1]}"
            )
        series.ts.append(ts)
        series.values.append(value)
        series.origins.append(origin)
        # The lists start on a group boundary, so each full group of
        # chunk_size at the front is a sealed chunk of JAX's; the rest is
        # its head.  A sealed group leaves once its last point is older
        # than the retention, and the head never does.
        size = self.chunk_size
        cutoff = ts - self.retention
        while len(series.ts) >= size and series.ts[size - 1] < cutoff:
            del series.ts[:size], series.values[:size], series.origins[:size]
        self._versions[name] = self._versions.get(name, 0) + 1
        if value != value:  # a marker: the ended series waits for the GC
            self._stale_pending[(name, labels)] = ts
        elif self._stale_pending:
            # a live point brings a marker-ended series back
            self._stale_pending.pop((name, labels), None)
        self._appends_since_gc += 1
        if self._appends_since_gc >= self.GC_EVERY:
            self.gc()
        if self.wal is not None and not self._replaying:
            self.wal.log_append(name, labels, value, ts, origin)
            self._wal_records_since_snapshot += 1
            if self._wal_records_since_snapshot >= self.snapshot_every:
                self.snapshot()

    def gc(self) -> int:
        """Drop the series whose staleness marker is older than the
        lookback: no read at or after ``marker + lookback`` can tell the
        dropped series from its marker.  Runs every ``GC_EVERY`` appends;
        returns the number of series dropped."""
        self._appends_since_gc = 0
        if not self._stale_pending:
            return 0
        now = self.clock.now()
        dropped = 0
        for key, marker_ts in list(self._stale_pending.items()):
            if now - marker_ts <= self.lookback:
                continue
            del self._stale_pending[key]
            name, labels = key
            by_name = self._data.get(name)
            if by_name is None or by_name.pop(labels, None) is None:
                continue
            if not by_name:
                del self._data[name]
            dropped += 1
        return dropped

    # ---- durability (snapshot and recovery) --------------------------------

    def snapshot(self) -> None:
        """Cut a snapshot of the whole state into the WAL and drop the
        segments it subsumes: the retained points with their origins (so
        lineage survives a restart), the version counters (so incremental
        rule evaluation compares as before) and the pending-staleness map
        (so the GC resumes where it was)."""
        if self.wal is None:
            return
        self.wal.write_snapshot(self.snapshot_payload())
        self._wal_records_since_snapshot = 0

    def snapshot_payload(self) -> dict:
        """The format-1 snapshot payload: each series' points as
        ``[ts, value or None for a marker, origin]``."""
        return {
            "format": SNAPSHOT_FORMAT,
            "at": self.clock.now(),
            "lookback": self.lookback,
            "retention": self.retention,
            "series": [
                {
                    "name": name,
                    "labels": list(series.labels),
                    "points": [
                        [ts, None if value != value else value, origin]
                        for ts, value, origin in zip(series.ts, series.values, series.origins)
                    ],
                }
                for name, by_name in self._data.items()
                for series in by_name.values()
            ],
            "versions": dict(self._versions),
            "stale_pending": [
                [name, list(labels), ts] for (name, labels), ts in self._stale_pending.items()
            ],
            "exemplars": [],
        }

    @classmethod
    def recover(
        cls,
        wal,
        clock: Clock | None = None,
        lookback: float = 300.0,
        retention: float | None = None,
        snapshot_every: int = 8192,
        chunk_size: int = 64,
    ) -> "TimeSeriesDB":
        """Rebuild a DB from its WAL: restore the snapshot, then replay the
        tail in append order through ``append`` itself, which rebuilds the
        version counters, retention and staleness as it built them the
        first time.  A tail record at the newest timestamp of its series
        appends (a snapshot cut inside a tick); one that lands out of order
        (after a ``wal_truncate`` tear) is dropped, never fatal.  A payload
        of format 2 or 3 (JAX's Gorilla chunks and rollups) raises.

        The DB takes over ``wal`` and stamps ``last_recovery`` with the
        replay's stats; ``replay_gap_seconds`` is the clock's time less the
        newest timestamp recovered."""
        payload, tail = wal.read()
        fmt = 1 if payload is None else payload.get("format", 1)
        if fmt != 1:
            raise ValueError(
                f"snapshot format {fmt} holds Gorilla chunks, which the port reads "
                "from the metrics-plane slice (queue 1, slice 4) on; it reads format 1"
            )
        db = cls(
            clock,
            lookback=(payload or {}).get("lookback", lookback),
            retention=(payload or {}).get("retention", retention),
            snapshot_every=snapshot_every,
            chunk_size=chunk_size,
        )
        newest_ts = -math.inf
        recovered_points = 0
        if payload is not None:
            for entry in payload["series"]:
                if not entry["points"]:
                    continue
                labels = tuple((k, v) for k, v in entry["labels"])
                series = _Series(labels)
                for ts, value, origin in entry["points"]:
                    series.ts.append(ts)
                    series.values.append(float("nan") if value is None else value)
                    series.origins.append(origin)
                db._data.setdefault(entry["name"], {})[labels] = series
                recovered_points += len(series.ts)
                newest_ts = max(newest_ts, series.ts[-1])
            db._versions.update(payload.get("versions", {}))
            for name, labels, ts in payload.get("stale_pending", []):
                db._stale_pending[(name, tuple((k, v) for k, v in labels))] = ts
        replayed = dropped = 0
        db._replaying = True
        try:
            for rec in tail:
                labels = tuple((k, v) for k, v in rec["labels"])
                value = float("nan") if rec["op"] == "stale" else rec["value"]
                try:
                    db.append(rec["name"], labels, value, rec["ts"], rec.get("origin"))
                except ValueError:
                    dropped += 1
                    continue
                replayed += 1
                recovered_points += 1
                newest_ts = max(newest_ts, rec["ts"])
        finally:
            db._replaying = False
        db.wal = wal
        now = db.clock.now()
        db.last_recovery = {
            "snapshot_restored": payload is not None,
            "recovered_series": db.series_count(),
            "recovered_points": recovered_points,
            "replayed_records": replayed,
            "dropped_records": dropped,
            "newest_ts": None if newest_ts == -math.inf else newest_ts,
            "replay_gap_seconds": (
                max(0.0, now - newest_ts) if newest_ts != -math.inf else None
            ),
            "rollup_series_restored": 0,
            "rollup_series_rebuilt": 0,
            "rollup_enabled": False,
        }
        return db

    def mark_stale(
        self,
        name: str,
        labels: LabelSet,
        ts: float | None = None,
        origin: int | None = None,
    ) -> None:
        """Write a staleness marker ending the series now (Prometheus writes
        these when a target fails to scrape or a rule stops producing)."""
        self.append(name, labels, float("nan"), ts, origin=origin)

    # ---- read capture (metric lineage) ------------------------------------
    #
    # Rule evaluations and adapter queries learn their exact inputs by
    # bracketing their reads: every point an instant query returns while a
    # capture is active is recorded with its origin.  Lineage stays out of
    # the expressions and the adapter's queries: every read goes through
    # ``instant_vector``.

    def begin_capture(self) -> None:
        self._capture = []

    def end_capture(self) -> list[tuple[str, LabelSet, float, float, int | None, str]]:
        """Stop capturing; returns (name, labels, ts, value, origin, tier)
        for each point read since ``begin_capture``.  ``tier`` names the
        storage the read was served from, always ``"raw"`` here (the JAX
        package's downsampled tiers are not ported)."""
        captured, self._capture = self._capture or [], None
        return captured

    def instant_vector(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        at: float | None = None,
    ) -> list[Sample]:
        """All series of ``name`` matching label equalities, at their latest value."""
        at = self.clock.now() if at is None else at
        capture = self._capture
        out: list[Sample] = []
        for labels, series in self._data.get(name, {}).items():
            if matchers and any(
                (k, v) not in labels for k, v in matchers.items()
            ):
                continue
            point = series.latest_point_at(at, self.lookback)
            if point is None:
                continue
            if capture is not None:
                capture.append((name, labels, point[0], point[1], point[2], "raw"))
            out.append(Sample(point[1], labels))
        return out

    def latest(self, name: str, matchers: dict[str, str] | None = None) -> float | None:
        """Scalar convenience: value of the single matching series, else None."""
        vec = self.instant_vector(name, matchers)
        if not vec:
            return None
        if len(vec) > 1:
            raise ValueError(f"query for {name} matched {len(vec)} series, expected 1")
        return vec[0].value

    def series_names(self) -> list[str]:
        return sorted(self._data)

    def series_count(self) -> int:
        return sum(len(by_name) for by_name in self._data.values())

    def total_points(self) -> int:
        """Points retained across all series."""
        return sum(len(s.ts) for by_name in self._data.values() for s in by_name.values())

    def version(self, name: str) -> int:
        """Monotonic write counter for ``name``: bumps on every append to any
        series of the name (staleness markers included)."""
        return self._versions.get(name, 0)


class ScrapeTimeout(Exception):
    """A fetch whose (simulated) duration exceeded the target's deadline."""


@dataclass
class TimedExposition:
    """Exposition text plus how long serving it took.  A fetch may return
    this instead of a plain string, so that virtual-time runs can model a
    slow endpoint; the scraper holds ``duration`` to the target's deadline
    (in production the HTTP client's timeout does)."""

    text: str
    duration: float = 0.0


@dataclass
class StructuredExposition:
    """Pre-parsed families with a modeled duration: the structured scrape
    path under the same deadline as ``TimedExposition``.  Sample label
    tuples must be sorted (``Sample.make`` and ``MetricFamily.add`` sort
    them)."""

    families: list[MetricFamily]
    duration: float = 0.0


@dataclass
class ScrapeTarget:
    """One endpoint: ``fetch`` returns exposition text (HTTP GET in
    production), pre-parsed families, or either with a modeled duration
    (``TimedExposition``, ``StructuredExposition``).

    ``attached_labels`` are merged onto every scraped sample, overriding any
    collision — the reference's relabel_config that stamps the Kubernetes
    node name onto each sample (kube-prometheus-stack-values.yaml:13-16).
    """

    fetch: Callable[
        [], "str | TimedExposition | list[MetricFamily] | StructuredExposition"
    ]
    attached_labels: dict[str, str] = field(default_factory=dict)
    name: str = ""
    healthy: bool = True
    #: series produced by the last successful scrape, for staleness marking
    last_series: set[tuple[str, LabelSet]] = field(default_factory=set)
    #: the scrape deadline (Prometheus's ``scrape_timeout``): a fetch that
    #: reports a longer duration counts as a failed scrape
    deadline: float = 10.0
    #: failure streak driving the exponential backoff
    consecutive_failures: int = 0
    #: do not re-attempt before this timestamp (backoff gate)
    next_attempt_at: float = -math.inf
    #: fetch attempts made
    attempts: int = 0
    #: optional provider of the span id of the upstream data a successful
    #: fetch served (the node exporter's last collection sweep); the scrape
    #: span links to it, rooting metric lineage at the raw device samples
    trace_origin: "Callable[[], int | None] | None" = None


class Scraper:
    """Pulls all targets into the TSDB; drive via ``scrape_once`` on a schedule.

    A failing target, or one whose fetch ran past its deadline, gets
    staleness markers and an ``up{target=...} 0`` sample — the degradation
    is observable, never a frozen value — and consecutive failures back it
    off exponentially (base doubling up to ``backoff_cap``) with seeded
    jitter.  The caller's schedule is the scrape interval.

    With a tracer each attempt emits a ``scrape`` span, opened before the
    fetch, whose id is the origin of every point it writes (staleness
    markers too); with self-metrics each attempt reports its
    duration, the modeled one where the target reports it, else the wall
    clock's.
    """

    def __init__(
        self,
        db: TimeSeriesDB,
        interval: float = 1.0,
        backoff_base: float = 1.0,
        backoff_cap: float = 30.0,
        backoff_jitter: float = 0.1,
        tracer=None,
        selfmetrics=None,
    ):
        self.db = db
        #: the caller's scrape period, which spreads the sweep after a
        #: recovery (``stagger_after_recovery``)
        self.interval = interval
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_jitter = backoff_jitter
        #: obs.Tracer, or None
        self.tracer = tracer
        #: obs.PipelineSelfMetrics, or None
        self.selfmetrics = selfmetrics
        #: seeded so virtual-time runs are reproducible event-for-event
        self._rng = random.Random(0)
        self.targets: list[ScrapeTarget] = []

    def add_target(
        self, fetch: Callable[[], str], name: str = "", **attached_labels: str
    ) -> ScrapeTarget:
        target = ScrapeTarget(fetch=fetch, attached_labels=attached_labels, name=name)
        self.targets.append(target)
        return target

    def remove_target(self, target: ScrapeTarget) -> None:
        self.targets.remove(target)

    def _up_labels(self, target: ScrapeTarget) -> LabelSet:
        labels = dict(target.attached_labels)
        labels["target"] = target.name or "?"
        return tuple(sorted(labels.items()))

    def _record_up(self, target: ScrapeTarget, value: float, ts: float) -> None:
        self.db.append("up", self._up_labels(target), value, ts)

    def _backoff(self, target: ScrapeTarget, now: float) -> None:
        exponent = min(target.consecutive_failures - 1, 10)
        delay = min(self.backoff_cap, self.backoff_base * 2.0**exponent)
        target.next_attempt_at = now + delay * (
            1.0 + self.backoff_jitter * self._rng.random()
        )

    def stagger_after_recovery(self, spread: float | None = None) -> None:
        """Spread the first sweep after a TSDB restart: every target's gap
        ran out while the DB was down, so without this they all land on one
        tick.  Each target gets a slot inside ``spread`` (4 intervals by
        default) keyed by a CRC of its ``up`` label set, which is the same
        in every process (``hash()`` is salted) and the JAX package's.  A
        target is never moved earlier than a backoff in force."""
        if spread is None:
            spread = 4.0 * self.interval
        now = self.db.clock.now()
        for target in self.targets:
            frac = (zlib.crc32(repr(self._up_labels(target)).encode()) % 1024) / 1024.0
            target.next_attempt_at = max(target.next_attempt_at, now + spread * frac)

    def scrape_once(self) -> int:
        """Scrape every due target; returns the number of samples ingested.

        A failing target (a fetch that raised, or one whose reported
        duration ran past its deadline) gets staleness markers on its last
        series (a down target's series go stale at the next scrape, they
        don't linger for the lookback window), an ``up`` sample of 0, and a
        backoff."""
        count = 0
        ts = self.db.clock.now()
        tracer = self.tracer
        for target in self.targets:
            if ts < target.next_attempt_at:
                continue  # backing off after consecutive failures
            target.attempts += 1
            span = tracer.open("scrape", {"target": target.name or "?"}) if tracer else None
            origin = None if span is None else span.span_id
            wall_start = time.perf_counter()
            duration: float | None = None
            try:
                fetched = target.fetch()
                if isinstance(fetched, TimedExposition):
                    duration = fetched.duration
                    fetched = fetched.text
                elif isinstance(fetched, StructuredExposition):
                    duration = fetched.duration
                    fetched = fetched.families
                if duration is not None and duration > target.deadline:
                    raise ScrapeTimeout(
                        f"{target.name or '?'}: scrape took {duration:.1f}s > "
                        f"deadline {target.deadline:.1f}s"
                    )
                families = parse_text(fetched) if isinstance(fetched, str) else fetched
            except Exception as exc:  # noqa: BLE001 — any fetch failure is a down target
                if target.healthy:
                    for name, labels in target.last_series:
                        self.db.mark_stale(name, labels, ts, origin=origin)
                target.healthy = False
                target.last_series = set()
                target.consecutive_failures += 1
                self._backoff(target, ts)
                self._record_up(target, 0.0, ts)
                self._observe_scrape(target, wall_start, duration, origin)
                if span is not None:
                    tracer.close(span, ok=False, error=str(exc))
                continue
            target.healthy = True
            target.consecutive_failures = 0
            target.next_attempt_at = -math.inf
            produced: set[tuple[str, LabelSet]] = set()
            for fam in families:
                for sample in fam.samples:
                    merged = dict(sample.labels)
                    merged.update(target.attached_labels)
                    key = tuple(sorted(merged.items()))
                    series_name = fam.name + sample.suffix
                    self.db.append(series_name, key, sample.value, ts, origin=origin)
                    produced.add((series_name, key))
                    count += 1
            # series that vanished from the exposition also go stale
            for name, labels in target.last_series - produced:
                self.db.mark_stale(name, labels, ts, origin=origin)
            target.last_series = produced
            self._record_up(target, 1.0, ts)
            self._observe_scrape(target, wall_start, duration, origin)
            if span is not None:
                links: tuple[int, ...] = ()
                if target.trace_origin is not None:
                    upstream = target.trace_origin()
                    if upstream is not None:
                        links = (upstream,)
                tracer.close(span, links, ok=True, samples=len(produced))
        return count

    def _observe_scrape(
        self,
        target: ScrapeTarget,
        wall_start: float,
        duration: float | None,
        span_id: int | None,
    ) -> None:
        """Report the attempt's duration: the modeled one where the target
        reported it, else the wall clock's; ``span_id`` (its scrape span)
        becomes the histogram bucket's exemplar."""
        if self.selfmetrics is not None:
            if duration is None:
                duration = time.perf_counter() - wall_start
            self.selfmetrics.observe_scrape(target.name or "?", duration, span_id)
